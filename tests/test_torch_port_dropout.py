"""The flash kernels' attention-dropout modes, plain PyTorch path on the CPU,
against the JAX package: explicit-mask dropout through the Pallas kernels in
interpret mode and through both dense oracles, the Philox generator against
Random123's known answers, and the seeded mode against the mask mode fed the
Philox pattern. Inputs are made with numpy from a seed and fed to both.

Tolerances are those of tests/test_flash_attention.py: fp32 forward 2e-5,
gradients 5e-4, bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

RATE = 0.1


def _np(shape, seed):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _keep(shape, seed, rate=RATE):
    return np.random.RandomState(seed).uniform(size=shape) >= rate


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t2n(x):
    return x.detach().float().numpy()


CASES = [
    # (shape, kwargs): one tile-aligned case, one ragged (S and D off the
    # tile grid, key padding).
    ((1, 2, 128, 64), {}),
    ((1, 2, 100, 40), {"kv_len": 80}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,kw", CASES)
def test_mask_dropout_matches_jax_forward_and_gradients(shape, kw, causal,
                                                       dtype):
    tol = (2e-5, 5e-4) if dtype == "float32" else (3e-2, 3e-2)
    arrays = [_np(shape, s) for s in range(4)]
    keep = _keep(shape[:3] + (shape[2],), 9)
    jq, jk, jv, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    tq, tk, tv, tg = (torch.tensor(a).to(getattr(torch, dtype))
                      for a in arrays)
    kw = dict(kw, causal=causal, dropout_rate=RATE)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, dropout_mask=jnp.asarray(keep), **kw)
        return jnp.sum((o * jg).astype(jnp.float32)), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o = tfa.flash_attention(*leaves, dropout_mask=torch.tensor(keep), **kw)
    (o * tg).float().sum().backward()
    assert o.dtype == tq.dtype
    _close(_t2n(o), jo, tol[0])
    for leaf, want in zip(leaves, jgrads):
        _close(_t2n(leaf.grad), want, tol[1])


@pytest.mark.parametrize("kw", [{}, {"causal": True},
                                {"causal": True, "q_offset": 16,
                                 "k_offset": 40, "kv_len": 90}])
def test_reference_attention_dropout_matches_jax(kw):
    shape = (2, 2, 96, 32)
    arrays = [_np(shape, s) for s in range(3)]
    keep = _keep(shape[:3] + (shape[2],), 5)
    want = jfa.reference_attention(*(jnp.asarray(a) for a in arrays),
                                   dropout_mask=jnp.asarray(keep),
                                   dropout_rate=RATE, **kw)
    got = tfa.reference_attention(*(torch.tensor(a) for a in arrays),
                                  dropout_mask=torch.tensor(keep),
                                  dropout_rate=RATE, **kw)
    _close(_t2n(got), want, 2e-5)
    # and the flash path agrees with its own oracle on the same mask
    flash = tfa.flash_attention(*(torch.tensor(a) for a in arrays),
                                dropout_mask=torch.tensor(keep),
                                dropout_rate=RATE, **kw)
    _close(_t2n(flash), _t2n(got), 2e-5)


# Random123's kat_vectors for philox4x32_10: counter, key -> output.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    words = tfa.philox4x32_10(
        [torch.tensor(c, dtype=torch.int64) for c in counter],
        [torch.tensor(k, dtype=torch.int64) for k in key])
    assert tuple(int(w) for w in words) == want


def test_philox_keep_rate_and_independence():
    bh, s = 128, 512
    mask = tfa.philox_keep_mask(1234, bh, s, s, RATE, "cpu")
    n = mask.numel()
    sigma = np.sqrt(n * RATE * (1 - RATE))
    assert abs(int(mask.sum()) - n * (1 - RATE)) < 5 * sigma
    # every head draws its own pattern, and another seed another one
    flat = mask.reshape(bh, -1)
    assert not bool((flat[1:] == flat[:-1]).all(-1).any())
    other = tfa.philox_keep_mask(1235, 4, s, s, RATE, "cpu")
    assert not torch.equal(other, mask[:4])
    # four neighbouring keys share one generator call, not one word
    assert not bool((mask[..., 0::4] == mask[..., 1::4]).all())


def test_tiny_rate_keeps_everything_without_overflow():
    assert tfa.keep_threshold(1e-17) == 2 ** 32 - 1
    # The JAX package's expression gives 2**32 here, which does not fit its
    # uint32 threshold (a reference defect, ROADMAP queue C).
    assert int((1.0 - 1e-17) * 4294967296.0) == 2 ** 32
    assert bool(tfa.philox_keep_mask(3, 4, 64, 64, 1e-17, "cpu").all())


@pytest.mark.parametrize("causal", [False, True])
def test_seeded_plain_equals_mask_plain_fed_the_philox_pattern(causal):
    shape = (1, 2, 100, 40)
    kw = dict(causal=causal, kv_len=90, dropout_rate=RATE)
    arrays = [torch.tensor(_np(shape, s)) for s in range(4)]
    s_pad = 128
    keep = tfa.philox_keep_mask(77, 2, s_pad, s_pad, RATE, "cpu")[
        :, :100, :100].reshape(1, 2, 100, 100)
    outs = {}
    for name, drop in (("seed", {"dropout_seed": 77}),
                       ("mask", {"dropout_mask": keep})):
        leaves = [x.clone().requires_grad_() for x in arrays[:3]]
        o = tfa.flash_attention(*leaves, **drop, **kw)
        (o * arrays[3]).sum().backward()
        outs[name] = [o] + [x.grad for x in leaves]
    for a, b in zip(outs["seed"], outs["mask"]):
        assert torch.equal(a, b)
    ref = tfa.reference_attention(*arrays[:3], dropout_mask=keep, **kw)
    _close(_t2n(outs["seed"][0]), _t2n(ref), 2e-5)
    other = tfa.flash_attention(*arrays[:3], dropout_seed=78, **kw)
    assert not torch.equal(other, outs["seed"][0])


def test_dropout_argument_rules_follow_the_jax_package():
    q = torch.tensor(_np((1, 1, 64, 32), 0))
    keep = torch.ones(1, 1, 64, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="not both"):
        tfa.flash_attention(q, q, q, dropout_mask=keep, dropout_seed=1,
                            dropout_rate=RATE)
    with pytest.raises(NotImplementedError, match="with_lse"):
        tfa.flash_attention(q, q, q, dropout_seed=1, dropout_rate=RATE,
                            with_lse=True)
    # rate 0 is the no-dropout path, whatever the mask says
    plain = tfa.flash_attention(q, q, q)
    assert torch.equal(tfa.flash_attention(
        q, q, q, dropout_mask=torch.zeros_like(keep), dropout_rate=0.0),
        plain)
    # an all-keep mask at a positive rate only rescales P.V by 1/(1-rate)
    scaled = tfa.flash_attention(q, q, q, dropout_mask=keep,
                                 dropout_rate=RATE)
    _close(_t2n(scaled), _t2n(plain) / (1 - RATE), 2e-5)

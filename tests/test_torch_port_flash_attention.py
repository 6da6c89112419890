"""Port flash attention (plain PyTorch path on the CPU) against the JAX
package's Pallas kernels (interpret mode on the CPU) and both dense
references. Inputs are made with numpy from a seed and fed to both.

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


def _np(shape, seed):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _both(shape, seeds, jdtype=jnp.float32, tdtype=torch.float32):
    arrays = [_np(shape, s) for s in seeds]
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.tensor(a).to(tdtype) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t2n(x):
    return x.detach().float().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 128, 32), (2, 2, 256, 64)])
def test_forward_matches_jax(causal, shape):
    (jq, jk, jv), (tq, tk, tv) = _both(shape, range(3))
    want = jfa.flash_attention(jq, jk, jv, causal=causal)
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    _close(_t2n(got), want, 2e-5)
    _close(_t2n(got), _t2n(tfa.reference_attention(tq, tk, tv,
                                                    causal=causal)), 2e-5)


def test_forward_unaligned_seq_and_dim():
    (jq, jk, jv), (tq, tk, tv) = _both((1, 2, 100, 48), range(3))
    want = jfa.flash_attention(jq, jk, jv, causal=True, block_q=64,
                               block_k=64)
    _close(_t2n(tfa.flash_attention(tq, tk, tv, causal=True)), want, 2e-5)


def test_kv_len_masks_padding():
    (jq, jk, jv), (tq, tk, tv) = _both((1, 1, 128, 32), range(3))
    want = jfa.flash_attention(jq, jk, jv, kv_len=77)
    got = tfa.flash_attention(tq, tk, tv, kv_len=77)
    _close(_t2n(got), want, 2e-5)
    _close(_t2n(got), _t2n(tfa.reference_attention(
        tq, tk[:, :, :77], tv[:, :, :77])), 2e-5)


def test_offsets_shift_causal_mask_and_fully_masked_rows():
    (jq, jk, jv), (tq, tk, tv) = _both((1, 1, 64, 32), range(3))
    # q_offset = seq_k: every key visible.
    want = jfa.flash_attention(jq, jk, jv, causal=True, q_offset=64)
    _close(_t2n(tfa.flash_attention(tq, tk, tv, causal=True, q_offset=64)),
           want, 2e-5)
    # keys entirely in the future: every row masked, O = 0, LSE = -1e30.
    o, lse = tfa.flash_attention(tq, tk, tv, causal=True, k_offset=64,
                                 with_lse=True)
    jo, jlse = jfa.flash_attention(jq, jk, jv, causal=True, k_offset=64,
                                   with_lse=True)
    assert float(o.abs().max()) == 0.0 and float(np.abs(jo).max()) == 0.0
    assert bool((lse == tfa.NEG_INF).all())
    np.testing.assert_array_equal(_t2n(lse), np.asarray(jlse))


def test_ragged_offsets_kv_len_and_lse():
    # S and D off the tile grid, q/k offsets that leave rows 0..15 with no
    # visible key, and key padding.
    kw = dict(causal=True, q_offset=32, k_offset=48, kv_len=250,
              with_lse=True)
    (jq, jk, jv), (tq, tk, tv) = _both((1, 2, 300, 40), range(3))
    jo, jlse = jfa.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw)
    o, lse = tfa.flash_attention(tq, tk, tv, **kw)
    _close(_t2n(o), jo, 2e-5)
    _close(_t2n(lse), jlse, 2e-5)
    assert float(o[:, :, :16].abs().max()) == 0.0
    assert bool((lse[:, :, :16] == tfa.NEG_INF).all())
    ro, rlse = jfa.reference_attention(jq, jk, jv, **kw)
    _close(_t2n(o), ro, 2e-5)
    _close(_t2n(lse), rlse, 2e-5)


def test_lse_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both((1, 2, 128, 32), range(3))
    _, want = jfa.flash_attention(jq, jk, jv, with_lse=True)
    _, got = tfa.flash_attention(tq, tk, tv, with_lse=True)
    _close(_t2n(got), want, 2e-5)
    ref = jax.scipy.special.logsumexp(
        jnp.einsum("bhqd,bhkd->bhqk", jq, jk) / np.sqrt(32), axis=-1)
    _close(_t2n(got), ref, 2e-5)


def _torch_grads(loss_fn, tensors):
    leaves = [t.clone().requires_grad_() for t in tensors]
    loss_fn(*leaves).backward()
    return [_t2n(t.grad) for t in leaves]


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = _both((1, 2, 128, 32), range(3))
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, causal=causal) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
    got = _torch_grads(lambda q, k, v: (tfa.flash_attention(
        q, k, v, causal=causal) ** 2).sum(), (tq, tk, tv))
    ref = _torch_grads(lambda q, k, v: (tfa.reference_attention(
        q, k, v, causal=causal) ** 2).sum(), (tq, tk, tv))
    for g, w, r in zip(got, want, ref):
        _close(g, w, 5e-4)
        _close(g, r, 5e-4)


def test_gradients_ragged_offsets_match_jax():
    kw = dict(causal=True, q_offset=32, k_offset=48, kv_len=250)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((1, 2, 300, 40), range(4))
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, block_q=64, block_k=64, **kw) * jg),
        argnums=(0, 1, 2))(jq, jk, jv)
    got = _torch_grads(lambda q, k, v: (tfa.flash_attention(
        q, k, v, **kw) * tg).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g, w, 5e-4)


def test_lse_cotangent_flows_through_backward():
    (jq, jk, jv), (tq, tk, tv) = _both((1, 2, 128, 32), range(3))

    def jloss(q, k, v):
        o, lse = jfa.flash_attention(q, k, v, causal=True, with_lse=True)
        return jnp.sum(o ** 2) + jnp.sum(
            jnp.where(lse > -1e29, lse, 0.0) ** 2)

    def tloss(fn):
        def loss(q, k, v):
            o, lse = fn(q, k, v, causal=True, with_lse=True)
            return (o ** 2).sum() + (torch.where(lse > -1e29, lse, 0.0)
                                     ** 2).sum()
        return loss

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    got = _torch_grads(tloss(tfa.flash_attention), (tq, tk, tv))
    ref = _torch_grads(tloss(tfa.reference_attention), (tq, tk, tv))
    for g, w, r in zip(got, want, ref):
        _close(g, w, 5e-4)
        _close(g, r, 5e-4)


def test_bfloat16_inputs():
    (jq, jk, jv), (tq, tk, tv) = _both((1, 2, 128, 128), range(3),
                                       jnp.bfloat16, torch.bfloat16)
    got = tfa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    _close(_t2n(got), jfa.flash_attention(jq, jk, jv, causal=True), 3e-2)
    _close(_t2n(got), jfa.reference_attention(jq, jk, jv, causal=True),
           3e-2)


def test_bfloat16_gradients():
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both(
        (1, 2, 128, 64), range(4), jnp.bfloat16, torch.bfloat16)
    want = jax.grad(lambda q, k, v: jnp.sum(
        (jfa.flash_attention(q, k, v, causal=True) * jg).astype(
            jnp.float32)), argnums=(0, 1, 2))(jq, jk, jv)
    got = _torch_grads(lambda q, k, v: (tfa.flash_attention(
        q, k, v, causal=True) * tg).float().sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g, w, 3e-2)


SKIP_CASES = [
    # (causal, q_off, k_off, kv_len, n_q, n_k)
    (True, 0, 0, 512, 8, 8),
    (False, 0, 0, 250, 5, 5),
    (True, 32, 48, 250, 5, 5),
    (True, 64, 0, 64, 1, 1),
    (True, 0, 64, 64, 1, 1),
    (True, 100, 0, 300, 3, 5),
]


@pytest.mark.parametrize("case", SKIP_CASES)
def test_tile_schedule_matches_block_skip(case):
    causal, q_off, k_off, kv_len, n_q, n_k = case
    bm = 64
    lens = (q_off, k_off, kv_len)
    want = {(qb, kb): bool(jfa._tile_interior(causal, q_off, k_off, kv_len,
                                              qb, kb, bm, bm))
            for qb in range(n_q) for kb in range(n_k)
            if not bool(jfa._block_skip(causal, q_off, k_off, kv_len, qb,
                                        kb, bm, bm))}
    by_q = {(qb, kb): inside for qb in range(n_q)
            for kb, inside in tfa.k_tiles(causal, lens, qb, n_k, bm)}
    by_k = {(qb, kb): inside for kb in range(n_k)
            for qb, inside in tfa.q_tiles(causal, lens, kb, n_q, bm)}
    assert by_q == want
    assert by_k == want


def test_plain_versions_visit_exactly_the_scheduled_tiles(monkeypatch):
    """The plain forward and both backwards compute the tiles of the
    schedule and no others (the tiles _block_skip keeps)."""
    visited = []
    real_k, real_q = tfa.k_tiles, tfa.q_tiles

    def k_tiles(causal, lens, qb, n_k, bm):
        out = real_k(causal, lens, qb, n_k, bm)
        visited.extend((qb, kb) for kb, _ in out)
        return out

    def q_tiles(causal, lens, kb, n_q, bm):
        out = real_q(causal, lens, kb, n_q, bm)
        visited.extend((qb, kb) for qb, _ in out)
        return out

    real_mask = tfa._tile_mask
    masked = []

    def tile_mask(causal, lens, qb, kb, bm, device):
        masked.append((qb, kb))
        return real_mask(causal, lens, qb, kb, bm, device)

    monkeypatch.setattr(tfa, "k_tiles", k_tiles)
    monkeypatch.setattr(tfa, "q_tiles", q_tiles)
    monkeypatch.setattr(tfa, "_tile_mask", tile_mask)
    causal, q_off, k_off, kv_len = True, 32, 48, 250
    q, k, v = (torch.tensor(_np((1, 1, 300, 64), s)) for s in range(3))
    qp, kp, vp = tfa._prepare(q, k, v)
    bm = tfa.tile_rows(qp.dtype)
    n = qp.shape[1] // bm
    want = sorted((qb, kb) for qb in range(n) for kb in range(n)
                  if not bool(jfa._block_skip(causal, q_off, k_off, kv_len,
                                              qb, kb, bm, bm)))
    interior = {(qb, kb) for qb, kb in want
                if bool(jfa._tile_interior(causal, q_off, k_off, kv_len, qb,
                                           kb, bm, bm))}
    lens = (q_off, k_off, kv_len)
    o, lse = tfa.attention_fwd(qp, kp, vp, lens, 0.125, causal)
    assert sorted(visited) == want
    assert set(masked) == set(want) - interior
    delta = torch.zeros_like(lse)
    for fn in (tfa.attention_bwd_dkv, tfa.attention_bwd_dq):
        visited.clear()
        masked.clear()
        fn(qp, kp, vp, o, lse, delta, lens, 0.125, causal)
        assert sorted(visited) == want
        assert set(masked) == set(want) - interior


def test_cpu_tensors_take_the_plain_version_without_counting():
    tfa.reset_launches()
    q = torch.tensor(_np((1, 1, 64, 64), 0))
    tfa.flash_attention(q, q, q, causal=True)
    tfa.flash_attention(q, q, q, dropout_seed=3, dropout_rate=0.1)
    assert set(tfa.LAUNCHES) == {
        f"{k}{m}" for k in ("fwd", "bwd_dkv", "bwd_dq")
        for m in ("", "_mask", "_philox")}
    assert not any(tfa.LAUNCHES.values())

"""The port's CUDA kernels through the differentiable entry point, on the
card: ``flash_attention`` forward and backward against the dense
``reference_attention`` (autograd through plain PyTorch), without dropout and
in both dropout modes (an explicit keep-mask, and a seed whose Philox pattern
the reference is fed), and one launch of each kernel per forward/backward.

Needs a CUDA device and nvcc; everywhere else every test skips. Imports
only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: fp32 forward 2e-5 and gradients 5e-4 (the JAX package's kernel
tests); bf16 3e-2; fp16 4e-3 (bf16's 3e-2 scaled by the 8x finer fp16
mantissa).
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the GPU machine)")
    return torch.device("cuda")


def _inputs(shape, dtype, device, n=4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device=device, dtype=dtype)
            for _ in range(n)]


def _grads(fn, leaves, g):
    leaves = [x.clone().requires_grad_() for x in leaves]
    out = fn(*leaves)
    (out.float() * g.float()).sum().backward()
    return out, [x.grad for x in leaves]


CASES = [
    # (shape, kwargs)
    ((2, 4, 256, 64), dict(causal=True)),
    ((1, 2, 300, 40), dict(causal=False, kv_len=250)),
    ((1, 2, 300, 40), dict(causal=True, q_offset=32, k_offset=48,
                           kv_len=250)),
    ((1, 2, 128, 128), dict(causal=True)),
]


@pytest.mark.parametrize("shape,kw", CASES)
@pytest.mark.parametrize("dtype,fwd_tol,grad_tol", [
    (torch.float32, 2e-5, 5e-4), (torch.bfloat16, 3e-2, 3e-2)])
def test_kernels_match_dense_reference(cuda, shape, kw, dtype, fwd_tol,
                                       grad_tol):
    q, k, v, g = _inputs(shape, dtype, cuda)
    got, got_g = _grads(lambda q, k, v: tfa.flash_attention(q, k, v, **kw),
                        (q, k, v), g)
    want, want_g = _grads(
        lambda q, k, v: tfa.reference_attention(
            q.float(), k.float(), v.float(), **kw),
        (q, k, v), g)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a.float(), b.float(), atol=grad_tol,
                                   rtol=grad_tol)


def test_lse_and_its_cotangent_on_the_card(cuda):
    q, k, v = _inputs((1, 2, 192, 64), torch.float32, cuda, n=3)
    kw = dict(causal=True, q_offset=16, k_offset=40, with_lse=True)

    def loss(fn):
        def f(q, k, v):
            o, lse = fn(q, k, v, **kw)
            return (o ** 2).sum() + (torch.where(lse > -1e29, lse, 0.0)
                                     ** 2).sum()
        return f

    grads = {}
    for name, fn in (("kernel", tfa.flash_attention),
                     ("dense", tfa.reference_attention)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        loss(fn)(*leaves).backward()
        grads[name] = [x.grad for x in leaves]
    for a, b in zip(grads["kernel"], grads["dense"]):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)


def test_one_launch_per_kernel_per_forward_and_backward(cuda):
    q, k, v, g = _inputs((1, 2, 128, 64), torch.bfloat16, cuda)
    tfa.reset_launches()
    _grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal=True),
           (q, k, v), g)
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == \
        {"fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}


def _padded_philox_mask(seed, shape, rate, device):
    """The seeded kernels' keep pattern, cut to the unpadded (B, H, Sq, Sk)."""
    b, h, s, _ = shape
    s_pad = -(-s // tfa.SEQ_PAD) * tfa.SEQ_PAD
    m = tfa.philox_keep_mask(seed, b * h, s_pad, s_pad, rate, device)
    return m[:, :s, :s].reshape(b, h, s, s)


@pytest.mark.parametrize("mode", ["mask", "philox"])
@pytest.mark.parametrize("shape,kw", CASES)
@pytest.mark.parametrize("dtype,fwd_tol,grad_tol", [
    (torch.float32, 2e-5, 5e-4), (torch.bfloat16, 3e-2, 3e-2)])
def test_dropout_kernels_match_dense_reference(cuda, mode, shape, kw, dtype,
                                               fwd_tol, grad_tol):
    rate = 0.1
    q, k, v, g = _inputs(shape, dtype, cuda)
    if mode == "mask":
        gen = torch.Generator(device=cuda).manual_seed(1)
        mask = torch.rand(shape[:3] + (shape[2],), generator=gen,
                          device=cuda) < 1 - rate
        drop = dict(dropout_mask=mask)
    else:
        mask = _padded_philox_mask(11, shape, rate, cuda)
        drop = dict(dropout_seed=11)
    tfa.reset_launches()
    got, got_g = _grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, dropout_rate=rate, **drop, **kw), (q, k, v), g)
    want, want_g = _grads(
        lambda q, k, v: tfa.reference_attention(
            q.float(), k.float(), v.float(), dropout_mask=mask,
            dropout_rate=rate, **kw),
        (q, k, v), g)
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == \
        {f"fwd_{mode}": 1, f"bwd_dkv_{mode}": 1, f"bwd_dq_{mode}": 1}
    torch.testing.assert_close(got.float(), want.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a.float(), b.float(), atol=grad_tol,
                                   rtol=grad_tol)


def test_philox_mask_on_the_card_matches_the_cpu(cuda):
    on_card = tfa.philox_keep_mask(5, 4, 128, 256, 0.1, cuda).cpu()
    assert torch.equal(on_card, tfa.philox_keep_mask(5, 4, 128, 256, 0.1,
                                                     "cpu"))


def _drop_kwargs(mode, shape, rate, device):
    """The flash call's dropout arguments in ``mode`` and the keep-mask the
    dense reference is fed."""
    if mode == "none":
        return {}, None
    if mode == "mask":
        gen = torch.Generator(device=device).manual_seed(1)
        mask = torch.rand(shape[:3] + (shape[2],), generator=gen,
                          device=device) < 1 - rate
        return dict(dropout_mask=mask, dropout_rate=rate), mask
    return (dict(dropout_seed=11, dropout_rate=rate),
            _padded_philox_mask(11, shape, rate, device))


def _check_against_reference(shape, dtype, kw, mode, tol, device):
    rate = 0.1
    q, k, v, g = _inputs(shape, dtype, device)
    drop, mask = _drop_kwargs(mode, shape, rate, device)
    tfa.reset_launches()
    got, got_g = _grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, **drop, **kw), (q, k, v), g)
    want, want_g = _grads(
        lambda q, k, v: tfa.reference_attention(
            q.float(), k.float(), v.float(), dropout_mask=mask,
            dropout_rate=rate if mask is not None else 0.0, **kw),
        (q, k, v), g)
    torch.cuda.synchronize()
    sfx = "" if mode == "none" else f"_{mode}"
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == \
        {f"fwd{sfx}": 1, f"bwd_dkv{sfx}": 1, f"bwd_dq{sfx}": 1}
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("mode", ["none", "mask", "philox"])
def test_bert_shape_in_each_dropout_mode(cuda, mode):
    """BERT-large's attention: 16 heads of 64 over 512 keys, no causal
    mask, bf16."""
    _check_against_reference((1, 16, 512, 64), torch.bfloat16,
                             dict(causal=False), mode, 3e-2, cuda)


@pytest.mark.parametrize("mode", ["none", "mask", "philox"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lens", [(80, 0, 512), (0, 100, 480)])
def test_causal_dq_with_offsets_matches_its_plain_version(cuda, lens, d,
                                                          mode):
    """The dQ kernel starts the heaviest q tiles first on causal grids: with
    a q offset every q tile sees another number of k tiles (and with a k
    offset the first tiles see none, dQ = 0), so a tile written to the wrong
    rows, or a k range cut at the wrong tile, shows. Held to the plain
    version on the same LSE and delta, bf16, at ``chip_smoke.py``'s bf16
    tolerance (one ulp of the output plus 1e-2)."""
    bh, s = 4, 512
    q, k, v, do = _inputs((bh, s, d), torch.bfloat16, cuda, seed=3)
    drop = None
    if mode == "mask":
        gen = torch.Generator(device=cuda).manual_seed(2)
        drop = tfa.Dropout(0.1, mask=(torch.rand(
            bh, s, s, generator=gen, device=cuda) >= 0.1).to(torch.uint8))
    elif mode == "philox":
        drop = tfa.Dropout(0.1, seed=21)
    keep = None if drop is None else drop.multiplier(bh, s, s, cuda)
    scale = d ** -0.5
    o, lse = tfa.attention_fwd_plain(q, k, v, lens, scale, True, keep)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, lens, scale, True)
    tfa.reset_launches()
    got = tfa.attention_bwd_dq(*args, drop)
    want = tfa.attention_bwd_dq_plain(*args, keep)
    torch.cuda.synchronize()
    sfx = "" if mode == "none" else f"_{mode}"
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {f"bwd_dq{sfx}": 1}
    dead = max(0, lens[1] - lens[0])    # rows that see no key
    if dead:
        assert got[:, :dead].abs().max().item() == 0.0
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=2 ** -6)


@pytest.mark.parametrize("mode", ["none", "mask", "philox"])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float16, 4e-3)])
def test_head_dim_128_causal_on_the_sixteen_bit_kernels(cuda, dtype, tol,
                                                        mode):
    """Head dim 128, where dK/dV works in 32-query sub-tiles; a ragged
    sequence with offsets (partial tiles, rows that see no key)."""
    _check_against_reference((1, 2, 300, 128), dtype,
                             dict(causal=True, q_offset=32, k_offset=48,
                                  kv_len=250), mode, tol, cuda)

"""``chip_smoke.py``'s ``[parallel]`` checks on the CPU: the ring's
per-rank schedule (the port's ring loop over the flash kernels' plain
versions in the LSE mode, its rotation done by slicing) against dense
attention, the verdict on the one-rank job's results, and the LSE-mode
bounds at the ring's chunk shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel.ring_attention import _ring_local


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
def test_ring_schedule_matches_dense_attention(dtype, tol):
    n, shape = 4, (1, 2, 256, 64)
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen).to(dtype)
                   for _ in range(4))
    out, calls = chip_smoke.ring_schedule(tfa, _ring_local, q, k, v,
                                            n)
    out.backward(do)
    got = [out] + chip_smoke.ring_grads(calls, shape, n)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    o = tfa.reference_attention(*leaves, causal=True)
    want = [o] + list(torch.autograd.grad(o, leaves, do.float()))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, atol=tol, rtol=tol)
    assert len(calls) == n * n
    # rank r sees its own chunk first, then r-1, ... (the rotation's order)
    assert [c["src"] for c in calls[4:8]] == [1, 0, 3, 2]
    for c in calls:
        if c["src"] > c["r"]:       # fully-future: nothing to see
            assert bool((c["o"] == 0).all())
            assert bool((c["lse"] == tfa.NEG_INF).all())
            for x in "qkv":
                assert bool((c[x].grad == 0).all())


def _parallel_result():
    return {
        "backend": "nccl",
        "pipeline": {"losses": [10.4, 10.2, 10.0],
                     "model_losses": [10.4, 10.2, 10.0001],
                     "grad_fro": {"tok_embed": 3e-3, "lm_head.weight": 1e-3}},
    }


@pytest.mark.parametrize("path,value,phrase", [
    (None, None, None),
    (("pipeline", "losses"), [10.4, 10.2, 10.1], "pipeline losses"),
    (("pipeline", "losses"), [10.4, float("nan"), 10.0], "pipeline losses"),
    (("pipeline", "grad_fro"), {}, "pipeline gradients"),
    (("pipeline", "losses"), [10.4, 10.2], "pipeline losses"),
    (("pipeline", "grad_fro", "tok_embed"), 0.3, "pipeline gradients"),
    (("backend",), "gloo", "not NCCL"),
])
def test_parallel_verdict_holds_each_check(path, value, phrase):
    res = _parallel_result()
    if path is not None:
        node = res
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    bad = chip_smoke.parallel_verdict(res)
    if phrase is None:
        assert bad == []
    else:
        assert len(bad) == 1 and phrase in bad[0], bad


@pytest.mark.parametrize("kind,chunk,want_ms", [
    # a past chunk: every pair of 16 x 8192 x 8192 visible
    ("fwd", "past", 4 * 64 * 8192 ** 2 * 16 / 989e12 * 1e3),
    ("bwd_dkv", "past", 8 * 64 * 8192 ** 2 * 16 / 989e12 * 1e3),
    ("bwd_dq", "past", 6 * 64 * 8192 ** 2 * 16 / 989e12 * 1e3),
    # the diagonal chunk: the causal half and its diagonal
    ("fwd", "diagonal", 4 * 64 * 8192 * 8193 // 2 * 16 / 989e12 * 1e3),
])
def test_lse_bounds_at_the_ring_chunk_shapes(kind, chunk, want_ms):
    s = 8192
    pairs = chip_smoke.visible_pairs(s, s, *chip_smoke.LSE_CHUNKS[chunk],
                                     True)
    ms, by = chip_smoke.bound(kind, 16, s, s, 64, pairs, 2)
    assert by == "operations"
    np.testing.assert_allclose(ms, want_ms, rtol=1e-12)
    future = chip_smoke.visible_pairs(
        s, s, *chip_smoke.LSE_CHUNKS["future"], True)
    assert future == 0

"""The work counts behind ``chip_smoke.py``'s kernel bounds: the (query, key)
pairs each mask keeps, and the least time of a call at the main paths'
shapes, bytes against operations at the H100's published peaks."""

import itertools

import pytest

import chip_smoke


def _pairs_by_loop(s_q, s_k, q_off, k_off, kv_len, causal):
    return sum(1 for i, j in itertools.product(range(s_q), range(s_k))
               if j < kv_len and (not causal or q_off + i >= k_off + j))


@pytest.mark.parametrize("s_q,s_k,q_off,k_off,kv_len,causal", [
    (64, 64, 0, 0, 64, False), (64, 64, 0, 0, 64, True),
    (48, 80, 0, 0, 70, False), (48, 80, 32, 48, 70, True),
    (20, 36, 0, 16, 36, True)])
def test_visible_pairs_counts_every_kept_pair(s_q, s_k, q_off, k_off, kv_len,
                                              causal):
    assert chip_smoke.visible_pairs(s_q, s_k, q_off, k_off, kv_len, causal) \
        == _pairs_by_loop(s_q, s_k, q_off, k_off, kv_len, causal)


@pytest.mark.parametrize("kind,causal,mask_bytes,want_ms,want_by", [
    # TransformerLM (causal): all three bound by bytes
    ("fwd", True, 0, 0.0101, "bytes"),
    ("bwd_dkv", True, 0, 0.0152, "bytes"),
    ("bwd_dq", True, 0, 0.0127, "bytes"),
    # BERT (non-causal), seeded: the backward is bound by operations
    ("fwd", False, 0, 0.0101, "bytes"),
    ("bwd_dkv", False, 0, 0.0174, "operations"),
    ("bwd_dq", False, 0, 0.0130, "operations"),
    # BERT, explicit mask: the 33.5 MB keep-mask is read once
    ("bwd_dkv", False, 128 * 512 * 512, 0.0252, "bytes"),
])
def test_bounds_at_the_main_paths_shapes(kind, causal, mask_bytes, want_ms,
                                         want_by):
    pairs = chip_smoke.visible_pairs(512, 512, 0, 0, 512, causal)
    ms, by = chip_smoke.bound(kind, 128, 512, 512, 64, pairs, 2, mask_bytes)
    assert (round(ms, 4), by) == (want_ms, want_by)


def _zero_result():
    """A [zero] child result that holds every check: 5 ZeRO steps equal to
    [native]'s losses, 3 steps of each codec."""
    launches = [dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), 24)]
    losses = [10.8, 10.1, 9.7, 9.3, 9.0]
    run = dict(losses=losses, per_step_launches=launches * 5,
               responses=[25] * 5, host_waits=0, state_bytes=2918809188)
    zero = dict(run, state_bytes=2918808512, chunks=12, param_max_abs=0.0,
                param_max=1.0)
    codec = dict(run, losses=[10.8, 10.2, 9.8],
                 per_step_launches=launches * 3)
    return {"replicated": run, "zero": zero, "bf16": dict(codec),
            "int8": dict(codec)}, losses


@pytest.mark.parametrize("run,key,value,phrase", [
    (None, None, None, None),
    ("zero", "losses", [10.8, 10.1, 9.7, 9.3, 9.0001], "differ from"),
    ("zero", "param_max_abs", 2e-6, "final parameters"),
    ("zero", "state_bytes", 2 * 2918809188, "state bytes"),
    ("zero", "host_waits", 1, "host wait"),
    ("zero", "responses", [25, 25, 23, 25, 25], "did not run through"),
    ("replicated", "per_step_launches",
     [dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), 24)] * 4
     + [{"fwd": 24, "bwd_dkv": 23, "bwd_dq": 24}], "24 launches"),
    ("int8", "losses", [10.9, 10.2, 9.8], "step 1 loss"),
    ("bf16", "losses", [10.8, 10.9, 11.0], "did not descend"),
])
def test_zero_verdict_holds_each_check(run, key, value, phrase):
    res, native = _zero_result()
    if run is not None:
        res[run][key] = value
    bad = chip_smoke.zero_verdict(res, native)
    if phrase is None:
        assert bad == []
    else:
        assert len(bad) == 1 and phrase in bad[0], bad

"""``chip_smoke.py``'s ``[bertmodel]`` and ``[trace]`` checks on the CPU:
each verdict fails on the one result that breaks its check, and the
non-causal kernel rows' bounds count every (query, key) pair."""

import copy
import math

import pytest

import chip_smoke

LAYERS = 24


def _runs():
    one = dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), LAYERS)
    two = dict(one, fwd=2 * LAYERS)
    losses = [10.8, 10.5, 10.3, 10.0, 9.9]
    return {False: {"losses": list(losses), "peak_gib": 9.9,
                    "launches": [one] * 5},
            "dots": {"losses": list(losses), "peak_gib": 7.6,
                     "launches": [two] * 5},
            True: {"losses": list(losses), "peak_gib": 7.0,
                   "launches": [two] * 5}}


@pytest.mark.parametrize("remat,key,value,phrase", [
    (None, None, None, None),
    ("dots", "losses", [10.8, 10.5, 10.3, 10.0, 9.9 * (1 + 2e-4)],
     "moved the losses"),
    (False, "losses", [10.8, 10.9, 10.3, 10.0, 11.0], "do not descend"),
    (True, "losses", [10.8, math.nan, 10.3, 10.0, 9.9], "do not descend"),
    (True, "launches", [dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"),
                                      LAYERS)] * 5, "launches per step"),
    ("dots", "peak_gib", 7.0, "peak memory"),
    (False, "peak_gib", 7.5, "peak memory"),
])
def test_bertmodel_verdict_holds_each_check(remat, key, value, phrase):
    runs = _runs()
    if key is None:
        assert chip_smoke.bertmodel_verdict(runs, LAYERS) == []
        return
    runs = copy.deepcopy(runs)
    runs[remat][key] = value
    bad = chip_smoke.bertmodel_verdict(runs, LAYERS)
    assert bad and any(phrase in b for b in bad), bad


def test_noncausal_bounds_count_every_pair():
    s, d, bh = chip_smoke.MAIN["seq"], chip_smoke.MAIN["d"], \
        chip_smoke.MAIN["bh"]
    full = chip_smoke.visible_pairs(s, s, 0, 0, s, False)
    causal = chip_smoke.visible_pairs(s, s, 0, 0, s, True)
    assert full == s * s and causal == s * (s + 1) // 2
    got = {k: chip_smoke.bound(k, bh, s, s, d, full, 2)
           for k in ("fwd", "bwd_dkv", "bwd_dq")}
    # Twice the causal rows' products: the backward kernels turn
    # operations-bound at BERT's shape, the forward stays bytes-bound.
    assert [by for _, by in got.values()] == ["bytes", "operations",
                                              "operations"]
    ops_dkv = 8 * d * full * bh / chip_smoke.H100_BF16_FLOPS * 1e3
    assert got["bwd_dkv"][0] == pytest.approx(ops_dkv)


def _trace_inputs():
    events = []
    for occ in range(1, chip_smoke.TRACE_STEPS + 1):
        for name in ("grad", "grad.loss"):
            events.append({"e": "sub", "t": occ + 0.1, "n": name,
                           "k": "allreduce", "o": occ})
            events.append({"e": "fin", "t": occ + 0.2, "n": name,
                           "o": occ})
    shards = [{"meta": {"rank": 0, "ver": 0}, "events": events}]
    from horovod_tpu_torch.tracing import analyze, merge
    trace = merge.merge_shards(shards)
    report = analyze.analyze(shards)
    fams = ["hvd_backend_collective_seconds", "hvd_collective_abort_total",
            "hvd_coordinator_cycle_seconds", "hvd_coordinator_ops_total",
            "hvd_overlap_fraction"] + [f"hvd_coordinator_x{i}"
                                       for i in range(8)]
    text = "".join(f"# TYPE {n}_cluster gauge\n" for n in fams)
    launches = dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"),
                             chip_smoke.PAR_LM["layers"])
    res = {"families": fams, "samples": {n: 1 for n in fams},
           "launches": [launches] * chip_smoke.TRACE_STEPS,
           "losses": [10.8, 10.1, 9.7, 9.3, 9.0]}
    return res, shards, trace, report, text


def test_trace_verdict_holds_each_check():
    res, shards, trace, report, text = _trace_inputs()
    assert chip_smoke.trace_verdict(res, shards, trace, report, text) == []
    broken = copy.deepcopy(shards)
    broken[0]["events"] = [r for r in broken[0]["events"]
                           if not (r["e"] == "fin" and r["o"] == 3)]
    bad = chip_smoke.trace_verdict(res, broken, trace, report, text)
    assert any("without sub/fin" in b for b in bad), bad
    failed = copy.deepcopy(shards)
    failed[0]["events"][1]["err"] = 1
    bad = chip_smoke.trace_verdict(res, failed, trace, report, text)
    assert any("failed" in b for b in bad), bad
    short = text.replace("# TYPE hvd_coordinator_ops_total_cluster gauge\n",
                         "")
    bad = chip_smoke.trace_verdict(res, shards, trace, report, short)
    assert any("lacks ['hvd_coordinator_ops_total']" in b for b in bad), bad
    quiet = copy.deepcopy(res)
    quiet["samples"]["hvd_coordinator_ops_total"] = 0
    bad = chip_smoke.trace_verdict(quiet, shards, trace, report, text)
    assert any("families with samples" in b for b in bad), bad
    no_track = {"traceEvents": [e for e in trace["traceEvents"]
                                if e["ph"] != "M"]}
    bad = chip_smoke.trace_verdict(res, shards, no_track, report, text)
    assert any("no track for rank 0" in b for b in bad), bad
    one_step = dict(report, steps=report["steps"][:1])
    bad = chip_smoke.trace_verdict(res, shards, trace, one_step, text)
    assert any("critical paths" in b for b in bad), bad

"""The trace and metrics planes across four GPUs, over NCCL, as launcher
jobs with one rank per GPU:

- ``tests/torch_port_tracing_worker.py card``: 4 ranks train the
  full-width TransformerLM (vocab 30522, hidden 1024, 16 heads, seq 512,
  flash attention) at 4 layers, one row each, 6 AdamW steps through the
  torch binding's DistributedOptimizer, with ``HVDTPU_TRACE=1`` and
  ``HOROVOD_TPU_METRICS=1``; rank 2 sleeps 50 ms before each backward.
  The merged trace has a track per rank and a flow arrow per collective;
  the analysis names rank 2 the straggler of the gradient allreduces of
  steps 2-6 (at least 90% of them), their median submit skew within
  35-100 ms (the 50 ms sleep, plus or minus the ranks' forward times);
  the launcher's ``/metrics`` rolls up the 4 ranks' pushed snapshots;
- ``tests/torch_port_guardian_worker.py frozen`` at 4 ranks with
  ``HVDTPU_COLLECTIVE_TIMEOUT=10``: rank 3 freezes (SIGSTOP) inside a
  step; each of ranks 0-2 aborts and leaves a flight-recorder postmortem
  (reason ``collective_abort``) in ``HVDTPU_TRACE_DIR``. The frozen rank
  is stopped, then killed, and leaves none.

Needs 4 GPUs; skips elsewhere:

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_tracing_cuda.py
"""

import json
import os
import statistics
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_tracing_worker.py")
STRAGGLER_RANK = 2
SKEW_BAND_S = (0.035, 0.100)


def _skip_without_four_gpus():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (a multi-GPU machine)")


def _build():
    import torch_port_launch
    from horovod_tpu_torch import _build as build
    build.build(["flash_attention"])
    torch_port_launch.build_port_core()


@pytest.fixture(scope="module")
def traced_job(tmp_path_factory):
    _skip_without_four_gpus()
    _build()
    from test_torch_port_guardian import _env
    out = tmp_path_factory.mktemp("trace-card")
    traces = out / "traces"
    env = _env({"HVDTPU_TRACE": "1", "HVDTPU_TRACE_DIR": str(traces),
                "HOROVOD_TPU_METRICS": "1",
                "HVDTPU_METRICS_PUSH_INTERVAL": "1",
                "STRAGGLER_RANK": str(STRAGGLER_RANK),
                "STRAGGLER_MS": "50", "TRACE_LAYERS": "4",
                "TRACE_STEPS": "6"})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "4", "--start-timeout", "300", sys.executable, WORKER, "card",
         str(out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=900)
    res = {}
    for r in range(4):
        path = out / f"r{r}.json"
        res[r] = json.loads(path.read_text()) if path.exists() else None
    assert proc.returncode == 0 and all(res.values()), \
        (proc.stdout + proc.stderr)[-6000:]
    from horovod_tpu_torch.tracing import analyze, merge
    shards = merge.load_paths([str(traces)], kinds=(merge.SHARD_PREFIX,))
    report = analyze.analyze(shards)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[trace card] cards: {'; '.join(smi.splitlines())}", flush=True)
    ms = {r: statistics.median(v["ms"][1:]) for r, v in res.items()}
    print(f"[trace card] 4 ranks, step ms (median of steps 2-6) {ms}; "
          f"losses rank 0 {res[0]['losses']}", flush=True)
    print("[trace card] " + analyze.render_report(report).replace(
        "\n", "\n[trace card] "), flush=True)
    return {"res": res, "shards": shards, "report": report}


def test_the_merged_trace_has_four_tracks_and_a_flow_per_collective(
        traced_job):
    from horovod_tpu_torch.tracing import merge
    shards = traced_job["shards"]
    assert sorted(s["meta"]["rank"] for s in shards) == [0, 1, 2, 3]
    trace = json.loads(json.dumps(merge.merge_shards(shards)))
    tracks = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M"}
    assert tracks == {r: f"rank {r}" for r in range(4)}
    keys = [set(merge.collective_spans(s)) for s in shards]
    assert keys[0] == keys[1] == keys[2] == keys[3]
    for s in shards:
        for key, sp in merge.collective_spans(s).items():
            assert sp["fin"] is not None and not sp["err"], key
    flows = [e for e in trace["traceEvents"] if e["ph"] == "s"]
    ends = [e for e in trace["traceEvents"] if e["ph"] == "f"]
    assert len(flows) == len(keys[0]) and len(ends) == 3 * len(keys[0])


def test_analyze_names_rank_two_the_straggler(traced_job):
    report = traced_job["report"]
    late = [c for c in report["collective_table"]
            if c["name"].startswith("grad.") and c["occ"] >= 2]
    assert late
    gated = [c for c in late if c["straggler_rank"] == STRAGGLER_RANK]
    skew = statistics.median(c["submit_skew_s"] for c in late)
    print(f"[trace card] gradient allreduces of steps 2-6: {len(late)}, "
          f"gated by rank {STRAGGLER_RANK}: {len(gated)}; median submit "
          f"skew {skew * 1e3:.2f} ms (band {SKEW_BAND_S[0] * 1e3:g}-"
          f"{SKEW_BAND_S[1] * 1e3:g} ms)", flush=True)
    assert len(gated) >= 0.9 * len(late)
    assert SKEW_BAND_S[0] <= skew <= SKEW_BAND_S[1]
    st = report["stragglers"]
    assert max(st, key=lambda r: st[r]["delay_s"]) == STRAGGLER_RANK


def test_the_launcher_s_metrics_roll_up_four_ranks(traced_job):
    from horovod_tpu_torch.telemetry import parse_prometheus
    res = traced_job["res"][0]
    assert sorted(res["metrics_json"]["ranks"]) == ["0", "1", "2", "3"]
    parsed = parse_prometheus(res["metrics"])
    ops = parsed["hvd_coordinator_ops_total_cluster"]
    stats = {k: v for k, v in ops.items() if 'stat="sum"' in k[-1]}
    per_rank = [res["metrics_json"]["ranks"][str(r)]["families"][
        "hvd_coordinator_ops_total"]["samples"] for r in range(4)]
    total = sum(s["value"] for samples in per_rank for s in samples)
    assert sum(stats.values()) == total > 0
    for r in range(4):
        assert "hvd_backend_collective_seconds" in \
            traced_job["res"][r]["snapshot_families"]


@pytest.fixture(scope="module")
def frozen_job(tmp_path_factory):
    _skip_without_four_gpus()
    _build()
    from test_torch_port_guardian import finish_job, start_job
    out = tmp_path_factory.mktemp("trace-frozen")
    traces = out / "traces"
    proc, log = start_job(out, "frozen", 4, {
        "HVDTPU_COLLECTIVE_TIMEOUT": "10", "PORT_TEST_DEVICE": "cuda",
        "HVDTPU_TRACE_DIR": str(traces)})
    job = finish_job(out, proc, log, 4)
    job["traces"] = traces
    return job


def test_a_frozen_peer_s_abort_leaves_a_postmortem_per_surviving_rank(
        frozen_job):
    from horovod_tpu_torch.tracing import merge
    res = frozen_job["res"]
    assert all(res[r] and res[r]["error"] == "CollectiveAbortError"
               for r in range(3)), frozen_job["log"][-6000:]
    dumps = merge.load_paths([str(frozen_job["traces"])],
                             kinds=(merge.POSTMORTEM_PREFIX,))
    by_rank = {s["meta"]["rank"]: s for s in dumps}
    assert sorted(by_rank) == [0, 1, 2]
    for r, s in by_rank.items():
        assert s["meta"]["reason"] == "collective_abort"
        names = [(e.get("cat"), e["n"]) for e in s["events"]]
        assert ("guardian", "abort") in names
        assert any(e.get("e") == "sub" for e in s["events"])
    print(f"[trace card] frozen peer: postmortems of ranks "
          f"{sorted(by_rank)} with "
          f"{[len(by_rank[r]['events']) for r in sorted(by_rank)]} events",
          flush=True)

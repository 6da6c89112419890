"""The runtime checkers on four H100s, over NCCL (launcher jobs of
tests/torch_port_analysis_runtime_worker.py, one rank per GPU, a
TransformerLM of width 1024 and 4 layers, 6 AdamW steps):

- ``train`` with ``HVDTPU_SANITIZE=1``, ``HOROVOD_TPU_ORDER_CHECK=1`` and
  ``HVDTPU_TRACE=1`` is clean on every rank (no finding, no error, a clean
  shutdown audit, at least one common checkpoint compared), and its losses
  equal those of the same job with neither checker, bit for bit. Both jobs
  run with ``HVDTPU_FUSION_THRESHOLD=1`` (one NCCL call per gradient): the
  native core's fusion follows the cycle timing, and with it NCCL's
  summation order over four ranks, which moved step 6's loss by 9e-4
  relative in a fused pair of runs;
- its traced gradient allreduces' sub→fin spans are at least their NCCL
  device time (CUDA events around each response on the backend's stream):
  a CUDA ``fin`` is stamped at completion, at n = 4;
- ``swap``: rank 2 submits ``grad.1`` before ``grad.0`` from step 2 on;
  every rank raises ``SubmissionOrderError`` naming rank 2 alone, within
  two check intervals of the swap.

Needs 4 GPUs; skips elsewhere:

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_analysis_runtime_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)   # chip_smoke's span check
WORKER = os.path.join(REPO, "tests", "torch_port_analysis_runtime_worker.py")
N = 4
SWAP_RANK = 2
INTERVAL_S = 2.0
CARD_ENV = {"RUNTIME_LAYERS": "4", "RUNTIME_HIDDEN": "1024",
            "RUNTIME_STEPS": "6", "HVDTPU_FUSION_THRESHOLD": "1",
            "HOROVOD_TPU_ORDER_CHECK_INTERVAL": str(INTERVAL_S)}
CHECKED = {"HVDTPU_SANITIZE": "1", "HOROVOD_TPU_ORDER_CHECK": "1"}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _job(mode, out, extra):
    from test_torch_port_guardian import _env
    out.mkdir(parents=True, exist_ok=True)
    env = _env({**CARD_ENV, **extra})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(N), "--start-timeout", "300", sys.executable, WORKER, mode,
         str(out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=900)
    res = {}
    for r in range(N):
        path = out / f"r{r}.json"
        res[r] = json.loads(path.read_text()) if path.exists() else None
    assert all(res.values()), \
        f"{mode} rc={proc.returncode}:\n" + (proc.stdout + proc.stderr)[-6000:]
    return res


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < N:
        pytest.skip(f"needs {N} CUDA devices (a multi-GPU machine)")
    import torch_port_launch
    torch_port_launch.build_port_core()
    root = tmp_path_factory.mktemp("runtime-card")
    traces = root / "traces"
    checked = _job("train", root / "checked",
                   {**CHECKED, "HVDTPU_TRACE": "1",
                    "HVDTPU_TRACE_DIR": str(traces),
                    "RUNTIME_TIME_RESPONSES": "1"})
    plain = _job("train", root / "plain", {})
    return {"checked": checked, "plain": plain, "traces": str(traces),
            "root": root, "card": _card()}


def test_both_checkers_on_four_gpus_are_clean(clean):
    checked, plain = clean["checked"], clean["plain"]
    worst = 0.0
    for r in range(N):
        res = checked[r]
        assert res["backend"] == "nccl-global" and res["sanitize"]
        assert res["error"] is None and res.get("shutdown"), res
        assert res["findings"] == [] and res["leaks"] == [], res
        assert any(v for v in res["verified"]), res["verified"]
        assert plain[r]["guard"] is None and not plain[r]["sanitize"]
        assert len(res["losses"]) == len(plain[r]["losses"]) == 6
        worst = max(worst, max(abs(a - b) / abs(b) for a, b in
                               zip(res["losses"], plain[r]["losses"])))
    print(f"[runtime card] {clean['card']}: checked losses "
          f"{checked[0]['losses']} against unchecked {plain[0]['losses']}: "
          f"max relative difference {worst:.2e}; checkpoints compared per "
          f"rank "
          f"{[len([v for v in checked[r]['verified'] if v]) for r in range(N)]}",
          flush=True)
    for r in range(N):
        assert checked[r]["losses"] == plain[r]["losses"], r


def test_cuda_fin_spans_hold_the_nccl_time_at_four_ranks(clean):
    from chip_smoke import span_check
    from horovod_tpu_torch.tracing import merge
    shards = merge.load_paths([clean["traces"]], kinds=(merge.SHARD_PREFIX,))
    assert sorted(s["meta"]["rank"] for s in shards) == list(range(N))
    for shard in shards:
        r = shard["meta"]["rank"]
        spans = merge.collective_spans(shard)
        assert not [k for k, sp in spans.items() if sp["err"]], r
        checked, short, span_ms, dev_ms = span_check(
            spans, clean["checked"][r]["responses"])
        print(f"[runtime card] {clean['card']}: rank {r}: {checked} traced "
              f"gradient allreduces, median sub->fin {span_ms:.3f} ms, "
              f"median NCCL device time {dev_ms:.3f} ms; shorter spans: "
              f"{len(short)}", flush=True)
        assert checked and not short, (r, short[:10])


def test_a_swapped_rank_is_named_on_every_rank(clean):
    res = _job("swap", clean["root"] / "swap",
               {**CHECKED, "RUNTIME_SWAP_RANK": str(SWAP_RANK),
                "RUNTIME_SWAP_DEADLINE": "60"})
    others = [r for r in range(N) if r != SWAP_RANK]
    for r in range(N):
        err = res[r]["error"]
        assert err and err.startswith(
            "SubmissionOrderError: collective submission order diverged"), \
            (r, err)
        assert f"ranks [{SWAP_RANK}] ->" in err, err
        assert f"ranks {others} ->" in err, err
    waited = [res[r]["swap_s"] for r in range(N)]
    print(f"[runtime card] {clean['card']}: every rank raised "
          f"SubmissionOrderError naming rank {SWAP_RANK}, "
          f"{[round(w, 3) for w in waited]} s after the swap (interval "
          f"{INTERVAL_S:g} s)", flush=True)
    assert max(waited) < 2 * INTERVAL_S

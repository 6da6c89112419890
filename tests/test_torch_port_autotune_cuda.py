"""The autotuner across four GPUs, over NCCL: a 4-rank ``--autotune``
launcher job (``tests/torch_port_autotune_worker.py``, one rank per GPU,
three named allreduces a step) sweeps fusion threshold x cycle time until
it converges. Every rank must log one identical ``applied`` sequence and
end on rank 0's winner: candidate switches follow the count of cycles
that moved bytes, which the native core's negotiation rounds keep in step
on every rank, and rank 0's decisions go out on the data plane from the
cycle thread. A second job against the same store warm-starts on every
rank: one applied config, no scored window.

Needs 4 GPUs; skips elsewhere:

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_autotune_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_autotune_worker.py")
RANKS = 4


def _job(out, cache):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, PORT_TEST_DEVICE="cuda",
               HVDTPU_AUTOTUNE_CACHE=cache,
               # The derived key hashes the names the flight ring holds when
               # the warm-up ends, which depends on timing.
               HVDTPU_AUTOTUNE_SIGNATURE="autotune-worker",
               HVDTPU_AUTOTUNE_FUSION_CANDIDATES_MIB="0,1,32",
               HVDTPU_AUTOTUNE_CYCLE_CANDIDATES_MS="0.5,5",
               HVDTPU_AUTOTUNE_WARMUP_CYCLES="3",
               HVDTPU_AUTOTUNE_CYCLES_PER_CANDIDATE="4")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(RANKS), "--start-timeout", "300", "--autotune",
         sys.executable, WORKER, str(out)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=900)
    res = []
    for r in range(RANKS):
        path = f"{out}.r{r}.json"
        res.append(json.load(open(path)) if os.path.exists(path) else None)
    assert proc.returncode == 0 and all(res), \
        (proc.stdout + proc.stderr)[-6000:]
    return res


def test_four_ranks_apply_one_sequence_then_warm_start(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} CUDA devices (a multi-GPU machine)")
    import torch_port_launch
    torch_port_launch.build_port_core()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    cache = str(tmp_path / "autotune.json")
    sweep = _job(tmp_path / "sweep", cache)
    print(f"\n[autotune x{RANKS}] cards {smi}")
    for r in sweep:
        print(f"[autotune x{RANKS}] rank {r['rank']}: {r['steps']} steps, "
              f"backend {r['backend']}, applied {r['applied']}, winner "
              f"{r['best']}")
    assert all(r["backend"] == "nccl-global" for r in sweep)
    assert all(r["applied"] == sweep[0]["applied"] for r in sweep)
    assert all(r["best"] == sweep[0]["best"] for r in sweep)
    assert not any(r["enabled"] for r in sweep) and sweep[0]["history"]
    want = float(sum(range(1, RANKS + 1)))
    assert all(r["last"] == [want] * 3 for r in sweep)
    assert os.path.exists(cache)
    warm = _job(tmp_path / "warm", cache)
    for r in warm:
        print(f"[autotune x{RANKS}] warm rank {r['rank']}: applied "
              f"{r['applied']} after {r['steps']} steps")
        assert r["history"] == 0 and len(r["applied"]) == 1
        # The store holds the applied threshold (0 MiB is applied as 1).
        assert r["best"] == [max(sweep[0]["best"][0], 1)] + \
            sweep[0]["best"][1:]

"""A two-rank launcher job of the port on the CPU (the delegated plane over
gloo) running tests/torch_port_fx_lint_worker.py: ``tpu_compile(verify=True)``
of a module whose ``torch.cond`` on the traced rank guards a ``psum``
raises ``CollectiveLintError`` (HVD102) on both ranks before any collective
is issued, and the same body with the ``psum`` hoisted out of the ``cond``
runs, its sums equal on both ranks. The job has a time limit of its own.
The two-GPU run of the same worker is tests/test_torch_port_fx_lint_cuda.py.
"""

import json
import os

import torch_port_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_fx_lint_worker.py")
JOB_TIMEOUT = 240


def run_job(out, env_extra):
    import sys
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               HVDTPU_CPU_OPERATIONS="nccl", **env_extra)
    out.mkdir(parents=True, exist_ok=True)
    code, log = torch_port_launch.run_launcher(
        ["-np", "2", "--start-timeout", "120", sys.executable, WORKER,
         str(out)], cwd=REPO, env=env, timeout=JOB_TIMEOUT)
    ranks = [json.loads((out / f"r{r}.json").read_text())
             for r in range(2) if (out / f"r{r}.json").exists()]
    return code, log, ranks


def check_ranks(ranks, backend):
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["backend"] == backend
        assert r["guarded"] == ["HVD102"]
        assert r["calls_before_the_raise"] == []
        assert r["sum"] == [3.0] * 4
        assert r["out"] == [6.0 * (1 + r["rank"] * 0.5)] * 4
        assert "all_reduce" in r["hoisted_calls"]


def test_rank_guarded_psum_is_refused_on_both_ranks_before_a_collective(
        tmp_path):
    torch_port_launch.build_port_core()
    code, log, ranks = run_job(tmp_path / "job", {"PORT_TEST_DEVICE": "cpu"})
    assert code == 0, log[-4000:]
    check_ranks(ranks, "gloo")

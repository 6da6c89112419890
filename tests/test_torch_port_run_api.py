"""The port's programmatic launch and launcher flags against the JAX
package's, on the CPU: ``horovod_tpu_torch.run`` (lazy, as ``hvd.run`` is)
on 2 gloo workers returns their results by rank and ``run_command`` the
job's exit code; ``runner/cluster.py`` carries a simulated cluster job end
to end (``tests/test_cluster.py::test_cluster_job_end_to_end``'s shape);
``--network-interface``, ``--config-file`` and ``--check-build`` parse to
the JAX launcher's values and worker env."""

import json
import os
import subprocess
import sys

import pytest

import torch_port_launch

from horovod_tpu.runner import launch as jlaunch
from horovod_tpu_torch.runner import cluster as tcluster
from horovod_tpu_torch.runner import launch as tlaunch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_run_worker.py")
JOB_TIMEOUT = 240


def _job_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS="1", HVDTPU_CPU_OPERATIONS="nccl")
    return env


def test_hvd_run_is_lazy_and_is_the_runners():
    code = ("import sys, horovod_tpu_torch as hvd\n"
            "print(any(m.startswith('horovod_tpu_torch.runner') "
            "for m in sys.modules))\n"
            "from horovod_tpu_torch.runner import run\n"
            "print(hvd.run is run)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True"]
    import horovod_tpu_torch
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        horovod_tpu_torch.nope


def test_run_returns_each_ranks_result_and_run_command_its_exit_code(
        monkeypatch):
    import horovod_tpu_torch as hvd
    import torch_port_run_worker as w
    for k in [k for k in os.environ if k.startswith(("HVDTPU_", "MASTER_"))]:
        monkeypatch.delenv(k)
    env = _job_env()
    results = hvd.run(w.allreduce_rank, args=(2.0,), kwargs={"offset": 1.0},
                      num_proc=2, env=env, start_timeout=60)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["size"] == 2 for r in results)
    assert [r["local_rank"] for r in results] == [0, 1]
    for r in results:
        assert r["sum"] == [(1 * 2.0 + 1.0) + (2 * 2.0 + 1.0)] * 3
    from horovod_tpu_torch.runner import run_command
    assert run_command([sys.executable, "-c", "import sys; sys.exit(0)"],
                       num_proc=2, env=env) == 0
    assert run_command([sys.executable, "-c",
                        "import os, sys; "
                        "sys.exit(3 if os.environ['HVDTPU_RANK'] == '1' "
                        "else 0)"], num_proc=2, env=env) == 3
    with pytest.raises(RuntimeError, match="exit code"):
        hvd.run(w.allreduce_rank, args=("not a number",), num_proc=1,
                env=env, start_timeout=60)


def test_cluster_job_end_to_end():
    torch_port_launch.build_port_core()
    job = tcluster.ClusterJob(num_proc=2, start_timeout=60,
                              addr="127.0.0.1")
    try:
        num, addr, port, token, timeout = job.task_args()
        assert (num, addr, timeout) == (2, "127.0.0.1", 60)
        task_args = json.dumps([num, addr, port, token, timeout])
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(rank), task_args], env=_job_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(2)]
        for rank, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=JOB_TIMEOUT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            text = out.decode(errors="replace")
            assert p.returncode == 0, f"rank {rank}:\n{text[-3000:]}"
            assert f"rank {rank}/2: CLUSTER-TASK OK" in text
    finally:
        job.shutdown()


def test_local_driver_ip_falls_back_to_loopback(monkeypatch):
    monkeypatch.setattr(tcluster, "_local_ip_towards",
                        lambda addr, port: "10.1.2.3")
    assert tcluster.local_driver_ip() == "10.1.2.3"

    def unroutable(addr, port):
        raise OSError("network is unreachable")
    monkeypatch.setattr(tcluster, "_local_ip_towards", unroutable)
    assert tcluster.local_driver_ip() == "127.0.0.1"


# -- the launcher's flags ------------------------------------------------------

def _parsed(mod, argv):
    try:
        args = mod.parse_args(argv)
    except SystemExit as e:
        return ("exit", str(e.code)[:40])
    return {k: v for k, v in vars(args).items()}, mod._knob_env(args)


def test_network_interface_resolves_like_the_jax_launcher():
    argv = ["-np", "2", "--network-interface", "lo", "python", "x.py"]
    got, want = _parsed(tlaunch, argv), _parsed(jlaunch, argv)
    assert got[0]["network_interface"] == want[0]["network_interface"] == "lo"
    assert tlaunch._iface_addr("lo") == jlaunch._iface_addr("lo") == \
        "127.0.0.1"
    assert tlaunch._iface_addr(None) is None
    with pytest.raises(SystemExit, match="no-such-nic"):
        tlaunch._iface_addr("no-such-nic")


CONFIGS = {
    "knobs": ("fusion-threshold-mb: 4\ncycle_time_ms: 2.5\n"
              "timeline-mark-cycles: yes\nstall-check-disable: 'off'\n"
              "log_level: debug\nmin-np: 1\n", []),
    "cli wins": ("fusion-threshold-mb: 4\ncache-capacity: 7\n",
                 ["--fusion-threshold-mb", "8"]),
    "unknown key": ("not-a-flag: 1\n", []),
    "bad bool": ("autotune: maybe\n", []),
    "bad type": ("cache-capacity: many\n", []),
    "null": ("cycle-time-ms:\n", []),
    "command": ("command: [a]\n", []),
    "not a mapping": ("- 1\n- 2\n", []),
}


@pytest.mark.parametrize("case", list(CONFIGS))
def test_config_file_applies_like_the_jax_launcher(case, tmp_path):
    text, extra = CONFIGS[case]
    path = tmp_path / "job.yaml"
    path.write_text(text)
    argv = ["-np", "2", "--config-file", str(path), *extra, "python", "x.py"]
    got, want = _parsed(tlaunch, argv), _parsed(jlaunch, argv)
    if want[0] == "exit":
        assert got[0] == "exit"
        return
    common = set(got[0]) & set(want[0])
    assert {k: got[0][k] for k in common} == {k: want[0][k] for k in common}
    assert got[1] == want[1]
    if case == "cli wins":
        assert got[1]["HVDTPU_FUSION_THRESHOLD"] == str(8 * 1024 * 1024)
        assert got[1]["HVDTPU_CACHE_CAPACITY"] == "7"


def test_check_build_needs_no_command_and_prints_the_planes():
    assert tlaunch.parse_args(["--check-build"]).check_build
    assert jlaunch.parse_args(["--check-build"]).check_build
    out = subprocess.run([sys.executable, "-m",
                          "horovod_tpu_torch.runner.launch",
                          "--check-build"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for word in ("pytorch", "CUDA", "NCCL", "gloo",
                 "flash_attention kernels", "native core"):
        assert word in out.stdout, word
    assert "[X] gloo" in out.stdout

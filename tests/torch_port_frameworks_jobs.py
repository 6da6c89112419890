"""Two-rank jobs of tests/torch_port_frameworks_worker.py, one of the port
(on its delegated plane over gloo, ``HVDTPU_CPU_OPERATIONS=nccl``) and one
of the JAX package (its TCP plane), started together on the same seeded
inputs, for tests/test_torch_port_frameworks_*_job.py. Each job has a time
limit of its own; at the limit its ranks are killed and the test fails on
the exit codes."""

import json
import os
import subprocess
import sys

import numpy as np

import torch_port_launch

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_frameworks_worker.py")
PACKAGES = ("horovod_tpu_torch", "horovod_tpu")
SIZE = 2
JOB_TIMEOUT = 240
#: fp32 weights after 3 steps: the two packages differ only in how their
#: planes sum two ranks' gradients.
WEIGHT_ATOL = 1e-6


def _env(pkg, extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.pop("XLA_FLAGS", None)
    env.update(JAX_PLATFORMS="cpu", FRAMEWORKS_PKG=pkg, **extra)
    if pkg == "horovod_tpu_torch":
        env["HVDTPU_CPU_OPERATIONS"] = "nccl"
    return env


def _start(pkg, mode, out, extra):
    rdv = out / "rdv"
    rdv.mkdir(parents=True)
    port = torch_port_launch.free_port()
    procs = []
    for rank in range(SIZE):
        log = open(out / f"log{rank}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, mode, str(rank), str(SIZE), str(rdv),
             str(port), str(out)], env=_env(pkg, extra), stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _finish(procs):
    codes = []
    for p, log in procs:
        try:
            codes.append(p.wait(timeout=JOB_TIMEOUT))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            codes.append(f"timeout after {JOB_TIMEOUT} s")
            p.wait(timeout=60)
        log.close()
    return codes


def run_pair(mode, root, extra=None):
    """Both packages' jobs of ``mode``; {package: {"codes", "logs", "res"
    (per rank: name -> array), "checks" (per rank)}}."""
    torch_port_launch.build_jax_native_library()
    torch_port_launch.build_port_core()
    started = {}
    for pkg in PACKAGES:
        out = root / pkg
        out.mkdir()
        started[pkg] = (out, _start(pkg, mode, out, dict(extra or {})))
    jobs = {}
    for pkg, (out, procs) in started.items():
        codes = _finish(procs)
        job = {"codes": codes,
               "logs": [(out / f"log{r}.txt").read_text()
                        for r in range(SIZE)], "res": [], "checks": []}
        for r in range(SIZE):
            if (out / f"r{r}.json").exists():
                with np.load(out / f"r{r}.npz") as z:
                    job["res"].append(dict(z))
                job["checks"].append(json.loads(
                    (out / f"r{r}.json").read_text()))
        jobs[pkg] = job
    return jobs


def assert_ok(jobs):
    for pkg, job in jobs.items():
        for r, code in enumerate(job["codes"]):
            assert code == 0, (f"{pkg} rank {r}: exit {code}\n"
                               f"{job['logs'][r][-4000:]}")
        assert len(job["res"]) == SIZE, pkg


def assert_weights_agree(jobs):
    """Within a job every rank holds the same weights; across the two
    packages they agree to WEIGHT_ATOL; both moved off the broadcast
    start."""
    port, ref = (jobs[p]["res"] for p in PACKAGES)
    names = sorted(k for k in port[0] if k.startswith("w"))
    assert names and names == sorted(k for k in ref[0] if k.startswith("w"))
    for res in (port, ref):
        for k in names:
            np.testing.assert_array_equal(res[0][k], res[1][k])
    for k in names:
        assert port[0][k].dtype == np.float32
        np.testing.assert_allclose(port[0][k], ref[0][k], rtol=0,
                                   atol=WEIGHT_ATOL)

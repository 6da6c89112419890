"""Launcher jobs of the port on the CPU, 2 and 3 ranks, on both of its CPU
planes: ``tcp-native`` (the native core negotiates and its TCP ring moves
the bytes) and the delegated plane over gloo (``HVDTPU_CPU_OPERATIONS=
nccl``: the native core negotiates, gloo executes, the code the card runs
with NCCL). Workers: tests/torch_port_spmd_worker.py, and
tests/torch_port_jax_spmd_worker.py for the JAX package's TCP plane.

Each job shows: named allreduces submitted in rank-dependent orders give
the numpy sum and the JAX package's outputs; the grad-hook optimizer with
rank-dependent backward orders equals the full-batch step; a duplicate
in-flight name raises; a rank that never submits a name draws a stall
warning naming it, then ``HorovodInternalError``; a killed rank fails the
survivors' next collective (tcp-native); each rank's native timeline
parses and holds the JAX package's event names. The jobs of one wave run
at once; no check reads a wall clock.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_port_launch

HERE = os.path.dirname(os.path.abspath(__file__))
PLANES = {"tcp": {}, "gloo": {"HVDTPU_CPU_OPERATIONS": "nccl"}}
SIZES = (2, 3)
TIMEOUT = 400


def _env(extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def _start(script, args_of, size, out, extra):
    rdv = out / "rdv"
    rdv.mkdir(parents=True)
    port = torch_port_launch.free_port()
    procs = []
    for rank in range(size):
        args = args_of(rank, str(rdv), port, str(out))
        log = open(out / f"log{rank}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, script), *args],
            env=_env(extra), stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _finish(procs):
    codes = []
    for p, log in procs:
        try:
            codes.append(p.wait(timeout=TIMEOUT))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            codes.append(p.wait(timeout=60))
        log.close()
    return codes


def _port_job(mode, plane, size, out, extra=()):
    return _start("torch_port_spmd_worker.py",
                  lambda r, rdv, port, o: [mode, str(r), str(size), rdv,
                                           str(port), o],
                  size, out, {**PLANES[plane], **dict(extra)})


def _read(out, size, codes):
    logs = [(out / f"log{r}.txt").read_text() for r in range(size)]
    res = {}
    for r in range(size):
        path = out / f"r{r}.json"
        res[r] = json.loads(path.read_text()) if path.exists() else None
    return {"codes": codes, "logs": logs, "res": res, "out": out}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    # The JAX package's workers build its native library when it is
    # missing (a fresh checkout): build it once here, before they start.
    torch_port_launch.build_jax_native_library()
    root = tmp_path_factory.mktemp("spmd")
    stall_env = {"HVDTPU_STALL_CHECK_TIME_SECONDS": "1",
                 "HVDTPU_STALL_SHUTDOWN_TIME_SECONDS": "3"}
    waves = [
        {**{("main", p, n): (lambda o, p=p, n=n: _port_job("main", p, n, o))
            for p in PLANES for n in SIZES},
         **{("jax", "tcp", n): (lambda o, n=n: _start(
             "torch_port_jax_spmd_worker.py",
             lambda r, rdv, port, o2: [str(r), str(n), rdv, o2], n, o, {}))
            for n in SIZES}},
        {**{("stall", p, n): (lambda o, p=p, n=n: _port_job(
            "stall", p, n, o, stall_env)) for p in PLANES for n in SIZES},
         ("kill", "tcp", 3): lambda o: _port_job("kill", "tcp", 3, o)},
    ]
    done = {}
    for wave in waves:
        started = {}
        for key, start in wave.items():
            out = root / "-".join(map(str, key))
            started[key] = (out, start(out))
        for key, (out, procs) in started.items():
            done[key] = _read(out, key[2], _finish(procs))
    return done


def _ok(job, ranks=None):
    for r in ranks if ranks is not None else range(len(job["codes"])):
        assert job["codes"][r] == 0 and job["res"][r] is not None, \
            f"rank {r} exit {job['codes'][r]}:\n{job['logs'][r][-3000:]}"
    return job["res"]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_rank_order_allreduce_equals_the_numpy_sum(jobs, plane, size):
    res = _ok(jobs["main", plane, size])
    assert all(res[r]["rank_order"] for r in range(size))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_rank_order_allreduce_equals_the_jax_package(jobs, plane, size):
    _ok(jobs["main", plane, size])
    _ok(jobs["jax", "tcp", size])
    for r in range(size):
        got = np.load(jobs["main", plane, size]["out"] / f"r{r}.npz")
        want = np.load(jobs["jax", "tcp", size]["out"] / f"r{r}.npz")
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            assert got[name].dtype == want[name].dtype
            # Float sums depend on where a tensor fell in a fused ring
            # buffer, which depends on arrival times: equal to rounding.
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_hook_optimizer_with_rank_dependent_backward_order(jobs, plane,
                                                           size):
    res = _ok(jobs["main", plane, size])
    orders = [res[r]["hook_order"] for r in range(size)]
    assert orders[0] != orders[1]            # the hooks fired in other orders
    assert sorted(orders[0]) == sorted(orders[1])
    assert all(res[r]["hook_step_equals_full_batch"] for r in range(size))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_duplicate_in_flight_name_is_caught(jobs, plane, size):
    res = _ok(jobs["main", plane, size])
    assert all(res[r]["duplicate"] for r in range(size))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_stalled_name_warns_then_fails(jobs, plane, size):
    job = jobs["stall", plane, size]
    res = _ok(job)
    missing = ", ".join(str(r) for r in range(1, size))
    assert all(res[r]["warm"] and res[r]["post"] for r in range(size))
    err = res[0]["stall_error"]
    assert err.startswith("StalledTensorError: STALLED: tensor 'lonely'"), err
    assert f"missing ranks [{missing}]" in err
    assert "Tensor 'lonely' stalled for" in job["logs"][0]
    assert f"waiting on ranks [{missing}]" in job["logs"][0]


def test_killed_rank_fails_the_survivors(jobs):
    job = jobs["kill", "tcp", 3]
    assert job["codes"][2] == 17
    res = _ok(job, ranks=[0, 1])
    for r in (0, 1):
        assert res[r]["warm"]
        assert res[r]["killed_rank_error"] == "HorovodInternalError"


def _names(path):
    """Event names of a Chrome trace, begin events only, leaving out the
    fusion copy (whether two names fuse depends on when they arrived)."""
    events = json.loads(path.read_text())
    return {e["name"] for e in events if e["ph"] == "B"} - {
        "MEMCPY_IN_FUSION_BUFFER"}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_native_timelines_hold_the_jax_package_event_names(jobs, plane,
                                                           size):
    _ok(jobs["main", plane, size])
    _ok(jobs["jax", "tcp", size])
    for r in range(size):
        want = _names(jobs["jax", "tcp", size]["out"] / f"tl.json.rank{r}")
        got = _names(jobs["main", plane, size]["out"] / f"tl.json.rank{r}")
        assert {"NEGOTIATE", "EXEC", "RING_ALLREDUCE"} <= want
        if plane == "tcp":
            assert got == want
            continue
        # Delegated: the core negotiates every name and runs the barrier;
        # the data spans are the Python plane's, per tensor name.
        assert {"NEGOTIATE", "EXEC"} <= got <= want
        events = json.loads((jobs["main", plane, size]["out"]
                             / f"tl.json.py.rank{r}").read_text())
        spans = {(e["name"], e["args"]["tensor"]) for e in events
                 if e["ph"] == "B"}
        for name in [f"order.{i}" for i in range(8)] + ["grad.a.weight"]:
            assert ("NEGOTIATE_ALLREDUCE", name) in spans
            assert ("ALLREDUCE", name) in spans

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

The ``reduce`` jobs drive the gradient-reduction options on both planes
and hold them to the JAX package's job of the same inputs and to numpy:
tcp-native int8/fp8 with error feedback over two steps (equal to the JAX
package's within 1e-6 absolute: the same bytes on the wire, float32 sums
in another order), the delegated plane's catch-all int8 (equal to
``quantized_allreduce_plain`` of the stacked inputs within one
quantization step of each block), Adasum at 2 ranks single and grouped
(the float64 VHDD oracle within 1e-5 relative; the JAX package's within
1e-6) and its 3-rank reject, sparse gathers with ragged row counts
(the dense sum within 1e-6; int8 rows within one step of each row), and
the binding's ``DistributedOptimizer`` with fp16 on the wire (the JAX
package's binding within 1e-3, fp16's step at these magnitudes), and
SparseAdam behind both optimizers on sparse embedding gradients (the step
on the averaged gradient within 1e-6).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_port_launch
from torch_port_spmd_worker import (Q_N, REDUCE_ENV, SP_ROWS, SP_W,
                                    ad_value, q_value, sp_value)

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
        {**{("reduce", p, n): (lambda o, p=p, n=n: _port_job(
            "reduce", p, n, o, REDUCE_ENV[p])) for p in PLANES
            for n in SIZES},
         **{("jax-reduce", "tcp", n): (lambda o, n=n: _start(
             "torch_port_jax_spmd_worker.py",
             lambda r, rdv, port, o2: [str(r), str(n), rdv, o2, "reduce"],
             n, o, {})) for n in SIZES}},
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


# -- the gradient-reduction options (the ``reduce`` jobs) -------------------
def _reduce_results(jobs, plane, size):
    _ok(jobs["reduce", plane, size])
    return [dict(np.load(jobs["reduce", plane, size]["out"] / f"r{r}.npz"))
            for r in range(size)]


def _jax_reduce_results(jobs, size):
    _ok(jobs["jax-reduce", "tcp", size])
    return [dict(np.load(jobs["jax-reduce", "tcp", size]["out"]
                         / f"r{r}.npz")) for r in range(size)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_tcp_quantized_allreduce_with_error_feedback_equals_the_jax_package(
        jobs, codec, size):
    got = _reduce_results(jobs, "tcp", size)
    want = _jax_reduce_results(jobs, size)
    res = jobs["reduce", "tcp", size]["res"]
    for r in range(size):
        assert res[r]["residual_names"] == ["q.fp8", "q.int8"]
        for step in (0, 1):
            key = f"q_{codec}_{step}"
            np.testing.assert_allclose(got[r][key], want[r][key], rtol=0,
                                       atol=1e-6)
            ins = np.stack([q_value(k, s, codec) for k in range(size)
                            for s in range(step + 1)])
            # Quantized, not exact: within a few round-trip errors of each
            # block (each rank's, the sum's, step 0's residual carried).
            rel = 1 / 254 if codec == "int8" else 1 / 16
            blockmax = np.repeat(np.abs(np.pad(
                ins, ((0, 0), (0, 48)))).reshape(len(ins), -1, 256).max(
                    axis=(0, 2)), 256)[:Q_N]
            exact = sum(q_value(k, step, codec) for k in range(size))
            err = np.abs(got[r][key] - exact)
            assert err.max() > 0
            assert np.all(err <= 3 * size * blockmax * rel + 1e-7)


def check_catch_all(got, size, wire):
    """Every rank's q_* results (both per-call markers ignored) equal
    ``quantized_allreduce_plain`` of the stacked inputs with the catch-all
    codec ``wire``, within one quantization step of each block."""
    import torch
    from horovod_tpu_torch.compression import codecs
    qmax = codecs.get_codec(wire).qmax
    for codec in ("int8", "fp8"):
        for step in (0, 1):
            stacked = torch.from_numpy(np.stack(
                [q_value(k, step, codec) for k in range(size)]))
            want = codecs.quantized_allreduce_plain(
                stacked, wire, 256, average=False).numpy()
            padded = codecs.padded_len(want.size, size, 256)
            step_of = np.repeat(
                np.abs(np.pad(want, (0, padded - want.size))).reshape(
                    -1, 256).max(1) / qmax, 256)[:want.size]
            if wire == "fp8":
                step_of = np.maximum(step_of, np.abs(want) / 8)
            for r in range(size):
                key = f"q_{codec}_{step}"
                assert np.all(np.abs(got[r][key] - want) <= step_of + 1e-7)


def check_adasum(got, size):
    """Adasum single and grouped against the float64 VHDD oracle."""
    from horovod_tpu_torch.ops import adasum
    for i, key in ((0, "ad_0"), (0, "ad_g0"), (1, "ad_g1")):
        oracle = adasum.adasum_vhdd_np([ad_value(k, i) for k in range(size)])
        for r in range(size):
            np.testing.assert_allclose(got[r][key], oracle, rtol=1e-5,
                                       atol=1e-6)


def dense_sparse_sum(size):
    """The dense sum of every rank's slices, and each row's largest
    magnitude over the ranks."""
    dense = np.zeros((SP_ROWS, SP_W), np.float64)
    rowmax = np.zeros(SP_ROWS)
    for k in range(size):
        idx, vals = sp_value(k)
        np.add.at(dense, idx, vals)
        np.maximum.at(rowmax, idx, np.abs(vals).max(1))
    return dense, rowmax


@pytest.mark.parametrize("size", SIZES)
def test_delegated_catch_all_int8_equals_the_plain_pipeline(jobs, size):
    check_catch_all(_reduce_results(jobs, "gloo", size), size, "int8")
    assert "ignored on the delegated plane" in \
        jobs["reduce", "gloo", size]["logs"][0]


@pytest.mark.parametrize("plane", PLANES)
def test_adasum_at_two_ranks_equals_vhdd_and_the_jax_package(jobs, plane):
    got = _reduce_results(jobs, plane, 2)
    want = _jax_reduce_results(jobs, 2)
    check_adasum(got, 2)
    for key in ("ad_0", "ad_g0", "ad_g1"):
        for r in range(2):
            np.testing.assert_allclose(got[r][key], want[r][key],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("plane", PLANES)
def test_adasum_at_three_ranks_raises_as_in_the_jax_package(jobs, plane):
    _ok(jobs["reduce", plane, 3])
    _ok(jobs["jax-reduce", "tcp", 3])
    for r in range(3):
        err = jobs["reduce", plane, 3]["res"][r]["adasum_error"]
        want = jobs["jax-reduce", "tcp", 3]["res"][r]["adasum_error"]
        assert err and "power-of-two" in err and "power-of-two" in want


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_sparse_gathers_equal_the_dense_sum(jobs, plane, size):
    got = _reduce_results(jobs, plane, size)
    want = _jax_reduce_results(jobs, size)
    res = jobs["reduce", plane, size]["res"]
    dense, rowmax = dense_sparse_sum(size)
    for r in range(size):
        assert res[r]["sparse_paths"]["gather"] == 4   # 3 ops + binding
        assert res[r]["sp_bind_is_sparse"]
        np.testing.assert_allclose(got[r]["sp_sum"], dense, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got[r]["sp_avg"], dense / size,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[r]["sp_bind"], dense / size,
                                   rtol=1e-6, atol=1e-6)
        for key in ("sp_sum", "sp_avg", "sp_bind"):
            np.testing.assert_allclose(got[r][key], want[r][key],
                                       rtol=1e-6, atol=1e-6)
        if plane == "tcp":   # int8 rows: within one step of each row
            err = np.abs(got[r]["spq_rows"] - dense).max(1)
            assert np.all(err <= size * rowmax / 254 + 1e-6)
            assert err.max() > 0
            np.testing.assert_allclose(got[r]["spq_rows"],
                                       want[r]["spq_rows"], rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(got[r]["spq_rows"], dense,
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_sparse_adam_steps_on_the_averaged_sparse_gradient(jobs, plane,
                                                           size):
    # Both optimizers route an embedding's sparse gradient through the
    # sparse plane and write it back sparse: SparseAdam's step equals the
    # one on the average of every rank's gradient (1e-6).
    _ok(jobs["reduce", plane, size])
    for r in range(size):
        res = jobs["reduce", plane, size]["res"][r]
        assert res["sparse_train_equal"] and res["sparse_hook_equal"]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_fp16_hook_optimizer_equals_the_jax_package_binding(jobs, plane,
                                                            size):
    got = _reduce_results(jobs, plane, size)
    want = _jax_reduce_results(jobs, size)
    keys = [k for k in want[0] if k.startswith("fp16_")]
    assert len(keys) == 4
    for r in range(size):
        for k in keys:
            np.testing.assert_allclose(got[r][k], want[r][k], rtol=1e-3,
                                       atol=1e-3)

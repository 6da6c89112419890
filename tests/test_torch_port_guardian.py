"""The port's data-plane guardian (``horovod_tpu_torch/guardian.py``), its
coordinator hooks, the exception taxonomy and the per-call wire codec on
the delegated plane, against the JAX package's (``horovod_tpu/guardian.py``,
``tests/test_guardian.py``), on the CPU.

Single process: every exception class both packages define has the same
base classes; ``entry_digest``/``render_digest`` equal the JAX package's
for the same allreduce, grouped, allgather, broadcast, sparse and
codec-stamped entries (reducescatter: every field but ``shapes``, since the
JAX package's input is stacked ``(n, rows, ...)`` and the port's is this
rank's ``(rows, ...)``); ``compare_digests`` gives the same divergences and
the ``Watchdog`` the same diagnostics for the same in-flight views; ZeRO's
``leg_digests`` equal the JAX package's for the same leaves, world size and
bucket bytes; with both knobs unset the coordinator holds ``None`` and a
submission touches no board; the watchdog's abort and ``run_fn``'s
conversion of it.

Launcher jobs on the CPU (worker: tests/torch_port_guardian_worker.py;
the launcher's KV store is the board), all of one wave at once:

- the per-call wire codec on the gloo-delegated plane (``HVDTPU_COMPRESSION``
  unset, 2 ranks): the eager int8 allreduce and the optimizer's int8
  gradients equal ``quantized_allreduce_plain`` of the same stacked rows
  (step 2 fed step 1's residuals) within 1e-6 absolute (the same bytes on
  the wire; float32 sums in rank order on both sides); each residual is
  ``(g + e) - dq(q(g + e))`` within 1e-6; a response fusing int8, fp8 and
  uncompressed entries equals each executed alone (1e-6);
- a rank that submits another shape: ``CollectiveMismatchError`` on every
  rank naming ``shapes`` and the rank (2 and 3 ranks);
- a rank that stops submitting: ``CollectiveAbortError`` on the submitter
  within the timeout plus two scan periods, and the job goes on (2 and 3);
- a rank frozen with SIGSTOP (its sockets open, so the others' native
  cycle blocks on it): ``CollectiveAbortError`` on every other rank within
  the timeout plus two scan periods of the freeze, and they shut down;
- under ``hvd.elastic.run`` with the watchdog off and
  ``HVDTPU_STALL_SHUTDOWN_TIME_SECONDS=3``, the same ends with
  ``StalledTensorError`` after one attempt; with
  ``HVDTPU_COLLECTIVE_TIMEOUT=2`` it restores, resets and finishes.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
import torch_port_launch
from horovod_tpu_torch import guardian as tguardian
from horovod_tpu_torch.coordinator import TensorEntry as TEntry
from horovod_tpu_torch.ops import reduce_ops as treduce
from torch_port_guardian_worker import C_N, M_N, c_value

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_guardian_worker.py")
JOB_TIMEOUT = 300


@pytest.fixture(autouse=True)
def _fresh_boards():
    from horovod_tpu import guardian as jguardian
    jguardian._reset_inproc()
    tguardian._reset_inproc()
    yield
    jguardian._reset_inproc()
    tguardian._reset_inproc()


# ==========================================================================
# Exceptions
# ==========================================================================

def _exception_classes(module):
    return {name: cls for name, cls in vars(module).items()
            if inspect.isclass(cls) and issubclass(cls, BaseException)
            and cls.__module__ == module.__name__}


def test_exception_bases_match_the_jax_package():
    from horovod_tpu import exceptions as jexc
    from horovod_tpu_torch import exceptions as texc
    jcls, tcls = _exception_classes(jexc), _exception_classes(texc)
    shared = sorted(set(jcls) & set(tcls))
    assert {"StalledTensorError", "CollectiveAbortError",
            "CollectiveMismatchError", "CheckpointCorruptError",
            "HorovodInternalError"} <= set(shared)
    for name in shared:
        assert [b.__name__ for b in tcls[name].__mro__] == \
            [b.__name__ for b in jcls[name].__mro__], name
    err = texc.CollectiveMismatchError("m", [(1, "shapes", [5], [4])])
    assert err.divergences == [(1, "shapes", [5], [4])]


# ==========================================================================
# Digests
# ==========================================================================

class _PS:
    process_set_id = 0
    ranks = [0, 1]

    def rank(self):
        return 1


class _Sparse:
    values_dtype = "float32"
    index_dtype = "int64"
    dense_shape = (40, 6)
    codec = "int8"


def _pair(name, kind, shapes, dtype=np.float32, op=treduce.Sum, **kw):
    """The same entry in both packages, from the same numpy arrays."""
    from horovod_tpu.coordinator import TensorEntry as JEntry
    arrays = [np.ones(s, dtype) for s in shapes]
    sparse = kw.pop("sparse", None)
    if sparse is not None:
        # A sparse gather entry of the JAX package (the port's sparse
        # gathers are plain ragged allgathers): both digests read the same
        # attributes.
        from types import SimpleNamespace
        stub = SimpleNamespace(name=name, kind=kind, op=op, prescale=None,
                               postscale=None, root_rank=None, codec=None,
                               process_set=_PS(), sparse=sparse)
        return stub, stub
    j = JEntry(name, kind, arrays, _PS(), op=op, **kw)
    t = TEntry(name, kind, [torch.from_numpy(a) for a in arrays], _PS(),
               op=op, **kw)
    return j, t


CASES = {
    "allreduce": lambda: _pair("a", "allreduce", [(2, 3)], prescale=0.5,
                               postscale=2.0),
    "grouped": lambda: _pair("g", "allreduce", [(4,), (3, 5)],
                             op=treduce.Average),
    "allgather": lambda: _pair("ag", "allgather", [(3, 5)], op=None),
    "broadcast": lambda: _pair("b", "broadcast", [(7,)], dtype=np.int64,
                               op=None, root_rank=1),
    "bfloat16": lambda: _pair("bf", "allreduce", [(8,)]),
    "sparse": lambda: _pair("sp", "allgather", [(3,)], op=treduce.Sum,
                            sparse=_Sparse()),
    "codec": lambda: _pair("c", "allreduce", [(2048,)],
                           codec=("int8", 256)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_digest_equals_the_jax_package(case):
    from horovod_tpu import guardian as jguardian
    j, t = CASES[case]()
    if case == "bfloat16":
        import jax.numpy as jnp
        j.arrays = [jnp.ones((8,), jnp.bfloat16)]
        t.tensors = [torch.ones(8, dtype=torch.bfloat16)]
    want = jguardian.entry_digest(j)
    got = tguardian.entry_digest(t)
    assert got == want
    assert tguardian.render_digest(got) == jguardian.render_digest(want)


def test_reducescatter_digest_equals_the_jax_package_but_shapes():
    from horovod_tpu import guardian as jguardian
    from horovod_tpu.coordinator import TensorEntry as JEntry
    # The JAX package's stacked (n, rows, w) against the port's (rows, w).
    j = JEntry("rs", "reducescatter", [np.ones((2, 6, 5), np.float32)],
               _PS(), op=treduce.Sum)
    t = TEntry("rs", "reducescatter", [torch.ones(6, 5)], _PS(),
               op=treduce.Sum)
    want, got = jguardian.entry_digest(j), tguardian.entry_digest(t)
    assert got["shard_shape"] == want["shard_shape"] == [[3, 5]]
    assert {k: v for k, v in got.items() if k != "shapes"} == \
        {k: v for k, v in want.items() if k != "shapes"}


def test_a_ragged_allgather_leaves_dim_zero_out():
    t = TEntry("r", "allgather", [torch.ones(3, 5)], _PS(), uneven=True)
    d = tguardian.entry_digest(t)
    assert d["shapes"] == [[None, 5]] and d["shard_shape"] is None
    assert d["shard_index"] == 1


def test_compare_digests_equals_the_jax_package():
    from horovod_tpu import guardian as jguardian
    mine = tguardian.entry_digest(CASES["allreduce"]()[1])
    theirs = {0: dict(mine),
              1: dict(mine, shapes=[[2, 4]], dtype="float16"),
              2: dict(mine, shard_index=1), 3: {"malformed": "x"}}
    want = jguardian.compare_digests(mine, theirs)
    assert tguardian.compare_digests(mine, theirs) == want
    assert (1, "shapes", [[2, 4]], [[2, 3]]) in want


def _guards(size=2, timeout_s=0.3):
    return [tguardian.ConsistencyGuard(r, size, tguardian.InProcBoard("t"),
                                       timeout_s=timeout_s, poll_s=0.005)
            for r in range(size)]


def test_guard_mismatch_names_the_rank_and_field():
    from horovod_tpu_torch.exceptions import CollectiveMismatchError
    g0, g1 = _guards()
    e0 = TEntry("x", "allreduce", [torch.ones(4)], _PS(), op=treduce.Sum)
    e1 = TEntry("x", "allreduce", [torch.ones(5)], _PS(), op=treduce.Sum)
    g0.on_submit(e0)
    g1.on_submit(e1)
    with pytest.raises(CollectiveMismatchError, match="rank") as info:
        g0.verify(e0)
    assert info.value.divergences == [(1, "shapes", [[5]], [[4]])]


def test_guard_raises_when_a_peer_publishes_nothing():
    from horovod_tpu_torch.exceptions import CollectiveAbortError
    g0, _ = _guards()
    e0 = TEntry("x", "allreduce", [torch.ones(4)], _PS(), op=treduce.Sum)
    g0.on_submit(e0)
    with pytest.raises(CollectiveAbortError, match=r"rank\(s\) \[1\]"):
        g0.verify(e0)


def test_guard_samples_every_nth_submission():
    g = tguardian.ConsistencyGuard(0, 2, tguardian.InProcBoard("t"),
                                   every=3)
    armed = []
    for i in range(7):
        e = TEntry(f"n{i}", "allreduce", [torch.ones(2)], _PS())
        g.on_submit(e)
        armed.append(e.guard_token is not None)
    assert armed == [False, False, True, False, False, True, False]


def test_watchdog_diagnostics_equal_the_jax_package():
    from horovod_tpu import guardian as jguardian
    views = {1: ["a"], 2: ["a", "b"]}
    got = {}
    for pkg, mod in (("jax", jguardian), ("port", tguardian)):
        mod._reset_inproc()
        for r, names in views.items():
            mod.Watchdog(r, 4, 5.0, board=mod.InProcBoard("t")).observe(
                names, [], 0.0)
        w0 = mod.Watchdog(0, 4, 5.0, board=mod.InProcBoard("t"))
        missing, abort = w0.observe(["a", "b"], [("a", 9.0), ("b", 9.0)],
                                    0.0)
        mod.Watchdog(3, 4, 5.0, board=mod.InProcBoard("t")).post_abort(
            "diag")
        _, abort2 = w0.observe(["a", "b"], [("b", 9.0)], 0.0)
        got[pkg] = (missing, abort, abort2, w0.describe_missing("a"),
                    w0.describe_missing("b"), w0.should_abort(6.0),
                    w0.should_abort(4.0))
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"a": ["3?"], "b": [1, "3?"]}


def test_leg_digests_equal_the_jax_package():
    import jax
    import optax
    from jax.sharding import Mesh
    from horovod_tpu.ops import zero as jzero
    from horovod_tpu_torch.ops import zero as tzero
    from torch_port_zero_worker import jax_params
    leaves = list(jax_params().values())
    for n, budget, codec in ((2, 1 << 24, None), (3, 256, None),
                             (2, 256, "int8"), (4, 1 << 24, "fp16")):
        mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
        jrt = jzero.ZeroRuntime(optax.sgd(0.1), mesh, "hvd",
                                bucket_bytes=budget, codec=codec)
        import jax.numpy as jnp
        jrt.ensure_plan({k: jnp.asarray(v) for k, v in
                         jax_params().items()})
        trt = tzero.ZeroRuntime(torch.optim.SGD(
            [torch.nn.Parameter(torch.from_numpy(v)) for v in leaves],
            lr=0.1), bucket_bytes=budget, codec=codec)
        trt.plan = tzero.plan_zero([torch.from_numpy(v) for v in leaves],
                                   n, budget, block=trt.block or 1)
        for rank in range(n):
            assert trt.leg_digests(rank) == jrt.leg_digests(rank), \
                (n, budget, codec, rank)


def test_plan_check_names_a_divergent_bucket_budget():
    from horovod_tpu_torch.exceptions import CollectiveMismatchError
    from horovod_tpu_torch.ops import zero as tzero
    from torch_port_zero_worker import jax_params
    leaves = [torch.from_numpy(v) for v in jax_params().values()]
    board = tguardian.InProcBoard("z")
    rts = []
    for rank, budget in ((0, 256), (1, 400)):
        rt = tzero.ZeroRuntime(torch.optim.SGD(
            [torch.nn.Parameter(v) for v in leaves], lr=0.1),
            bucket_bytes=budget)
        rt.plan = tzero.plan_zero(leaves, 2, budget)
        rts.append(rt)
        rt_digests = rt.leg_digests(rank)
        for leg, d in rt_digests.items():
            board.put(f"zero.plan.{leg}.{rank}", tguardian.render_digest(d))
    with pytest.raises(CollectiveMismatchError, match="shapes"):
        rts[0].verify_plan_consistency(board=board, rank=0, size=2,
                                       timeout_s=0.2)


# ==========================================================================
# The coordinator's hooks (one process)
# ==========================================================================

@pytest.fixture
def port():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def test_disabled_guardian_touches_no_board(port, monkeypatch):
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.runner import http_client
    calls = []
    for verb in ("put_kv", "get_kv", "delete_kv"):
        monkeypatch.setattr(http_client, verb,
                            lambda *a, _v=verb, **k: calls.append(_v))
    for knob in ("HVDTPU_CONSISTENCY_CHECK", "HVDTPU_COLLECTIVE_TIMEOUT"):
        assert os.environ.get(knob) is None
    coord = basics.runtime().coordinator
    assert coord._guardian is None and coord._watchdog is None
    out = thvd.allreduce(torch.ones(4), op=thvd.Sum, name="guard_off")
    assert torch.equal(out, torch.ones(4))
    e = TEntry("tok", "allreduce", [torch.ones(2)],
               thvd.global_process_set)
    coord.submit(e)
    e.handle.wait(30)
    assert e.guard_token is None
    assert calls == [] and tguardian._INPROC_TABLE == {}


def test_factories_respect_the_knobs(port, monkeypatch):
    from horovod_tpu_torch import basics
    rt = basics.runtime()
    assert tguardian.make_guard(rt) is None
    assert tguardian.make_watchdog(rt) is None
    monkeypatch.setenv("HVDTPU_COLLECTIVE_TIMEOUT", "5")
    wd = tguardian.make_watchdog(rt)
    assert wd is not None and wd.timeout_s == 5.0 and wd.board is None
    # One process submits for every rank: nothing to compare.
    monkeypatch.setenv("HVDTPU_CONSISTENCY_CHECK", "1")
    assert tguardian.make_guard(rt) is None


def test_watchdog_abort_fails_every_inflight_handle(port, monkeypatch):
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.coordinator import Coordinator
    from horovod_tpu_torch.exceptions import CollectiveAbortError
    monkeypatch.setenv("HVDTPU_COLLECTIVE_TIMEOUT", "3")
    coord = Coordinator(basics.runtime())
    coord._running = True   # driven by hand: no cycle thread
    assert coord._stall_scan_period == 0.75
    assert coord._stall_observe_s == 1.5
    e = TEntry("ghost", "allreduce", [torch.ones(2)],
               thvd.global_process_set)
    coord.submit(e)
    t0 = e.enqueue_time
    coord._check_stalls(now=t0 + 1.0)
    assert not e.handle.poll()
    coord._check_stalls(now=t0 + 3.5)
    with pytest.raises(CollectiveAbortError, match="ghost"):
        e.handle.wait(0)
    assert coord._queue == [] and coord._pending_names == {}


def _fake_state(events):
    from horovod_tpu_torch.elastic import State

    class FakeState(State):
        def save(self):
            events.append("save")

        def restore(self):
            events.append("restore")

        def sync(self):
            events.append("sync")

        def check_host_updates(self):
            pass
    return FakeState()


def test_run_fn_turns_an_abort_into_restore_and_reset():
    from horovod_tpu_torch.elastic import run_fn
    from horovod_tpu_torch.exceptions import CollectiveAbortError
    events, attempts = [], []

    def func(state):
        attempts.append(1)
        if len(attempts) == 1:
            raise CollectiveAbortError("watchdog abort: rank 1 missing")
        return "recovered"

    wrapped = run_fn(func, reset=lambda: events.append("reset"))
    assert wrapped(_fake_state(events)) == "recovered"
    assert events == ["sync", "restore", "reset", "sync"]


@pytest.mark.parametrize("error", ["CollectiveMismatchError",
                                   "StalledTensorError"])
def test_run_fn_surfaces_program_bugs(error):
    from horovod_tpu_torch import exceptions
    from horovod_tpu_torch.elastic import run_fn
    events = []

    def func(state):
        raise getattr(exceptions, error)("rank 1 diverged")

    with pytest.raises(getattr(exceptions, error)):
        run_fn(func, reset=lambda: events.append("reset"))(
            _fake_state(events))
    assert events == ["sync"]


# ==========================================================================
# Launcher jobs
# ==========================================================================

def _env(extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               HVDTPU_CPU_OPERATIONS="nccl",
               **{k: str(v) for k, v in extra.items()})
    return env


def _discovery(job_dir, slots):
    script = job_dir / "discover.sh"
    script.write_text(f"#!/bin/sh\necho localhost:{slots}\n")
    script.chmod(0o755)
    return str(script)


def start_job(out, mode, size, env, elastic=False, args=()):
    """``mode`` of the worker as a launcher job in ``out``: on the
    gloo-delegated plane, or, for an elastic job, on the tcp-native plane,
    which resets in process (the delegated one exits and respawns)."""
    out.mkdir(parents=True, exist_ok=True)
    flags = ["-np", str(size), "--start-timeout", "120"]
    if elastic:
        flags += ["--min-np", "1", "--max-np", str(size),
                  "--host-discovery-script", _discovery(out, size)]
    log = open(out / "launcher.txt", "w")
    env = _env(env)
    if elastic:
        env.pop("HVDTPU_CPU_OPERATIONS")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *flags,
         sys.executable, WORKER, mode, str(out), *args],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def finish_job(out, proc, log, size, files=None):
    import signal
    try:
        rc = proc.wait(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        rc = "timeout"
    log.close()
    res, arrays = {}, {}
    for r in range(size):
        name = files(r) if files else f"r{r}.json"
        path = out / name
        res[r] = json.loads(path.read_text()) if path.exists() else None
        npz = out / f"r{r}.npz"
        arrays[r] = dict(np.load(npz)) if npz.exists() else None
    return {"rc": rc, "res": res, "arrays": arrays,
            "log": (out / "launcher.txt").read_text()}


def ok(job):
    assert job["rc"] == 0 and all(v is not None
                                  for v in job["res"].values()), \
        job["log"][-6000:]
    return job


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    torch_port_launch.build_port_core()
    root = tmp_path_factory.mktemp("guardian")
    timeout = {"HVDTPU_COLLECTIVE_TIMEOUT": "3"}
    # A cycle time of 100 ms: the three mixed-stamp submissions of a burst
    # are drained together and fuse into one response on every rank.
    wave = {("codec", 2): ("codec", 2, {"HVDTPU_CYCLE_TIME": "100"}, False),
            ("stall_off", 2): ("stall_elastic", 2,
                               {"HVDTPU_STALL_CHECK_TIME_SECONDS": "1",
                                "HVDTPU_STALL_SHUTDOWN_TIME_SECONDS": "3"},
                               True),
            ("stall_on", 2): ("stall_elastic", 2,
                              {"HVDTPU_COLLECTIVE_TIMEOUT": "2"}, True)}
    for n in (2, 3):
        wave[("mismatch", n)] = ("mismatch", n,
                                 {"HVDTPU_CONSISTENCY_CHECK": "1"}, False)
        wave[("silent", n)] = ("silent", n, timeout, False)
        wave[("frozen", n)] = ("frozen", n, timeout, False)
    started = {}
    for key, (mode, n, env, elastic) in wave.items():
        out = root / f"{key[0]}-{n}"
        started[key] = (out, start_job(out, mode, n, env, elastic))
    done = {}
    for key, (out, (proc, log)) in started.items():
        files = None
        if key[0].startswith("stall"):
            files = lambda r: f"wlocalhost_{r}.json"  # noqa: E731
        # An elastic worker's rank may move at a reset: keyed by slot.
        done[key] = finish_job(out, proc, log, key[1], files)
    return done


def _plain(codec, rows, step_rows=None):
    from horovod_tpu_torch.compression import codecs
    return codecs.quantized_allreduce_plain(
        torch.from_numpy(np.stack(rows)), codec, 256,
        average=False).numpy()


def _residual(codec, flat):
    """(g + e) - dq(q(g + e)) of one rank's flat float32 input, blocks laid
    over the input as the pipeline lays them (padded to n * block)."""
    from horovod_tpu_torch.compression import codecs
    c = codecs.get_codec(codec)
    n = 2
    padded = codecs.padded_len(flat.size, n, 256)
    x = torch.from_numpy(np.pad(flat, (0, padded - flat.size)))
    q, s = c.encode(x.view(n, -1), 256)
    return (x.view(n, -1) - c.decode(q, s, 256)).reshape(-1)[:flat.size] \
        .numpy()


def test_delegated_plane_honours_a_per_call_codec(jobs):
    job = ok(jobs["codec", 2])
    got = job["arrays"]
    assert job["res"][0]["backend"] == "gloo-global"
    # Eager int8 over two steps under one name, error feedback carried.
    res = [np.zeros(C_N[0], np.float32) for _ in range(2)]
    for step in (0, 1):
        ins = [c_value(r, step, C_N[0], "e") + res[r] for r in range(2)]
        want = _plain("int8", ins)
        for r in range(2):
            np.testing.assert_allclose(got[r][f"eager_{step}"], want,
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[r][f"eager_res_{step}"],
                                       _residual("int8", ins[r]), rtol=0,
                                       atol=1e-6)
        res = [got[r][f"eager_res_{step}"] for r in range(2)]
        exact = sum(c_value(r, step, C_N[0], "e") for r in range(2))
        assert np.abs(want - exact).max() > 0   # quantized, not exact
    # The optimizer's gradients: one response, one quantized buffer, in
    # the parameters' order; Average divides the float32 sum by n.
    assert job["res"][0]["opt_responses"] == [1, 1]
    flats = [np.concatenate([c_value(r, 0, n, "g") for n in C_N])
             for r in range(2)]
    want = _plain("int8", flats) / 2
    for r in range(2):
        got_flat = np.concatenate([got[r][f"grad_{i}"]
                                   for i in range(len(C_N))])
        np.testing.assert_allclose(got_flat, want, rtol=1e-6, atol=1e-6)
        res_flat = np.concatenate([got[r][f"grad_res_{i}"]
                                   for i in range(len(C_N))])
        np.testing.assert_allclose(res_flat, _residual("int8", flats[r]),
                                   rtol=0, atol=1e-6)


def test_a_response_of_mixed_codecs_equals_each_run_alone(jobs):
    job = ok(jobs["codec", 2])
    # One response, split into the int8 and fp8 quantized buffers and a
    # plain allreduce.
    assert job["res"][0]["mix_responses"] == [1, 2]
    for tag in ("int8", "fp8", "none"):
        rows = [c_value(r, 0, M_N, tag) for r in range(2)]
        want = sum(rows) if tag == "none" else _plain(tag, rows)
        for r in range(2):
            np.testing.assert_allclose(job["arrays"][r][f"mix_{tag}"], want,
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", (2, 3))
def test_a_divergent_shape_fails_every_rank(jobs, size):
    job = ok(jobs["mismatch", size])
    for r in range(size):
        res = job["res"][r]
        assert res["guard_on"]
        assert res["error"] == "CollectiveMismatchError", res
        assert "shapes" in res["message"]
        ranks = {d[0] for d in res["divergences"]}
        fields = {d[1] for d in res["divergences"]}
        assert "shapes" in fields
        assert ranks == ({"0"} | ({"2"} if size == 3 else set())
                         if r == 1 else {"1"}), res["divergences"]
        assert res["post"] == [float(size)] * 4


@pytest.mark.parametrize("size", (2, 3))
def test_a_rank_that_stops_submitting_is_aborted(jobs, size):
    job = ok(jobs["silent", size])
    res = job["res"][0]
    assert res["error"] == "CollectiveAbortError", res
    assert "lonely" in res["message"]
    missing = ", ".join(str(r) for r in range(1, size))
    assert f"never submitted by rank(s) {missing}" in res["message"]
    timeout, scan = 3.0, 0.75
    assert res["elapsed"] <= timeout + 2 * scan, res["elapsed"]
    for r in range(size):
        assert job["res"][r]["post"] == [float(size)] * 4


@pytest.mark.parametrize("size", (2, 3))
def test_a_frozen_peer_is_aborted(jobs, size):
    # The last rank stops (SIGSTOP) with its sockets open: the others'
    # native cycle blocks receiving from it, and only the watchdog's own
    # thread can end the wait.
    # Rank 0's abort shuts its connections down: a survivor whose own
    # watchdog has not fired yet sees the transport fail instead.
    job = jobs["frozen", size]
    for r in range(size - 1):
        res = job["res"][r]
        assert res is not None, job["log"][-6000:]
        assert res["error"] in (("CollectiveAbortError",) if r == 0 else
                                ("CollectiveAbortError",
                                 "HorovodInternalError")), res
        assert res["shutdown_s"] < 30
    assert "after" in job["res"][0]["message"]
    timeout, scan = 3.0, 0.75
    assert 0 < job["res"][0]["freeze_to_error_s"] <= timeout + 2 * scan, \
        job["res"][0]


def test_a_stalled_name_under_elastic_surfaces_after_one_attempt(jobs):
    job = jobs["stall_off", 2]
    r0 = job["res"][0]
    assert r0 is not None, job["log"][-6000:]
    assert r0["final_error"] == "StalledTensorError", r0
    assert r0["attempts"] == 1 and r0["errors"] == ["StalledTensorError"]
    assert "lonely" in r0["final_message"]


def test_the_watchdog_turns_the_stall_into_restore_and_reset(jobs):
    job = ok(jobs["stall_on", 2])
    r0, r1 = job["res"][0], job["res"][1]
    assert r0["final_error"] is None and r1["final_error"] is None, job["res"]
    assert r0["errors"] == ["CollectiveAbortError"]
    assert r0["attempts"] == 2 and r1["attempts"] == 2
    assert r0["result"] == r1["result"] == 2.0
    assert "watchdog abort" in job["log"]

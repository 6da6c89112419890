"""The port's fault injection (``horovod_tpu_torch/chaos/``) against the JAX
package's (``horovod_tpu/chaos/``): the same spec corpus gives equal rules
or the same ``ChaosSpecError``; a plan with the same seed, ``p``, ``n``,
``after`` and ``marker`` fires on the same calls; the catalog and the CLI
print the same. Then the injection sites of the port: the coordinator's
``collective`` point (``fail``, ``stall``, ``mismatch``), the ``worker``
point at a commit, ``checkpoint:corrupt`` and the fallback to the older
step, the ``heartbeat`` and ``kv_*`` points, and a 2-rank elastic job
whose injected collective failure on rank 1 resets it (the counterpart of
tests/test_chaos_matrix.py:586)."""

import os
import subprocess
import sys
import time
import urllib.error

import numpy as np
import pytest
import torch

from horovod_tpu import chaos as jchaos
from horovod_tpu_torch import chaos as tchaos

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_port_launch  # noqa: E402

CORPUS = [
    "kv_get:fail:n=3;kv_put:delay:ms=500;worker:hang:rank=1;"
    "worker:preempt:rank=2:after_commits=3;collective:fail:name=grad_*:once",
    "worker:hang:wid=localhost:1",
    "heartbeat:fail:err=timeout:p=0.5:seed=7",
    "driver:kill:wid=primary:after=40:once",
    "driver:partition:ms=4000:wid=primary:after=20:once:marker=/tmp/m",
    "checkpoint:corrupt:name=step_3",
    "collective:mismatch:name=w;collective:stall:kind=allreduce",
    "backend_submit:stall:name=g*",
    "migrate_out:corrupt:key=r1;transfer:fail:name=held",
    "  ;  kv_wait:exit:code=5 ; ",
    "",
    # malformed
    "kv_get",
    "nowhere:fail",
    "kv_get:explode",
    "kv_get:fail:bogus=1",
    "kv_get:fail:n=x",
    "kv_get:fail:p=abc",
    "kv_get:fail:p=1.5",
    "kv_get:fail:once:n=2",
    "kv_get:fail:err=weird",
    "kv_get:stall",
    "heartbeat:partition",
    "worker:corrupt",
]


def _parse(mod, text):
    try:
        return [(r.source, r.point, r.action, r.describe(),
                 {k: getattr(r, k) for k in r.__slots__})
                for r in mod.parse_spec(text)]
    except mod.ChaosSpecError as exc:
        return ("error", str(exc))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("HVDTPU_CHAOS", raising=False)
    monkeypatch.delenv("HVDTPU_CHAOS_LOG", raising=False)
    tchaos.reset()
    jchaos.reset()
    yield
    tchaos.reset()
    jchaos.reset()


@pytest.mark.parametrize("spec", CORPUS)
def test_spec_parses_as_the_jax_package(spec):
    assert _parse(tchaos, spec) == _parse(jchaos, spec)


def test_catalog_equals_the_jax_package():
    assert tchaos.POINTS == jchaos.POINTS
    assert tchaos.ACTIONS == jchaos.ACTIONS
    assert tchaos.SIGNAL_ACTION_POINTS == jchaos.SIGNAL_ACTION_POINTS
    from horovod_tpu_torch.exceptions import ChaosInjectedError
    assert issubclass(ChaosInjectedError, RuntimeError)


def _firings(mod, spec, calls, point="kv_get", **ctx):
    """Which of ``calls`` injections raise (fail rules) on a fresh plan."""
    plan = mod.Plan(mod.parse_spec(spec))
    fired = []
    for i in range(calls):
        try:
            plan.fire(point, dict(ctx))
        except Exception as exc:  # noqa: BLE001 - the injected failure
            fired.append((i, type(exc).__name__))
    return fired


@pytest.mark.parametrize("spec", [
    "kv_get:fail:n=3", "kv_get:fail:after=4:n=2", "kv_get:fail:once",
    "kv_get:fail:p=0.3", "kv_get:fail:p=0.5:seed=11:n=4",
    "kv_get:fail:p=0.7:after=3", "kv_get:fail:err=refused:n=2",
    "kv_get:fail:err=timeout:after=1:n=1", "kv_get:fail:scope=peers*",
    "kv_get:fail:key=1:n=5"])
def test_plan_fires_on_the_same_calls(spec):
    got = _firings(tchaos, spec, 40, scope="peers.0", key="1")
    assert got == _firings(jchaos, spec, 40, scope="peers.0", key="1")
    assert got


def test_marker_fires_once_per_job_in_both(tmp_path):
    for mod, name in ((tchaos, "t"), (jchaos, "j")):
        marker = tmp_path / f"{name}.marker"
        spec = f"worker:fail:marker={marker}"
        first = _firings(mod, spec, 3, point="worker", commits=1)
        again = _firings(mod, spec, 3, point="worker", commits=1)
        assert first == [(0, "ChaosInjectedError")] and again == []
        assert marker.exists()


def test_matchers_select_the_same_contexts(monkeypatch):
    monkeypatch.setenv("HVDTPU_RANK", "1")
    monkeypatch.setenv("HVDTPU_WORKER_ID", "h:1")
    ctxs = [dict(name="grad_0", kind="allreduce"),
            dict(name="loss", kind="allreduce"),
            dict(name="grad_1", kind="broadcast", rank=0),
            dict(name="grad_2", kind="allreduce", rank=1)]
    spec = "collective:fail:name=grad_*:kind=allreduce:rank=1:wid=h:1"
    for mod in (tchaos, jchaos):
        plan = mod.Plan(mod.parse_spec(spec))
        out = []
        for ctx in ctxs:
            try:
                plan.fire("collective", ctx)
                out.append(False)
            except Exception:  # noqa: BLE001 - the injected failure
                out.append(True)
        assert out == [True, False, False, True]


def test_cli_prints_as_the_jax_package(capsys):
    from horovod_tpu.chaos import cli as jcli
    from horovod_tpu_torch.chaos import cli as tcli
    for args in (["points"], ["validate", CORPUS[0]],
                 ["validate", "kv_get:explode"], ["validate"]):
        got = (tcli.main(args), capsys.readouterr())
        want = (jcli.main(args), capsys.readouterr())
        assert got == want
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.chaos.cli", "points"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "driver" in out.stdout


def test_disabled_mode_is_the_null_plan():
    assert tchaos.plan() is tchaos.NULL_PLAN and not tchaos.enabled()
    tchaos.inject("kv_get", scope="x", key="y")


# -- the injection sites of the port -----------------------------------------

@pytest.fixture
def runtime_with(monkeypatch):
    import horovod_tpu_torch as hvd

    def start(spec, **env):
        hvd.shutdown()
        monkeypatch.setenv("HVDTPU_CHAOS", spec)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        tchaos.reset()
        hvd.init(device="cpu")
        return hvd
    yield start
    hvd.shutdown()
    monkeypatch.delenv("HVDTPU_CHAOS", raising=False)
    tchaos.reset()


def test_collective_fail_raises_then_the_name_is_free(runtime_with,
                                                      tmp_path):
    log = tmp_path / "chaos.log"
    hvd = runtime_with("collective:fail:name=grad_*:once",
                       HVDTPU_CHAOS_LOG=str(log))
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.exceptions import HorovodInternalError
    assert basics.runtime().coordinator._chaos_on
    with pytest.raises(HorovodInternalError, match="chaos: injected"):
        hvd.allreduce(torch.ones(3), name="grad_w")
    out = hvd.allreduce(torch.ones(3), name="grad_w")
    np.testing.assert_allclose(out.numpy(), 1.0)
    lines = log.read_text().splitlines()
    assert len(lines) == 1 and "collective fail" in lines[0]


def test_collective_stall_is_failed_by_shutdown(runtime_with):
    hvd = runtime_with("collective:stall:name=w")
    from horovod_tpu_torch.exceptions import HorovodInternalError
    from horovod_tpu_torch.ops.collectives import allreduce_async
    h = allreduce_async(torch.ones(2), name="w")
    assert not h.poll()
    hvd.shutdown()
    with pytest.raises(HorovodInternalError, match="in flight"):
        h.wait(5)


def test_collective_mismatch_perturbs_the_digest_as_the_jax_guard():
    from horovod_tpu.guardian import ConsistencyGuard as JGuard
    from horovod_tpu_torch.guardian import ConsistencyGuard as TGuard
    for digest in ({"shapes": [[2, 3], []], "dtype": "float32"},
                   {"shapes": [], "dtype": "int8"}):
        assert TGuard._perturb(digest) == JGuard._perturb(digest)


def test_mismatch_is_named_by_the_consistency_check(runtime_with):
    """The coordinator flags the matched submission; the guard publishes
    the perturbed digest, and a peer's verify names this rank."""
    hvd = runtime_with("collective:mismatch:name=w")
    from horovod_tpu_torch import basics, guardian
    from horovod_tpu_torch.coordinator import TensorEntry
    from horovod_tpu_torch.exceptions import CollectiveMismatchError
    from horovod_tpu_torch.process_sets import global_process_set
    seen = []
    coord = basics.runtime().coordinator
    coord._guardian = type("Spy", (), {
        "on_submit": lambda self, e: seen.append((e.name,
                                                  e.chaos_mismatch))})()
    try:
        hvd.allreduce(torch.ones(4), name="w")
        hvd.allreduce(torch.ones(4), name="v")
    finally:
        coord._guardian = None
    assert seen == [("w", True), ("v", False)]
    board = guardian.InProcBoard("chaos-mismatch-test")
    guards = [guardian.ConsistencyGuard(r, 2, board, timeout_s=5)
              for r in range(2)]
    entries = [TensorEntry("w", "allreduce", [torch.ones(4)],
                           global_process_set) for _ in range(2)]
    entries[1].chaos_mismatch = True
    for g, e in zip(guards, entries):
        g.on_submit(e)
    with pytest.raises(CollectiveMismatchError) as err:
        guards[0].verify(entries[0])
    assert {d[0] for d in err.value.divergences} == {1}


def test_worker_point_fires_at_the_commit(monkeypatch):
    for pkg in ("jax", "port"):
        if pkg == "jax":
            from horovod_tpu import chaos as mod
            from horovod_tpu.elastic import ObjectState
            from horovod_tpu.exceptions import ChaosInjectedError
        else:
            mod = tchaos
            from horovod_tpu_torch.elastic import ObjectState
            from horovod_tpu_torch.exceptions import ChaosInjectedError
        monkeypatch.setenv("HVDTPU_CHAOS", "worker:fail:after_commits=2")
        mod.reset()
        st = ObjectState(epoch=0)
        st._check_interval = 1e9
        st.commit()
        st.commit()
        with pytest.raises(ChaosInjectedError):
            st.commit()
        assert st._saved_state == {"epoch": 0}


def test_checkpoint_corrupt_falls_back_to_the_older_step(monkeypatch,
                                                         tmp_path):
    from horovod_tpu_torch import checkpoint as ckpt
    good = {"w": np.arange(6, dtype=np.float32)}
    ckpt.save_step(str(tmp_path), 1, good)
    monkeypatch.setenv("HVDTPU_CHAOS", "checkpoint:corrupt:name=step_2")
    tchaos.reset()
    ckpt.save_step(str(tmp_path), 2, {"w": np.ones(6, np.float32)})
    ok, reason = ckpt.verify_checkpoint(str(tmp_path / "step_2"))
    assert not ok and "checksum" in reason
    step, state = ckpt.restore_latest(str(tmp_path))
    assert step == 1
    np.testing.assert_array_equal(state["w"], good["w"])
    # The JAX package's reader refuses the corrupted file too (one format).
    from horovod_tpu.checkpoint import verify_checkpoint
    assert not verify_checkpoint(str(tmp_path / "step_2"))[0]


def test_kv_points_and_heartbeat_ride_out_injected_failures(monkeypatch):
    from horovod_tpu_torch.runner import heartbeat, http_client
    from horovod_tpu_torch.runner.http_server import KVStoreServer
    srv = KVStoreServer(job_token="t", addr="127.0.0.1")
    port = srv.start()
    try:
        monkeypatch.setenv("HVDTPU_CHAOS",
                           "kv_put:fail:n=2;kv_get:fail:err=refused:n=1;"
                           "heartbeat:fail:n=2")
        tchaos.reset()
        http_client.put_kv("127.0.0.1", port, "s", "k", "v", token="t",
                           backoff=0.001)
        assert http_client.get_kv("127.0.0.1", port, "s", "k", token="t",
                                  backoff=0.001) == b"v"
        hb = heartbeat.HeartbeatThread("127.0.0.1", port, "t", "h:0",
                                       interval_s=0.02).start()
        try:
            deadline = time.monotonic() + 20
            while srv.get(heartbeat.HEARTBEAT_SCOPE, "h:0") is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        finally:
            hb.stop()
        assert hb._count >= 3
        with pytest.raises(urllib.error.URLError):
            tchaos.Plan(tchaos.parse_spec("kv_get:fail")).fire(
                "kv_get", {})
    finally:
        srv.stop()


def test_chaos_injections_are_counted(monkeypatch):
    from horovod_tpu_torch.telemetry import core as telemetry
    monkeypatch.setenv("HOROVOD_TPU_METRICS", "1")
    telemetry.reset()
    try:
        plan = tchaos.Plan(tchaos.parse_spec("kv_get:fail:n=2"))
        for _ in range(3):
            try:
                plan.fire("kv_get", {})
            except urllib.error.URLError:
                pass
        fam = telemetry.snapshot()["families"]["hvd_chaos_injections_total"]
        assert [(s["labels"], s["value"]) for s in fam["samples"]] == \
            [({"point": "kv_get", "action": "fail"}, 2)]
    finally:
        monkeypatch.delenv("HOROVOD_TPU_METRICS")
        telemetry.reset()


def test_injected_collective_failure_resets_an_elastic_job(tmp_path):
    """Each rank's step-3 allreduce fails once (``collective:fail``): both
    workers restore their last commit, reset in process and finish every
    epoch (tests/test_chaos_matrix.py:586 fails rank 1 alone; then rank 0
    waits out the native core's 30 s shutdown drain before it resets, too
    long for this suite)."""
    from test_torch_port_elastic import _parse_log, _write_discovery
    torch_port_launch.build_port_core()
    phase = tmp_path / "phase"
    phase.write_text("0")
    discovery = _write_discovery(tmp_path, phase, [["localhost:2"]])
    log = str(tmp_path / "log")
    chaos_log = tmp_path / "chaos.log"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               ELASTIC_TEST_EPOCHS="5", ELASTIC_TEST_EPOCH_SLEEP="0.05",
               HVDTPU_CHAOS="collective:fail:name=step3:once",
               HVDTPU_CHAOS_LOG=str(chaos_log))
    rc, out = torch_port_launch.run_launcher(
        ["-np", "2", "--min-np", "1", "--max-np", "4",
         "--host-discovery-script", discovery, sys.executable,
         os.path.join(HERE, "torch_port_elastic_worker.py"), "epochs", log],
        REPO, env, 240)
    text = open(log).read() if os.path.exists(log) else ""
    assert rc == 0, (text, out[-4000:])
    fired = chaos_log.read_text().splitlines()
    assert len(fired) == 2 and all(" collective fail " in ln
                                   for ln in fired)
    assert len({ln.split()[0] for ln in fired}) == 2   # one per worker
    assert len([ln for ln in text.splitlines() if " DONE " in ln]) == 2
    entries = _parse_log(log)
    assert max(e[1] for e in entries) == 4
    # One restore-and-reset, no process death: each worker's pid stays.
    for wid in ("localhost:0", "localhost:1"):
        assert len({e[4] for e in entries if e[0] == wid}) == 1


def test_a_failed_update_leaves_no_gradients_for_the_rerun(runtime_with):
    """``train.make_train_step``: an update that fails after the backward
    (a collective failure: what an elastic restore runs the step again
    for) leaves no gradients behind, so that the re-run equals a step that
    never failed. Before the repair the re-run's backward accumulated into
    the failed attempt's gradients: twice the gradient."""
    runtime_with("")
    from horovod_tpu_torch import train
    from horovod_tpu_torch.exceptions import HorovodInternalError

    def run(fail_at):
        torch.manual_seed(0)
        model = torch.nn.Linear(8, 4)
        opt = train.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.5))
        step = train.make_train_step(lambda m, b: m(b).square().mean(), opt)
        x = torch.from_numpy(
            np.random.RandomState(0).randn(6, 8).astype(np.float32))
        real, calls = opt.step, [0]

        def step_once_failing():
            calls[0] += 1
            if calls[0] == fail_at:
                raise HorovodInternalError("injected")
            return real()
        opt.step = step_once_failing
        losses = []
        for _ in range(3):
            try:
                losses.append(float(step(model, x)))
            except HorovodInternalError:
                assert all(p.grad is None for p in model.parameters())
                losses.append(float(step(model, x)))
        return losses, [p.detach().clone() for p in model.parameters()]

    want, want_p = run(None)
    got, got_p = run(2)
    assert got == want
    for a, b in zip(got_p, want_p):
        assert torch.equal(a, b)

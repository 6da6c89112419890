"""The port's elastic training (``horovod_tpu_torch/elastic.py``,
``torch/elastic.py``) against the JAX package's: ``ObjectState`` commits
and restores, ``run_fn``'s event order, ``TorchState`` commit, restore and
sync at size 1 and in a 2-rank gloo job, the exit-restart refusal of
``TorchState``, ``ElasticSampler`` shards, the heartbeat lease. Then whole
elastic jobs through the port's launcher and driver (the counterparts of
tests/test_elastic.py:223-329; worker: tests/torch_port_elastic_worker.py):
scale-up, a killed worker, host exclusion, the kill on the gloo-delegated
plane in exit-restart mode, and a tiny TransformerLM under ``TorchState``
whose rank 1 is killed, against an uninterrupted run. Each job has a time
limit of its own; no check reads a wall clock."""

import itertools
import os
import re
import signal
import stat
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch import elastic as telastic
from horovod_tpu_torch.torch import elastic as ttorch_elastic

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
WORKER = os.path.join(HERE, "torch_port_elastic_worker.py")
JOB_TIMEOUT = 240

import torch_port_elastic_worker as worker  # noqa: E402
import torch_port_launch  # noqa: E402


# -- worker-side state ---------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_object_state_commit_restore(pkg):
    if pkg == "jax":
        from horovod_tpu.elastic import ObjectState
    else:
        ObjectState = telastic.ObjectState
    st = ObjectState(epoch=0, w=1.5, table=np.zeros(3))
    st.epoch = 3
    st.w = 9.0
    st.save()
    st.epoch = 4
    st.w = -1.0
    st.restore()
    assert (st.epoch, st.w) == (3, 9.0)
    assert st._saved_state == {"epoch": 3, "w": 9.0, "table": st.table}


def _run_fn_events(pkg, script):
    """The events a FakeState records under run_fn while the wrapped
    function raises each of ``script`` in turn, then returns."""
    if pkg == "jax":
        from horovod_tpu.elastic import State, run_fn
        from horovod_tpu.exceptions import (HorovodInternalError,
                                            HostsUpdatedInterrupt)
    else:
        from horovod_tpu_torch.elastic import State, run_fn
        from horovod_tpu_torch.exceptions import (HorovodInternalError,
                                                  HostsUpdatedInterrupt)
    errors = {"internal": lambda: HorovodInternalError("boom"),
              "hosts": lambda: HostsUpdatedInterrupt(skip_sync=False),
              "hosts_skip_sync": lambda: HostsUpdatedInterrupt(
                  skip_sync=True)}
    events = []

    class FakeState(State):
        def save(self):
            events.append("save")

        def restore(self):
            events.append("restore")

        def sync(self):
            events.append("sync")

        def check_host_updates(self):
            pass

    attempts = []

    def func(state):
        attempts.append(1)
        if len(attempts) <= len(script):
            raise errors[script[len(attempts) - 1]]()
        return "ok"

    wrapped = run_fn(func, reset=lambda: events.append("reset"))
    assert wrapped(FakeState()) == "ok"
    return events


@pytest.mark.parametrize("script,want", [
    (["internal", "hosts"],
     ["sync", "restore", "reset", "sync", "reset", "sync"]),
    (["hosts_skip_sync", "internal"],
     ["sync", "reset", "restore", "reset", "sync"]),
])
def test_run_fn_event_order_equals_the_jax_package(script, want):
    got = _run_fn_events("port", script)
    assert got == _run_fn_events("jax", script)
    assert got == want


def test_run_fn_propagates_other_errors_without_a_reset():
    resets = []

    def func(state):
        raise ValueError("not elastic")

    class S(telastic.State):
        def sync(self):
            pass

    with pytest.raises(ValueError):
        telastic.run_fn(func, reset=lambda: resets.append(1))(S())
    assert resets == []


@pytest.fixture
def runtimes(hvd):
    # ``hvd`` (tests/conftest.py) is the JAX package's session runtime:
    # initialized once per test process and never shut down here.
    thvd.shutdown()
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def _jax_torch_state(rank):
    """The JAX package's TorchState through commit, perturb, restore and
    sync, on the worker's MLP of ``rank``."""
    from horovod_tpu.torch.elastic import TorchState
    model, opt = worker.mlp_state(rank)
    state = TorchState(model, opt, epoch=3 + rank)
    worker.perturb(model, opt)
    state.epoch = 99
    state.restore()
    state.sync()
    return worker.flat_state(model, opt, state.epoch)


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_torch_state_commit_restore_sync_at_size_one(runtimes):
    model, opt = worker.mlp_state(0)
    state = ttorch_elastic.TorchState(model, opt, epoch=3, best=[1.5])
    committed = worker.flat_state(model, opt, state.epoch)
    worker.perturb(model, opt)
    state.epoch, state.best = 99, [0.0]
    state.restore()
    _assert_states_equal(worker.flat_state(model, opt, state.epoch),
                         committed)
    assert state.best == [1.5]
    state.sync()
    got = worker.flat_state(model, opt, state.epoch)
    _assert_states_equal(got, committed)
    _assert_states_equal(got, _jax_torch_state(0))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_torch_state_refuses_exit_restart_persistence(monkeypatch, pkg):
    # TorchState keeps `_saved`, not `_saved_state`: the exit-restart
    # plane cannot persist it, in either package (ROADMAP item 11).
    if pkg == "jax":
        from horovod_tpu import elastic as mod
        from horovod_tpu.torch.elastic import TorchState
    else:
        mod, TorchState = telastic, ttorch_elastic.TorchState
    monkeypatch.setenv("HVDTPU_ELASTIC", "1")
    monkeypatch.setenv("HVDTPU_CPU_OPERATIONS", "nccl")
    assert mod._restart_mode()
    model, opt = worker.mlp_state(0)
    with pytest.raises(NotImplementedError, match="_saved_state"):
        mod._state_payload(TorchState(model, opt, epoch=1))
    assert mod._state_payload(mod.ObjectState(epoch=2)) == {"epoch": 2}
    monkeypatch.setenv("HVDTPU_CPU_OPERATIONS", "tcp")
    assert not mod._restart_mode()


class _FakeRuntime:
    def __init__(self, mode, rank, size):
        self.mode = mode
        self.topology = type("T", (), {"rank": rank, "size": size})()


@pytest.mark.parametrize("n,size", [(0, 1), (10, 1), (10, 3), (17, 2),
                                    (33, 4), (64, 5)])
def test_elastic_sampler_equals_the_jax_package(monkeypatch, n, size):
    from horovod_tpu import basics as jbasics
    from horovod_tpu.torch.elastic import ElasticSampler as JSampler
    from horovod_tpu_torch import basics as tbasics
    for rank, seed, epoch, shuffle, frac in itertools.product(
            range(size), (0, 5), (0, 2), (True, False), (0.0, 0.3)):
        processed = set(np.random.RandomState(seed + epoch).choice(
            n, size=int(frac * n), replace=False).tolist()) if n else set()
        samplers = []
        for basics, cls in ((jbasics, JSampler),
                            (tbasics, ttorch_elastic.ElasticSampler)):
            rt = _FakeRuntime(basics.MODE_SPMD, rank, size)
            monkeypatch.setattr(basics, "is_initialized", lambda: True)
            monkeypatch.setattr(basics, "runtime", lambda rt=rt: rt)
            s = cls(list(range(n)), shuffle=shuffle, seed=seed)
            s.set_epoch(epoch)
            s.processed_indices = set(processed)
            s.reset()
            s.record_batch(0, 2)
            samplers.append((list(s), sorted(s.processed_indices), len(s)))
        assert samplers[0] == samplers[1], (rank, seed, epoch, shuffle)


def test_heartbeat_lease_and_liveness_equal_the_jax_package():
    from horovod_tpu.runner import heartbeat as jhb
    from horovod_tpu_torch.runner import heartbeat as thb
    from horovod_tpu_torch.runner.http_server import KVStoreServer
    server = KVStoreServer(job_token="t", addr="127.0.0.1")
    port = server.start()
    beat = thb.HeartbeatThread("127.0.0.1", port, "t", "h:0",
                               interval_s=0.02).start()
    try:
        seen = set()
        deadline = time.monotonic() + 30
        while len(seen) < 3 and time.monotonic() < deadline:
            value = server.get(thb.HEARTBEAT_SCOPE, "h:0")
            if value is not None:
                seen.add(value)
            time.sleep(0.01)
        assert len(seen) >= 3
        assert all(v.startswith(f"{os.getpid()}:".encode()) for v in seen)
    finally:
        beat.stop()
        server.stop()
    obs = [("a", "1", 0.0), ("a", "1", 0.5), ("a", "1", 1.2),
           ("a", "2", 1.3), ("b", "x", 1.3), ("a", "2", 2.2),
           ("a", "2", 2.4), ("b", "x", 2.4)]
    results = []
    for mod in (thb, jhb):
        tracker = mod.LivenessTracker(1.0)
        results.append([tracker.observe(w, v, now=t) for w, v, t in obs])
    assert results[0] == results[1]
    assert results[0] == [False, False, True, False, False, False, True,
                          True]


@pytest.mark.parametrize("elastic,wid,local_rank,want", [
    ("1", "localhost:1", 0, 1),      # a survivor re-ranked below its slot
    ("1", "localhost:0", 1, 0),      # a respawned slot ranked after it
    ("1", "10.0.0.7:3", 3, 3),
    ("", "localhost:1", 0, 0),       # not elastic: the local rank
    ("1", "", 2, 2)])
def test_an_elastic_worker_takes_the_card_of_its_slot(
        monkeypatch, elastic, wid, local_rank, want):
    """After a lost slot the driver hands local ranks out again, survivors
    first: an elastic worker's card follows its slot, so that a survivor
    and a respawned slot never share one."""
    from horovod_tpu_torch import basics
    monkeypatch.setenv("HVDTPU_ELASTIC", elastic)
    monkeypatch.setenv("HVDTPU_WORKER_ID", wid)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    topo = basics.Topology(local_rank, 4, local_rank, 4, 0, 1)
    assert basics._pick_device(None, topo) == torch.device("cuda", want)
    assert basics._pick_device("cpu", topo) == torch.device("cpu")


def test_binding_exports_the_elastic_module():
    import horovod_tpu_torch.torch as hvd
    assert hvd.elastic is ttorch_elastic
    assert hvd.elastic.run is telastic.run
    assert hvd.elastic.ObjectState is telastic.ObjectState
    from horovod_tpu_torch.exceptions import HostsUpdatedInterrupt
    assert HostsUpdatedInterrupt(skip_sync=True).skip_sync


# -- whole jobs through the port's launcher ---------------------------------

def _write_discovery(job_dir, phase_file, phases):
    """Discovery script that prints different host sets per phase number
    (reference: elastic_common.py:34-63 epoch-driven bash discovery)."""
    lines = ["#!/bin/sh", f'P=$(cat "{phase_file}" 2>/dev/null || echo 0)']
    for i, hosts in enumerate(phases):
        lines.append(f'{"if" if i == 0 else "elif"} [ "$P" = "{i}" ]; then')
        lines += [f'  echo "{h}"' for h in hosts]
    lines.append("fi")
    script = job_dir / "discover.sh"
    script.write_text("\n".join(lines) + "\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def _parse_log(log_path):
    entries = []
    if not os.path.exists(log_path):
        return entries
    for line in open(log_path):
        m = re.match(r"(\S+) epoch=(\d+) rank=(\d+) size=(\d+) pid=(\d+)",
                     line)
        if m:
            entries.append((m.group(1), int(m.group(2)), int(m.group(3)),
                            int(m.group(4)), int(m.group(5))))
    return entries


class _Job:
    """One launcher job in its own directory: a discovery script over
    phases, a phase flip once the log satisfies a predicate, a time
    limit (SIGINT lets the driver stop its workers, then SIGKILL)."""

    def __init__(self, root, name, mode, phases, env, np_=2, flip=None):
        self.dir = root / name
        self.dir.mkdir()
        self.log = str(self.dir / "log")
        phase_file = self.dir / "phase"
        phase_file.write_text("0")
        discovery = _write_discovery(self.dir, phase_file, phases)
        full_env = {k: v for k, v in os.environ.items()
                    if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_",
                                         "ELASTIC_TEST_"))}
        full_env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                        HVDTPU_START_TIMEOUT="120",
                        **{k: str(v) for k, v in env.items()})
        self.out = open(self.dir / "launcher.txt", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
             "-np", str(np_), "--min-np", "1", "--max-np", "8",
             "--start-timeout", "120", "--host-discovery-script", discovery,
             sys.executable, WORKER, mode, self.log],
            cwd=REPO, env=full_env, stdout=self.out,
            stderr=subprocess.STDOUT)
        self.flipper = None
        if flip is not None:
            self.flipper = threading.Thread(
                target=self._flip, args=(phase_file, flip), daemon=True)
            self.flipper.start()

    def _flip(self, phase_file, predicate):
        """Flip to phase 1 once training demonstrably ran at the initial
        membership (worker start-up time varies too much for sleeps)."""
        while self.proc.poll() is None:
            if predicate(_parse_log(self.log)):
                break
            time.sleep(0.1)
        phase_file.write_text("1")

    def finish(self):
        try:
            rc = self.proc.wait(timeout=JOB_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            rc = "timeout"
        if self.flipper is not None:
            self.flipper.join(timeout=10)
        self.out.close()
        text = open(self.log).read() if os.path.exists(self.log) else ""
        launcher = (self.dir / "launcher.txt").read_text()
        return {"rc": rc, "log": text, "entries": _parse_log(self.log),
                "launcher": launcher, "path": self.log}


def _at_size(n, count=2):
    return lambda e: len([x for x in e if x[3] == n]) >= count


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    torch_port_launch.build_port_core()
    root = tmp_path_factory.mktemp("elastic")
    kill = {"ELASTIC_TEST_EPOCHS": 6, "ELASTIC_TEST_EPOCH_SLEEP": 0.3,
            "ELASTIC_TEST_KILL_WORKER": "localhost:1",
            "ELASTIC_TEST_KILL_EPOCH": 2}
    grow = {"ELASTIC_TEST_EPOCHS": 10, "ELASTIC_TEST_EPOCH_SLEEP": 0.4}
    lm = {"ELASTIC_TEST_EPOCHS": 5}
    waves = [
        {"scale_up": lambda: _Job(root, "scale_up", "epochs",
                                  [["localhost:2"], ["localhost:3"]], grow,
                                  flip=_at_size(2)),
         "kill": lambda: _Job(root, "kill", "epochs", [["localhost:2"]],
                              kill),
         "exclusion": lambda: _Job(
             root, "exclusion", "epochs",
             [["localhost:1", "127.0.0.1:1"], ["localhost:1"]], grow,
             flip=_at_size(2)),
         "restart": lambda: _Job(root, "restart", "epochs",
                                 [["localhost:2"]],
                                 {**kill, "HVDTPU_CPU_OPERATIONS": "nccl"})},
        {"lm_kill": lambda: _Job(
            root, "lm_kill", "transformer", [["localhost:2"]],
            {**lm, "ELASTIC_TEST_KILL_WORKER": "localhost:1",
             "ELASTIC_TEST_KILL_EPOCH": 3}),
         "lm_kill0": lambda: _Job(
             root, "lm_kill0", "transformer", [["localhost:2"]],
             {**lm, "ELASTIC_TEST_KILL_WORKER": "localhost:0",
              "ELASTIC_TEST_KILL_EPOCH": 3}),
         "lm_ref": lambda: _Job(root, "lm_ref", "transformer",
                                [["localhost:2"]], lm)},
    ]
    done = {}
    for wave in waves:
        started = {name: start() for name, start in wave.items()}
        for name, job in started.items():
            done[name] = job.finish()
    return done


def _done_lines(job):
    return [line for line in job["log"].splitlines() if " DONE " in line]


def _ok(job):
    assert job["rc"] == 0, (job["log"], job["launcher"][-4000:])
    return job


def test_elastic_scale_up(jobs):
    job = _ok(jobs["scale_up"])
    sizes = {e[3] for e in job["entries"]}
    assert {2, 3} <= sizes, job["entries"]   # the job grew mid-run
    assert len(_done_lines(job)) == 3


def test_elastic_worker_failure_recovers(jobs):
    """One worker dies mid-training: the survivor restores its last
    commit in process (same pid), the driver respawns a replacement, and
    training completes every epoch."""
    job = _ok(jobs["kill"])
    assert "KILLED epoch=2" in job["log"]
    survivor = [e for e in job["entries"] if e[0] == "localhost:0"]
    epochs = [e[1] for e in survivor]
    assert epochs == sorted(epochs) and max(epochs) == 5, survivor
    assert len({e[4] for e in survivor}) == 1     # reset in process
    assert len(_done_lines(job)) == 2


def test_elastic_host_exclusion(jobs):
    """A host removed by discovery drops out; the job shrinks and
    completes on the remaining host ('localhost' and '127.0.0.1' act as
    two hosts that both spawn locally)."""
    job = _ok(jobs["exclusion"])
    assert {e[3] for e in job["entries"]} >= {1, 2}, job["entries"]
    assert len(_done_lines(job)) == 1


def test_elastic_worker_failure_recovers_in_restart_mode(jobs):
    """The kill on the gloo-delegated plane (HVDTPU_CPU_OPERATIONS=nccl):
    the survivor persists its ObjectState commit through the KV store and
    exits for a fresh process, which restores it: epochs stay monotonic,
    no restart from zero."""
    job = _ok(jobs["restart"])
    assert "KILLED epoch=2" in job["log"]
    survivor = [e for e in job["entries"] if e[0] == "localhost:0"]
    epochs = [e[1] for e in survivor]
    assert epochs == sorted(epochs) and max(epochs) == 5, survivor
    assert len({e[4] for e in survivor}) == 2     # a fresh process
    assert len(_done_lines(job)) == 2
    assert all("total=12.0" in line for line in _done_lines(job))


def test_tiny_transformer_survives_a_killed_rank(jobs):
    """A 2-rank TransformerLM (2 layers, hidden 64) under TorchState:
    rank 1 dies at step 3; rank 0 restores, resets in process, syncs the
    respawned rank and finishes with the parameters of an uninterrupted
    2-rank run."""
    _assert_lm_recovered(_ok(jobs["lm_kill"]), _ok(jobs["lm_ref"]))


def test_tiny_transformer_survives_its_rank_zero_killed(jobs):
    """The same with rank 0 (``localhost:0``) dead at step 3: the survivor
    becomes rank 0, syncs the respawned slot, and the parameters it writes
    equal the uninterrupted run's."""
    job = _ok(jobs["lm_kill0"])
    _assert_lm_recovered(job, _ok(jobs["lm_ref"]))
    done = {line.split()[0]: line for line in _done_lines(job)}
    assert "rank=0" in done["localhost:1"], done
    assert "rank=1" in done["localhost:0"], done


def _assert_lm_recovered(job, ref):
    assert "KILLED step=3" in job["log"]
    # The survivor's in-process reset timed its parts.
    assert (" RESET init=backend,bootstrap,total "
            "shutdown=backend,coordinator,total") in job["log"], job["log"]
    assert len(_done_lines(job)) == 2 and len(_done_lines(ref)) == 2
    got = np.load(job["path"] + ".params.npz")
    want = np.load(ref["path"] + ".params.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_torch_state_sync_in_a_two_rank_gloo_job(tmp_path, runtimes):
    torch_port_launch.build_port_core()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HVDTPU_CPU_OPERATIONS="nccl")
    rc, out = torch_port_launch.run_launcher(
        ["-np", "2", "--start-timeout", "60", sys.executable, WORKER,
         "torchstate", str(tmp_path)], REPO, env, JOB_TIMEOUT)
    assert rc == 0, out[-5000:]
    r0 = dict(np.load(tmp_path / "r0.npz"))
    r1 = dict(np.load(tmp_path / "r1.npz"))
    _assert_states_equal(r1, r0)
    _assert_states_equal(r0, _jax_torch_state(0))
    # An optimizer with no state yet receives the root's, tensors
    # allocated from the root's shapes.
    fresh = dict(np.load(tmp_path / "fresh1.npz"))
    _assert_states_equal(fresh, {k: v for k, v in r0.items()
                                 if k.startswith("opt.")})

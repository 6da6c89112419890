"""The port's fleet matrix: real two-plane jobs under traffic-driven
arbitration, on the CPU (the rows of tests/test_fleet_matrix.py, with the
port's driver, workers, serving plane and arbiter).

Each row is a genuine multi-process elastic job — the port's
``ElasticDriver`` in this process, ``tests/torch_port_fleet_worker.py``
processes on the tcp-native plane, discovery read from the arbiter's
target file — sharing one control plane (the driver's KV store) with an
in-process serving cohort over HTTP:

- (A) a traffic spike mid-training: the arbiter leases one of two
  training slots to serving (graceful exit 83 at a commit boundary, the
  survivor re-forms at size 1, serving scales out). The per-step loss
  trajectory is bit-exact against the uninterrupted one (averaging
  identical gradients over a power-of-two cohort is exact), every accepted
  request completes with the oracle's tokens, the hand-off is counted as
  an arbiter transfer, and the p99 of a wave sent after the lease is below
  the spike wave's — all from one job;
- (B) a real SIGTERM of a worker marked in the ``fleet`` scope counts as
  ``arbiter_transfer``, never a failure;
- (C) the survivor SIGKILLed while the surge lease is in flight takes the
  normal failure path and the lease still completes;
- the one-slot round trip (``chip_smoke.py [fleet]``'s shape): the job's
  only slot is lent to serving (the driver holds the job below ``min_np``
  while the arbiter's ebb brings the slot back), a second serving worker
  takes the load and later drains, and a fresh training process resumes
  from the checkpoint of the commit it handed off at.

Load: one job at a time, at most two training processes, short step
sleeps; serving decode is paced by a sleep, not by computation.
"""

import os
import re
import sys
import threading
import time

import pytest

import torch_port_fleet_worker as fw

from horovod_tpu_torch.fleet import ledger as ledger_mod
from horovod_tpu_torch.fleet.actuators import (DriverProbes,
                                               TargetFileActuators)
from horovod_tpu_torch.fleet.arbiter import FleetArbiter
from horovod_tpu_torch.fleet.ledger import LeaseLedger
from horovod_tpu_torch.fleet.policy import FleetPolicy
from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                     ElasticSettings)
from horovod_tpu_torch.runner.job import Settings
from horovod_tpu_torch.serving import autoscale as sautoscale
from horovod_tpu_torch.serving.model import ToyLM
from horovod_tpu_torch.serving.router import Router, WorkerClient
from horovod_tpu_torch.serving.worker import ServingWorker

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_fleet_worker.py")

#: padded decode step (a stand-in for a real model's step time).
DECODE_DELAY_S = 0.02


class PacedToyLM(ToyLM):
    def decode(self, contexts):
        time.sleep(DECODE_DELAY_S)
        return super().decode(contexts)


def _parse_steps(log_path):
    """[(wid, step, rank, size, loss_str, pid)] — losses kept as strings
    so equality is bitwise."""
    entries = []
    if not os.path.exists(log_path):
        return entries
    for line in open(log_path):
        m = re.match(r"(\S+) step=(\d+) rank=(\d+) size=(\d+) "
                     r"loss=(\S+) pid=(\d+)", line)
        if m:
            entries.append((m.group(1), int(m.group(2)), int(m.group(3)),
                            int(m.group(4)), m.group(5), int(m.group(6))))
    return entries


def _trajectory(entries):
    """step -> set of distinct loss strings logged for that step."""
    traj = {}
    for entry in entries:
        traj.setdefault(entry[1], set()).add(entry[4])
    return traj


def _worker_env(log_path, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS="1", ELASTIC_TEST_LOG=str(log_path))
    env.update({k: str(v) for k, v in extra.items()})
    return env


class _ServePlane:
    """The serving half of the fleet: in-process workers serving HTTP,
    registered in the TRAINING driver's KV store (one control plane for
    both cohorts; a drained worker migrates its streams to a peer it finds
    there), a router over them, and the slot actuation the arbiter drives
    — starting a worker on scale-out, stopping drained victims on
    scale-in."""

    def __init__(self, driver, cohort="serve"):
        self.driver = driver
        self.cohort = cohort
        self.kv = ("127.0.0.1", driver.port, driver.token)
        self.workers = {}
        self.router = Router(members={cohort: []})
        self.lock = threading.Lock()

    def set_slots(self, n):
        with self.lock:
            for wid in range(n):
                if wid in self.workers:
                    continue
                w = ServingWorker(PacedToyLM(device="cpu"),
                                  cohort=self.cohort, wid=wid, num_pages=24,
                                  page_size=2, queue_limit=32,
                                  max_batch_tokens=64).start()
                port = w.serve_http("127.0.0.1", token=self.driver.token)
                w.register(*self.kv, advertise=f"127.0.0.1:{port}")
                w.client = WorkerClient(f"http://127.0.0.1:{port}",
                                        token=self.driver.token)
                w.client.wid = wid
                self.workers[wid] = w
            gone = [self.workers.pop(wid) for wid in list(self.workers)
                    if wid >= n]
            self.router.members[self.cohort] = [
                w.client for w in self.workers.values()]
            for w in gone:
                w.stop()
                self.driver.server.delete(
                    "serving", f"member.{self.cohort}.{w.wid}")
                self.driver.server.delete(
                    "serving", f"stats.{self.cohort}.{w.wid}")

    def stop(self):
        with self.lock:
            for w in self.workers.values():
                w.stop()
            self.workers.clear()


class _Actuators(TargetFileActuators):
    """Stock target-file actuation for the training plane; in-process
    worker lifecycle for the serving plane (the test IS the serving
    launcher here)."""

    def __init__(self, train_target, plane, **kw):
        super().__init__(train_target, train_target + ".serve",
                         serve_cohort=plane.cohort, **kw)
        self.plane = plane

    def set_serve_slots(self, slots):
        super().set_serve_slots(slots)  # keep the desired-state file
        self.plane.set_slots(slots)


def _wave(router, record, n, max_new=8, gap_s=0.01):
    """``n`` concurrent requests; every outcome (and its latency) is
    recorded so accepted-request loss is countable afterwards."""
    oracle = ToyLM(device="cpu")

    def one(i):
        prompt = [2, 3 + i % 5]
        t0 = time.monotonic()
        status, body = router.generate(
            {"prompt": prompt, "max_new_tokens": max_new})
        dt = time.monotonic() - t0
        if status == 200:
            ok = body["tokens"] == oracle.reference_completion(prompt,
                                                               max_new)
            record.append(("ok" if ok else "corrupt", dt))
        elif status in (429, 503):
            record.append(("rejected", dt))
        else:
            record.append(("error", dt))

    threads = []
    for i in range(n):
        th = threading.Thread(target=one, args=(i,))
        th.start()
        threads.append(th)
        time.sleep(gap_s)
    return threads


def _p99(record):
    lat = sorted(t for kind, t in record if kind == "ok")
    assert lat, record
    return lat[min(len(lat) - 1, int(0.99 * len(lat)))]


def _assert_zero_request_loss(record):
    outcomes = [kind for kind, _ in record]
    assert "error" not in outcomes, outcomes
    assert "corrupt" not in outcomes, outcomes
    assert outcomes.count("ok") > 0, outcomes


def _fleet_job(tmp_path, slots=2, steps=16, step_sleep=0.3, policy=None,
               ckpt=None):
    """The whole two-plane rig: the training driver (``slots`` slots,
    target-file discovery), the serving plane (1 worker), the arbiter
    colocated with the driver (``DriverBackend`` on the driver's own KV
    store)."""
    train_target = str(tmp_path / "train_targets")
    sautoscale.write_target(train_target, [f"localhost:{slots}"])
    script = tmp_path / "discover.sh"
    script.write_text("\n".join(
        sautoscale.discovery_script_lines(train_target)) + "\n")
    script.chmod(0o755)
    log_path = tmp_path / "log"
    extra = {"FLEET_TEST_STEPS": steps, "FLEET_TEST_STEP_SLEEP": step_sleep}
    if ckpt is not None:
        extra["FLEET_TEST_CKPT"] = ckpt
    es = ElasticSettings(
        Settings(num_proc=slots, start_timeout=90,
                 env=_worker_env(log_path, **extra)),
        discovery_script=str(script), min_np=1, max_np=8,
        discovery_interval=0.2, journal_dir="")
    driver = ElasticDriver(es, [sys.executable, WORKER])
    plane = _ServePlane(driver)
    plane.set_slots(1)
    backend = ledger_mod.DriverBackend(driver.server, term_fn=driver._wt)
    act = _Actuators(train_target, plane,
                     kv_put=lambda s, k, v: driver.server.put(
                         s, k, v, term=driver._wt()))
    pol = dict(min_train_slots=1, min_serve_slots=1, window=2,
               cooldown_s=600.0, ebb_idle_s=600.0, scale_up_depth=6,
               slo_p99=0.3)
    pol.update(policy or {})
    arbiter = FleetArbiter(
        LeaseLedger(backend), act, DriverProbes(driver),
        policy=FleetPolicy(**pol), train_slots=slots, serve_slots=1,
        drain_timeout=10.0)
    return driver, plane, arbiter, log_path, train_target


def _run_driver(driver):
    box = {}

    def run():
        box["rc"] = driver.run()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _tick_until(arbiter, thread, pred, deadline_s, tick_s=0.25):
    """Ticks until ``pred(lease)``, the deadline, or the end of the
    driver's ``thread`` (its KV store stops with it)."""
    deadline = time.monotonic() + deadline_s
    lease = None
    while time.monotonic() < deadline and thread.is_alive():
        lease = arbiter.tick(time.time())
        if pred(lease):
            return lease
        time.sleep(tick_s)
    return lease


def _wait_for(pred, deadline_s, poll_s=0.1):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return False


def _completed(lease):
    return lease is not None and lease["state"] == "complete"


def _join(thread, box, log_path):
    thread.join(timeout=120)
    assert not thread.is_alive(), "training driver hung"
    assert box.get("rc") == 0, (open(log_path).read()
                                if os.path.exists(log_path) else "no log")


def _assert_trajectory(entries, steps):
    traj = _trajectory(entries)
    assert sorted(traj) == list(range(steps)), sorted(traj)
    reference = fw.reference_losses(steps)
    for step in range(steps):
        assert traj[step] == {reference[step]}, (
            f"step {step}: {traj[step]} != {reference[step]}")


# -- (A) the spike: 2 -> 1, bit-exact, zero request loss, p99 ------------------

@pytest.fixture(scope="module")
def spike_row(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spike")
    steps = 20
    driver, plane, arbiter, log_path, _ = _fleet_job(tmp, steps=steps)
    res = {"steps": steps, "spike": [], "after": []}
    try:
        thread, box = _run_driver(driver)
        # Training reached steady state at size 2 before the spike.
        assert _wait_for(lambda: len([e for e in _parse_steps(log_path)
                                      if e[3] == 2]) >= 2, 60), \
            open(log_path).read() if log_path.exists() else "no log"
        threads = _wave(plane.router, res["spike"], 24)
        t_spike = time.monotonic()
        lease = _tick_until(arbiter, thread, _completed, deadline_s=45.0)
        res["recovery_s"] = time.monotonic() - t_spike
        res["lease"] = lease
        res["split"] = dict(arbiter.split)
        res["serve_workers"] = len(plane.workers)
        for th in threads:
            th.join(timeout=60)
        if _completed(lease):
            for th in _wave(plane.router, res["after"], 12):
                th.join(timeout=60)
        _join(thread, box, log_path)
        res["entries"] = _parse_steps(log_path)
        res["causes"] = dict(driver.preempt_causes)
        res["fail_counts"] = dict(driver.fail_counts)
        res["blacklist"] = set(driver.blacklist)
    finally:
        plane.stop()
        driver.server.stop()
    return res


def test_spike_leases_a_training_slot_to_serving(spike_row):
    lease = spike_row["lease"]
    assert _completed(lease), lease
    assert lease["direction"] == "train_to_serve"
    assert lease["wids"] == ["localhost:1"]
    assert spike_row["split"] == {"train": 1, "serve": 2, "leased": 1}
    assert spike_row["serve_workers"] == 2
    assert spike_row["recovery_s"] < 45.0


def test_spike_trajectory_is_bit_exact_across_the_lease(spike_row):
    entries = spike_row["entries"]
    _assert_trajectory(entries, spike_row["steps"])
    # The cohort really shrank mid-run.
    assert {e[3] for e in entries} == {1, 2}


def test_spike_hand_off_is_a_transfer_never_a_failure(spike_row):
    assert spike_row["causes"] == {"preempt": 0, "arbiter_transfer": 1}
    assert spike_row["fail_counts"] == {}
    assert spike_row["blacklist"] == set()


def test_spike_loses_no_accepted_request_and_p99_recovers(spike_row):
    _assert_zero_request_loss(spike_row["spike"])
    _assert_zero_request_loss(spike_row["after"])
    assert _p99(spike_row["after"]) < _p99(spike_row["spike"]), (
        _p99(spike_row["after"]), _p99(spike_row["spike"]))


# -- (B) a real SIGTERM with a marker -----------------------------------------

def test_marker_preemption_real_sigterm_counts_as_transfer(tmp_path):
    steps = 10
    driver, plane, arbiter, log_path, train_target = _fleet_job(
        tmp_path, steps=steps, step_sleep=0.2)
    try:
        thread, box = _run_driver(driver)
        assert _wait_for(lambda: len([e for e in _parse_steps(log_path)
                                      if e[3] == 2]) >= 2, 60)
        # Ledger-before-actuation by hand: marker first...
        arbiter.ledger.mark_transfer("localhost:1", "lease-row-b")
        # ...then the desired-state shrink the driver reconciles.
        sautoscale.write_target(train_target, ["localhost:1"])
        _join(thread, box, log_path)
        assert driver.preempt_causes == {"preempt": 0,
                                         "arbiter_transfer": 1}
        assert driver.fail_counts == {}
        assert driver.blacklist == set()
        _assert_trajectory(_parse_steps(log_path), steps)
    finally:
        plane.stop()
        driver.server.stop()


# -- (C) SIGKILL mid-transfer ---------------------------------------------------

def test_sigkill_mid_transfer_recovers_with_the_lease_intact(tmp_path):
    steps = 20
    driver, plane, arbiter, log_path, _ = _fleet_job(tmp_path, steps=steps)
    record = []
    try:
        thread, box = _run_driver(driver)
        assert _wait_for(lambda: len([e for e in _parse_steps(log_path)
                                      if e[3] == 2]) >= 2, 60)
        threads = _wave(plane.router, record, 24)
        # Drive the lease into flight (past proposed), then kill the
        # survivor: the slot the lease did NOT take.
        lease = _tick_until(
            arbiter, thread, lambda l: l is not None and l["state"] in (
                "preempting", "resharding", "activating"), deadline_s=30.0)
        assert lease is not None, "lease never opened"
        assert lease["wids"] == ["localhost:1"]
        # The driver has acted on the shrink (the victim has its SIGTERM)
        # before the kill, so the victim hands off whichever comes first.
        assert _wait_for(lambda: "localhost:1" not in driver.workers, 30)
        survivor = driver.workers.get("localhost:0")
        assert survivor is not None
        survivor.proc.kill()
        lease = _tick_until(arbiter, thread, _completed, deadline_s=60.0)
        assert _completed(lease), lease
        # Read the ledger BEFORE the driver exits and stops its store.
        assert arbiter.ledger.active() is None
        assert arbiter.split == {"train": 1, "serve": 2, "leased": 1}
        for th in threads:
            th.join(timeout=60)
        _join(thread, box, log_path)
        # The kill was a genuine failure (normal elastic accounting)...
        assert driver.fail_counts.get("localhost") == 1, driver.fail_counts
        assert driver.blacklist == set()
        # ...and the victim's hand-off stayed a transfer.
        assert driver.preempt_causes["arbiter_transfer"] == 1, \
            driver.preempt_causes
        # Every step present with one loss each: the respawn replays
        # the same deterministic trajectory, never a different one.
        traj = _trajectory(_parse_steps(log_path))
        assert sorted(traj) == list(range(steps)), sorted(traj)
        assert all(len(v) == 1 for v in traj.values()), traj
        _assert_zero_request_loss(record)
    finally:
        plane.stop()
        driver.server.stop()


# -- the one-slot round trip ----------------------------------------------------

@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("roundtrip")
    steps = 14
    ckpt = str(tmp / "ckpt")
    driver, plane, arbiter, log_path, _ = _fleet_job(
        tmp, slots=1, steps=steps, step_sleep=0.3, ckpt=ckpt,
        policy=dict(min_train_slots=0, window=1, cooldown_s=2.0,
                    ebb_idle_s=2.0, slo_p99=0.0))
    res = {"steps": steps, "burst": [], "calm": [], "states": []}
    stop_calm = threading.Event()

    def calm_trickle():
        while not stop_calm.is_set():
            for th in _wave(plane.router, res["calm"], 2, max_new=24):
                th.join(timeout=60)

    def watch(lease):
        if lease is not None:
            step = (lease["id"], lease["state"])
            if step not in res["states"]:
                res["states"].append(step)
        return lease

    try:
        thread, box = _run_driver(driver)
        assert _wait_for(lambda: len(_parse_steps(log_path)) >= 3, 60), \
            open(log_path).read() if log_path.exists() else "no log"
        threads = _wave(plane.router, res["burst"], 24)
        res["surge"] = _tick_until(
            arbiter, thread, lambda l: _completed(watch(l)), deadline_s=45.0)
        res["serve_workers"] = len(plane.workers)
        res["train_during_lease"] = len(driver.workers)
        for th in threads:
            th.join(timeout=60)
        trickle = threading.Thread(target=calm_trickle, daemon=True)
        trickle.start()
        res["ebb"] = _tick_until(
            arbiter, thread, lambda l: (_completed(watch(l))
                                and l["direction"] == "serve_to_train"),
            deadline_s=60.0)
        res["split"] = dict(arbiter.split)
        res["active"] = arbiter.ledger.active()
        stop_calm.set()
        trickle.join(timeout=60)
        res["serve_after"] = len(plane.workers)
        _join(thread, box, log_path)
        res["log"] = open(log_path).read()
        res["entries"] = _parse_steps(log_path)
        res["causes"] = dict(driver.preempt_causes)
        res["fail_counts"] = dict(driver.fail_counts)
        res["blacklist"] = set(driver.blacklist)
    finally:
        stop_calm.set()
        plane.stop()
        driver.server.stop()
    return res


def test_round_trip_lends_the_only_slot_and_takes_it_back(round_trip):
    surge, ebb = round_trip["surge"], round_trip["ebb"]
    assert _completed(surge) and surge["direction"] == "train_to_serve"
    assert surge["wids"] == ["localhost:0"]
    assert round_trip["serve_workers"] == 2
    assert _completed(ebb) and ebb["direction"] == "serve_to_train"
    assert ebb["wids"] == ["localhost:1"]
    assert round_trip["split"] == {"train": 1, "serve": 1, "leased": 0}
    assert round_trip["active"] is None
    assert round_trip["serve_after"] == 1
    states = [s for _, s in round_trip["states"]]
    assert states == ["preempting", "resharding", "activating", "complete",
                      "draining", "returning", "complete"], states


def test_round_trip_resumes_from_the_hand_off_commit(round_trip):
    entries = round_trip["entries"]
    _assert_trajectory(entries, round_trip["steps"])
    # Two processes, one after the other, each step logged once.
    assert len(entries) == round_trip["steps"]
    pids = [e[5] for e in entries]
    assert len(set(pids)) == 2 and pids == sorted(pids, key=pids.index)
    saved = re.findall(r"SAVED step=(\d+)", round_trip["log"])
    resumed = re.findall(r"RESUMED step=(\d+)", round_trip["log"])
    assert saved == resumed and len(saved) == 1, round_trip["log"]
    first = [e for e in entries if e[5] == pids[0]]
    assert int(resumed[0]) == first[-1][1] + 1


def test_round_trip_counts_a_transfer_and_loses_no_request(round_trip):
    assert round_trip["causes"] == {"preempt": 0, "arbiter_transfer": 1}
    assert round_trip["fail_counts"] == {}
    assert round_trip["blacklist"] == set()
    _assert_zero_request_loss(round_trip["burst"])
    _assert_zero_request_loss(round_trip["calm"])

"""The port's fleet arbiter against the JAX package's
(``horovod_tpu_torch/fleet/`` vs ``horovod_tpu/fleet/``), in process: the
lease spec's transitions and resume rules over every (direction, state);
the policy's decisions on scripted pressure; the ledger's records, keys
and split on a ``MemoryBackend`` and on a journaled, term-fenced KV store;
the arbiter's ledger, marker and actuation writes, in order, with fake
actuators and probes; the ``transfer`` and ``drain`` chaos points; a
promotion mid-transfer (either package resuming either package's
journal); the operator CLI; the documented record; and the elastic
drivers' accounting of an exit 83 by cause."""

import contextlib
import io
import json
import os
import re
import types

import pytest

from horovod_tpu import chaos as jchaos
from horovod_tpu.analysis.protocol import lease_spec as jspec
from horovod_tpu.fleet import actuators as jact
from horovod_tpu.fleet import arbiter as jarb
from horovod_tpu.fleet import cli as jcli
from horovod_tpu.fleet import ledger as jled
from horovod_tpu.fleet import policy as jpol
from horovod_tpu.runner import elastic_driver as jdrv
from horovod_tpu.runner import http_server as jserver
from horovod_tpu.runner import job as jjob
from horovod_tpu.runner import journal as jjournal
from horovod_tpu_torch import chaos as tchaos
from horovod_tpu_torch.analysis.protocol import lease_spec as tspec
from horovod_tpu_torch.fleet import actuators as tact
from horovod_tpu_torch.fleet import arbiter as tarb
from horovod_tpu_torch.fleet import cli as tcli
from horovod_tpu_torch.fleet import ledger as tled
from horovod_tpu_torch.fleet import policy as tpol
from horovod_tpu_torch.runner import elastic_driver as tdrv
from horovod_tpu_torch.runner import http_server as tserver
from horovod_tpu_torch.runner import job as tjob
from horovod_tpu_torch.runner import journal as tjournal
from test_torch_port_runner import _fake_spawn

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

PKGS = {
    "jax": types.SimpleNamespace(spec=jspec, ledger=jled, policy=jpol,
                                 arbiter=jarb, act=jact, cli=jcli,
                                 chaos=jchaos, server=jserver,
                                 journal=jjournal, drv=jdrv, job=jjob),
    "port": types.SimpleNamespace(spec=tspec, ledger=tled, policy=tpol,
                                  arbiter=tarb, act=tact, cli=tcli,
                                  chaos=tchaos, server=tserver,
                                  journal=tjournal, drv=tdrv, job=tjob),
}
J, T = PKGS["jax"], PKGS["port"]


@pytest.fixture(autouse=True)
def _fresh_kv_clients():
    """The KV clients keep the highest store term they saw per process;
    a term-1 store here must not leave it for later tests."""
    yield
    from horovod_tpu.runner import http_client as jclient
    from horovod_tpu_torch.runner import http_client as tclient
    jclient.reset_failover()
    tclient.reset_failover()


def _outcome(fn, *args):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the comparison is the point
        return ("raise", type(e).__name__, str(e))


# -- the lease spec -----------------------------------------------------------

STATES = sorted({s for chain in jspec.CHAINS.values() for s in chain}
                | {"rolled_back", "bogus"})


@pytest.mark.parametrize("direction", jspec.DIRECTIONS)
def test_lease_spec_transitions_and_resume_equal_the_jax_package(direction):
    assert tspec.CHAINS == jspec.CHAINS
    assert tspec.TERMINAL_STATES == jspec.TERMINAL_STATES
    assert tspec.DIRECTIONS == jspec.DIRECTIONS
    for state in STATES:
        assert _outcome(tspec.next_state, direction, state) \
            == _outcome(jspec.next_state, direction, state)
        lease = {"id": "L", "direction": direction, "state": state}
        assert _outcome(tspec.resume_action, lease) \
            == _outcome(jspec.resume_action, lease)
        for target in STATES:
            got = _outcome(tspec.check_transition, lease, target)
            assert got == _outcome(jspec.check_transition, lease, target)
            # The rule itself: rollback only from proposed, else the
            # chain successor.
            legal = (target == "rolled_back" and state == "proposed") or (
                state in jspec.CHAINS[direction]
                and target == jspec.next_state(direction, state))
            assert (got[0] == "ok") == legal, (state, target, got)


def test_the_ledger_executes_the_lease_spec():
    assert tled.resume_action is tspec.resume_action
    assert tled.check_transition is tspec.check_transition
    assert tled.LeaseStateError is tspec.LeaseStateError
    for name in ("SCOPE", "ACTIVE_KEY", "SPLIT_KEY", "LEASE_PREFIX",
                 "TRANSFER_PREFIX"):
        assert getattr(tled, name) == getattr(jled, name)


# -- the policy ---------------------------------------------------------------

HOT = {"serve.0": {"queue_depth": 10, "running": 2, "p99_latency": 0.1}}
COLD = {"serve.0": {"queue_depth": 0, "running": 0, "p99_latency": 0.0}}
SLOW = {"serve.0": {"queue_depth": 1, "running": 1, "p99_latency": 2.0}}
POLICY = dict(min_train_slots=1, min_serve_slots=1, window=2,
              cooldown_s=0.0, ebb_idle_s=5.0, scale_up_depth=8,
              slo_p99=0.5)

# name: (policy overrides, split, [(stats, leased, idle, note_transfer)])
SCENARIOS = {
    "window": ({}, {"train": 4, "serve": 1},
               [(HOT, 0, False, False)] * 4),
    "p99_breach": ({}, {"train": 4, "serve": 1},
                   [(SLOW, 0, False, False)] * 3),
    "slo_off": ({"slo_p99": 0}, {"train": 4, "serve": 1},
                [(SLOW, 0, False, False)] * 5),
    "training_idle": ({"window": 3}, {"train": 4, "serve": 1},
                      [(HOT, 0, True, False), (HOT, 0, False, False)]),
    "min_train_floor": ({"min_train_slots": 4}, {"train": 4, "serve": 1},
                        [(HOT, 0, False, False)] * 5),
    "cooldown": ({"cooldown_s": 100.0}, {"train": 4, "serve": 1},
                 [(HOT, 0, False, False), (HOT, 0, False, True)]
                 + [(HOT, 0, False, False)] * 5),
    "ebb": ({}, {"train": 3, "serve": 2}, [(COLD, 1, False, False)] * 10),
    "no_ebb_without_lease": ({}, {"train": 3, "serve": 2},
                             [(COLD, 0, False, False)] * 10),
    "min_serve_floor": ({"ebb_idle_s": 1.0, "min_serve_slots": 2},
                        {"train": 3, "serve": 2},
                        [(COLD, 1, False, False)] * 10),
    "surge_then_calm": ({"cooldown_s": 3.0}, {"train": 3, "serve": 2},
                        [(HOT, 0, False, False), (HOT, 0, False, True)]
                        + [(COLD, 1, False, False)] * 8),
}


def _decisions(pkg, name):
    over, split, script = SCENARIOS[name]
    pol = pkg.policy.FleetPolicy(**{**POLICY, **over})
    out = []
    for t, (stats, leased, idle, note) in enumerate(script):
        d = pol.decide(split, stats, leased, now=float(t), train_idle=idle)
        out.append(None if d is None else tuple(d))
        if note:
            pol.note_transfer(float(t))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decisions_equal_the_jax_package(name):
    got = _decisions(T, name)
    assert got == _decisions(J, name)
    fired = [d for d in got if d is not None]
    if name in ("slo_off", "min_train_floor", "no_ebb_without_lease",
                "min_serve_floor"):
        assert fired == []
    elif name == "window":
        assert got[0] is None and got[1][0] == "train_to_serve"
        assert "pressure" in got[1][2]
    elif name == "p99_breach":
        assert "SLO" in fired[0][2]
    elif name == "training_idle":
        assert got[0] is not None and "idle" in got[0][2]
    elif name == "cooldown":
        assert got[1] is not None and fired == [got[1]]
    elif name in ("ebb", "surge_then_calm"):
        assert fired[-1][0] == "serve_to_train"


def test_fleet_knobs_equal_the_jax_package(monkeypatch):
    assert tpol.fleet_knobs() == jpol.fleet_knobs()
    for name, value in (("HVDTPU_FLEET_WINDOW", "1"),
                        ("HVDTPU_FLEET_COOLDOWN", "2.5"),
                        ("HVDTPU_FLEET_EBB_IDLE_S", "4"),
                        ("HVDTPU_FLEET_MIN_TRAIN_SLOTS", "0"),
                        ("HVDTPU_FLEET_TICK_S", "0.25"),
                        ("HVDTPU_SERVING_SLO_P99", "0.3")):
        monkeypatch.setenv(name, value)
    assert tpol.fleet_knobs() == jpol.fleet_knobs()
    pt, pj = tpol.FleetPolicy(), jpol.FleetPolicy()
    assert vars(pt) == vars(pj)
    assert pt.window == 1 and pt.min_train_slots == 0


# -- the ledger ---------------------------------------------------------------

def _ledger_script(led):
    led.set_split(4, 1)
    lease = led.open("train_to_serve", 1, now=1000.25)
    led.mark_transfer("h:3", lease["id"])
    lease = led.advance(lease, "preempting", now=1001.5, wids=["h:3"],
                        train_slots=3, serve_slots=2)
    for state in ("resharding", "activating", "complete"):
        lease = led.advance(lease, state, now=1002.0)
    led.clear_transfer("h:3")
    led.set_split(3, 2, leased=1)
    ebb = led.open("serve_to_train", 1, now=1010.0)
    led.advance(ebb, "rolled_back", now=1011.0)
    return led.split(), led.active(), led.get(lease["id"])


def test_ledger_records_equal_on_a_memory_backend():
    lt, lj = (tled.LeaseLedger(tled.MemoryBackend()),
              jled.LeaseLedger(jled.MemoryBackend()))
    assert _ledger_script(lt) == _ledger_script(lj)
    assert lt.backend.data == lj.backend.data
    assert lt.split() == {"train": 3, "serve": 2, "leased": 1}
    assert lt.active() is None


def _journaled_store(pkg, path, term=1):
    server = pkg.server.KVStoreServer(job_token="t", addr="localhost")
    server.set_term(term)
    server.start()
    journal = pkg.journal.DriverJournal(str(path), term=term)
    return server, journal


def test_ledger_records_equal_on_a_journaled_kv_store(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        server, journal = _journaled_store(pkg, tmp_path / name)
        try:
            led = pkg.ledger.LeaseLedger(pkg.ledger.DriverBackend(
                server, journal=journal, term_fn=lambda: 1))
            result = _ledger_script(led)
            live = {k: server.get("fleet", k)
                    for k in server.scope_keys("fleet")}
        finally:
            journal.close()
            server.stop()
        state, _seq, _snap = pkg.journal.read_dir(str(tmp_path / name))
        got[name] = (result, live, state["kv"]["fleet"])
    assert got["port"] == got["jax"]
    result, live, durable = got["port"]
    assert {k: v.decode() for k, v in live.items()} == durable
    assert json.loads(durable["split"]) == result[0]


def test_http_backend_reads_what_the_driver_backend_wrote(tmp_path):
    server, journal = _journaled_store(T, tmp_path / "j")
    server.attach_journal(journal)
    try:
        led = tled.LeaseLedger(tled.DriverBackend(server, journal=journal,
                                                  term_fn=lambda: 1))
        led.set_split(2, 1)
        lease = led.open("train_to_serve", 1, now=5.0)
        for pkg in (T, J):
            over_http = pkg.ledger.LeaseLedger(pkg.ledger.HttpBackend(
                "localhost", server.port, token="t"))
            assert over_http.split() == {"train": 2, "serve": 1,
                                         "leased": 0}
            assert over_http.active() == lease
        # An HTTP mutation of the durable scope is journaled by the store.
        tled.LeaseLedger(tled.HttpBackend("localhost", server.port,
                                          token="t")).mark_transfer(
            "localhost:1", lease["id"])
    finally:
        journal.close()
        server.stop()
    state, _, _ = tjournal.read_dir(str(tmp_path / "j"))
    assert state["kv"]["fleet"]["transfer.localhost:1"] == lease["id"]


# -- the arbiter, with fake actuators and probes ------------------------------

class _RecordingBackend:
    """Appends each ledger write to ``rec``, the one ordered event list
    that the fake actuators append to as well."""

    def __init__(self, inner, rec):
        self.inner, self.rec = inner, rec

    def put(self, key, value):
        self.rec.append(("put", key, value))
        self.inner.put(key, value)

    def get(self, key):
        return self.inner.get(key)

    def delete(self, key):
        self.rec.append(("delete", key))
        self.inner.delete(key)


class FakeActuators:
    def __init__(self, rec, train=4, serve=1):
        self.rec, self.train, self.serve = rec, train, serve

    def pick_train_victims(self, old, new):
        return [f"h:{i}" for i in range(new, old)]

    def pick_serve_victims(self, old, new):
        return [f"h:{i}" for i in range(new, old)]

    def set_train_slots(self, n):
        self.train = n
        self.rec.append(("train", n))

    def set_serve_slots(self, n):
        self.serve = n
        self.rec.append(("serve", n))

    def drain(self, wid):
        self.rec.append(("drain", wid))


class FakeProbes:
    def __init__(self, act):
        self.act = act

    def train_size(self):
        return self.act.train

    def train_victims_gone(self, victims):
        return True

    def serve_size(self):
        return self.act.serve

    def serve_drained(self, victims):
        return True

    def cohort_stats(self):
        return {}


def _arbiter(pkg, rec, backend=None, train=4, serve=1, **pol):
    pol.setdefault("cooldown_s", 50.0)
    led = pkg.ledger.LeaseLedger(_RecordingBackend(
        backend if backend is not None else pkg.ledger.MemoryBackend(),
        rec))
    act = FakeActuators(rec, train, serve)
    arb = pkg.arbiter.FleetArbiter(
        led, act, FakeProbes(act),
        policy=pkg.policy.FleetPolicy(**{**POLICY, **pol}),
        train_slots=train, serve_slots=serve, drain_timeout=30.0,
        tick_s=0.01)
    return arb, act, led


def _drive(arb, script, t0=1000.0):
    """``script`` = [(stats, ticks)]; returns the states seen per tick."""
    seen, now = [], t0
    for stats, ticks in script:
        arb.stats_fn = lambda stats=stats: stats
        for _ in range(ticks):
            lease = arb.tick(now)
            seen.append(None if lease is None
                        else (lease["direction"], lease["state"]))
            now += 1.0
    return seen


def _surge_and_ebb(pkg):
    rec = []
    arb, act, led = _arbiter(pkg, rec, cooldown_s=5.0)
    seen = _drive(arb, [(HOT, 6), (COLD, 14)])
    return rec, seen, arb.split, led.active()


def test_arbiter_writes_equal_the_jax_package_in_order():
    got, want = _surge_and_ebb(T), _surge_and_ebb(J)
    assert got == want
    events, seen, split, active = got
    assert ("train_to_serve", "complete") in seen
    assert ("serve_to_train", "complete") in seen
    assert split == {"train": 4, "serve": 1, "leased": 0}
    assert active is None
    kinds = [e[0] if e[0] != "put" else e[1].split(".")[0] for e in events]
    # Ledger before actuation: the marker and the 'preempting' record
    # precede the training shrink; the drain precedes the serving shrink.
    shrink = events.index(("train", 3))
    assert kinds.index("transfer") < shrink
    assert any(e[0] == "put" and '"preempting"' in e[2]
               for e in events[:shrink])
    assert events.index(("drain", "h:1")) < events.index(("serve", 1))
    assert ("delete", "transfer.h:3") in events


def test_arbiter_threaded_loop_completes_a_surge():
    rec = []
    arb, act, led = _arbiter(T, rec, cooldown_s=1e9)
    arb.stats_fn = lambda: HOT
    arb.start()
    try:
        import time
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and arb.split["serve"] != 2:
            time.sleep(0.01)
    finally:
        arb.stop()
    assert arb.split == {"train": 3, "serve": 2, "leased": 1}
    assert led.split() == arb.split and led.active() is None


# -- the chaos points ---------------------------------------------------------

def test_transfer_and_drain_points_parse_alike():
    spec = ("transfer:fail:name=preempting:kind=train_to_serve:once;"
            "drain:delay:ms=10")
    got = [(r.point, r.action) for r in tchaos.parse_spec(spec)]
    assert got == [(r.point, r.action) for r in jchaos.parse_spec(spec)]
    assert got == [("transfer", "fail"), ("drain", "delay")]
    for pkg in (tchaos, jchaos):
        with pytest.raises(pkg.ChaosSpecError):
            pkg.parse_spec("fleet:fail")


@pytest.fixture
def chaos_env(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("HVDTPU_CHAOS", spec)
        tchaos.reset()
        jchaos.reset()
    yield arm
    monkeypatch.delenv("HVDTPU_CHAOS", raising=False)
    tchaos.reset()
    jchaos.reset()


def _faulted(pkg, script):
    rec = []
    arb, act, led = _arbiter(pkg, rec, cooldown_s=0.0)
    now = 1000.0
    for stats in script:
        arb.stats_fn = lambda stats=stats: stats
        try:
            arb.tick(now)
        except Exception as e:  # noqa: BLE001
            return rec, led.active(), type(e).__name__
        now += 1.0
    return rec, led.active(), None


def test_transfer_fault_fires_after_the_ledger_write(chaos_env):
    chaos_env("transfer:fail:name=preempting:once")
    got = _faulted(T, [HOT, HOT])
    assert got == _faulted(J, [HOT, HOT])
    events, active, err = got
    assert err is not None
    assert active["state"] == "preempting"
    assert events[-1][0] == "put" and '"preempting"' in events[-1][2]
    assert ("train", 3) not in events   # the actuation never ran


def test_drain_fault_fires_after_the_ledger_write(chaos_env):
    chaos_env("drain:fail:once")
    script = [HOT] * 6 + [COLD] * 8
    rec = []
    arb, act, led = _arbiter(T, rec, cooldown_s=0.0, ebb_idle_s=2.0)
    flags = []
    tact_ = tact.TargetFileActuators("/nonexistent/t", "/nonexistent/s",
                                     kv_put=lambda *a: flags.append(a))
    act.drain = tact_.drain
    now, err = 1000.0, None
    for stats in script:
        arb.stats_fn = lambda stats=stats: stats
        try:
            arb.tick(now)
        except Exception as e:  # noqa: BLE001
            err = e
            break
        now += 1.0
    assert err is not None and "chaos" in str(err)
    assert led.active()["state"] == "draining"
    assert flags == []                  # the flag was never raised


# -- recovery: a promotion mid-transfer -----------------------------------------

def _promote(pkg, jdir, term=2):
    """Replay the dead primary's journal into a fresh store: the standby
    promotion's data path."""
    state, _seq, _snap = pkg.journal.read_dir(str(jdir))
    server = pkg.server.KVStoreServer(job_token="t", addr="localhost")
    server.set_term(term)
    server.start()
    server.load_state(state["kv"])
    return pkg.ledger.LeaseLedger(pkg.ledger.DriverBackend(
        server, journal=None, term_fn=lambda: term)), server


@pytest.mark.parametrize("writer,resumer", [("port", "port"),
                                            ("jax", "port"),
                                            ("port", "jax")])
def test_promotion_mid_transfer_rolls_forward(tmp_path, writer, resumer):
    w, r = PKGS[writer], PKGS[resumer]
    server, journal = _journaled_store(w, tmp_path / "j")
    try:
        arb, _act, _led = _arbiter(
            w, [], backend=w.ledger.DriverBackend(
                server, journal=journal, term_fn=lambda: 1))
        arb.stats_fn = lambda: HOT
        arb.tick(1000.0)
        arb.tick(1001.0)            # proposed -> preempting (+ actuation)
    finally:
        journal.close()
        server.stop()
    led2, server2 = _promote(r, tmp_path / "j")
    try:
        lease = led2.active()
        assert lease["state"] == "preempting"
        rec = []
        act2 = FakeActuators(rec, train=4, serve=1)
        arb2 = r.arbiter.FleetArbiter(
            led2, act2, FakeProbes(act2),
            policy=r.policy.FleetPolicy(**{**POLICY, "window": 100}),
            drain_timeout=30.0)
        assert arb2.resume() == "roll_forward"
        assert rec == [("train", 3)]   # the same desired state
        _drive(arb2, [(HOT, 6)], t0=2000.0)
        assert led2.active() is None
        assert led2.get(lease["id"])["state"] == "complete"
        assert arb2.split == {"train": 3, "serve": 2, "leased": 1}
    finally:
        server2.stop()


@pytest.mark.parametrize("writer,resumer", [("port", "port"),
                                            ("jax", "port")])
def test_lease_left_at_proposed_rolls_back(tmp_path, writer, resumer):
    w, r = PKGS[writer], PKGS[resumer]
    server, journal = _journaled_store(w, tmp_path / "j")
    try:
        led = w.ledger.LeaseLedger(w.ledger.DriverBackend(
            server, journal=journal, term_fn=lambda: 1))
        led.set_split(4, 1, leased=0)
        led.open("train_to_serve", 1, now=1000.0)      # crash here
    finally:
        journal.close()
        server.stop()
    led2, server2 = _promote(r, tmp_path / "j")
    try:
        lease = led2.active()
        assert lease["state"] == "proposed"
        rec = []
        act2 = FakeActuators(rec)
        arb2 = r.arbiter.FleetArbiter(
            led2, act2, FakeProbes(act2),
            policy=r.policy.FleetPolicy(**POLICY), drain_timeout=30.0)
        assert arb2.resume() == "rollback"
        assert led2.active() is None
        assert led2.get(lease["id"])["state"] == "rolled_back"
        assert rec == []                  # rollback actuates nothing
        assert arb2.split == {"train": 4, "serve": 1, "leased": 0}
    finally:
        server2.stop()


def test_a_stale_term_is_fenced():
    server = tserver.KVStoreServer(job_token="t", addr="localhost")
    server.set_term(1)
    server.start()
    try:
        led = tled.LeaseLedger(tled.DriverBackend(server, journal=None,
                                                  term_fn=lambda: 1))
        led.set_split(4, 1)
        server.set_term(2)          # a newer primary took over
        with pytest.raises(tjournal.StaleTermError, match="1.*2|2.*1"):
            led.open("train_to_serve", 1)
        assert server.get("fleet", "active") is None
    finally:
        server.stop()


# -- actuators and probes -----------------------------------------------------

def test_target_file_actuators_write_what_the_jax_ones_write(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        flags = []
        a = pkg.act.TargetFileActuators(
            str(tmp_path / f"{name}.train"), str(tmp_path / f"{name}.serve"),
            serve_cohort="serve", kv_put=lambda *x, f=flags: f.append(x))
        calls = [a.pick_train_victims(4, 3), a.pick_serve_victims(2, 1)]
        a.set_train_slots(3)
        a.set_serve_slots(0)
        a.drain("localhost:1")
        got[name] = (calls, flags,
                     (tmp_path / f"{name}.train").read_text(),
                     (tmp_path / f"{name}.serve").read_text())
    assert got["port"] == got["jax"]
    assert got["port"][0] == [["localhost:3"], ["localhost:1"]]
    assert got["port"][1] == [("serving", "drain.serve.1", "1")]
    assert got["port"][2:] == ("localhost:3\n", "\n")


def test_driver_probes_read_what_the_jax_ones_read():
    server = tserver.KVStoreServer(job_token="t", addr="localhost")
    server.start()
    try:
        server.put("serving", "member.serve.0", "a")
        server.put("serving", "member.serve.1", "b")
        server.put("serving", "member.other.0", "c")
        server.put("serving", "stats.serve.0", json.dumps(
            {"queue_depth": 0, "running": 0, "draining": False}))
        server.put("serving", "stats.serve.1", json.dumps(
            {"queue_depth": 0, "running": 0, "draining": True}))
        server.put("serving", "stats.serve.2", "not json")
        driver = types.SimpleNamespace(server=server,
                                       workers={"localhost:0": 1},
                                       stopping=[])
        got, want = [], []
        for pkg, out in ((tact, got), (jact, want)):
            p = pkg.DriverProbes(driver)
            out += [sorted(p.serve_members()), p.serve_size(),
                    p.cohort_stats(), p.train_size(),
                    p.train_victims_gone(["localhost:1"]),
                    p.train_victims_gone(["localhost:0"]),
                    p.serve_drained(["localhost:1"]),
                    p.serve_drained(["localhost:0"]),
                    p.serve_drained(["localhost:7"])]
        assert got == want
        assert got[1] == 2 and got[6] is True and got[7] is False
        # The one deliberate difference: a victim still handing off (in
        # the driver's ``stopping`` list until its process exits) is not
        # gone for the port; the JAX probe reads only ``workers``.
        driver.stopping = [(types.SimpleNamespace(worker_id="localhost:1"),
                            0.0)]
        assert not tact.DriverProbes(driver).train_victims_gone(
            ["localhost:1"])
        assert jact.DriverProbes(driver).train_victims_gone(["localhost:1"])
        driver.stopping = []
        assert tact.DriverProbes(driver).train_victims_gone(["localhost:1"])
    finally:
        server.stop()


def test_fleet_metric_families_match_jax(monkeypatch):
    from horovod_tpu.fleet import metrics as jm
    from horovod_tpu.telemetry import core as jtel
    from horovod_tpu_torch.fleet import metrics as tm
    from horovod_tpu_torch.telemetry import core as ttel
    monkeypatch.setenv("HOROVOD_TPU_METRICS", "1")
    fams = []
    for m, tel in ((tm, ttel), (jm, jtel)):
        tel.reset()
        try:
            m.transfers_total("train_to_serve", "complete").inc()
            m.lease_age_seconds().set(2.5)
            m.train_slots().set(3)
            m.serve_slots().set(2)
            snap = tel.registry().snapshot()["families"]
            fams.append({n: (f.get("type"), f.get("help"),
                             [(s.get("labels"), s.get("value"))
                              for s in f["samples"]])
                         for n, f in snap.items()
                         if n.startswith("hvd_fleet")})
        finally:
            tel.reset()
    assert fams[0] == fams[1]
    assert set(fams[0]) == {"hvd_fleet_transfers_total",
                            "hvd_fleet_lease_age_seconds",
                            "hvd_fleet_train_slots", "hvd_fleet_serve_slots"}


# -- the CLI --------------------------------------------------------------------

def _cli(pkg, argv, now=None, monkeypatch=None):
    if now is not None:
        import time
        monkeypatch.setattr(pkg.cli, "time", types.SimpleNamespace(
            time=lambda: now, sleep=time.sleep))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pkg.cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_output_equals_the_jax_package(monkeypatch):
    assert _cli(T, ["knobs"]) == _cli(J, ["knobs"])
    server = tserver.KVStoreServer(job_token="t", addr="localhost")
    server.start()
    try:
        kv = ["--kv", f"localhost:{server.port}", "--token", "t"]
        for argv in (["status", *kv], ["lease", *kv]):
            assert _cli(T, argv) == _cli(J, argv)   # nothing recorded yet
        led = tled.LeaseLedger(tled.HttpBackend("localhost", server.port,
                                                token="t"))
        led.set_split(2, 1)
        lease = led.open("train_to_serve", 1, now=100.0)
        led.advance(lease, "preempting", now=101.0, wids=["localhost:1"],
                    train_slots=1, serve_slots=2)
        for argv in (["status", *kv], ["lease", *kv],
                     ["lease", lease["id"], *kv], ["lease", "nope", *kv]):
            got = _cli(T, argv, now=112.34, monkeypatch=monkeypatch)
            assert got == _cli(J, argv, now=112.34, monkeypatch=monkeypatch)
        rc, out, _ = _cli(T, ["status", *kv], now=112.34,
                          monkeypatch=monkeypatch)
        assert rc == 0
        assert "split: train=2 serve=1 leased_out=0" in out
        assert "state=preempting" in out and "age=12.3s" in out
        assert "[x] proposed  [x] preempting  [ ] resharding" in out
    finally:
        server.stop()


def test_cli_runs_as_a_module():
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HVDTPU_")}
    env.update(PYTHONPATH=REPO, HVDTPU_FLEET_WINDOW="7")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.fleet.cli", "knobs"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"^window\s+7$", proc.stdout, re.M)
    assert proc.stdout == _cli(J, ["knobs"])[1].replace(
        "window           3", "window           7")


# -- the documented record ----------------------------------------------------

def _doc_record():
    text = open(os.path.join(REPO, "docs", "fault_tolerance.md")).read()
    section = text[text.index("### The lease ledger"):]
    block = re.search(r"```json\n(.*?)```", section, re.S).group(1)
    return json.loads(block)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_lease_record_matches_the_documented_format(pkg):
    led = PKGS[pkg].ledger.LeaseLedger(PKGS[pkg].ledger.MemoryBackend())
    doc = _doc_record()
    lease = led.open(doc["direction"], doc["slots"], now=doc["created"])
    raw = led.backend.get("lease." + lease["id"])
    assert set(json.loads(raw)) == {"id", "direction", "slots", "state",
                                    "wids", "created", "updated"}
    lease = led.advance(lease, doc["state"], now=doc["updated"],
                        wids=doc["wids"], train_slots=doc["train_slots"],
                        serve_slots=doc["serve_slots"])
    record = json.loads(led.backend.get("lease." + lease["id"]))
    assert set(record) == set(doc)
    assert {k: v for k, v in record.items() if k != "id"} \
        == {k: v for k, v in doc.items() if k != "id"}
    assert re.fullmatch(r"train_to_serve-\d+-\d+", record["id"])
    assert raw == json.dumps(json.loads(raw), sort_keys=True)


# -- the drivers' accounting of an exit 83 ------------------------------------

def _driver_accounting(pkg, monkeypatch, journal_dir=None):
    from horovod_tpu.exceptions import PREEMPT_EXIT_CODE
    es = pkg.drv.ElasticSettings(pkg.job.Settings(num_proc=3), min_np=1,
                                 journal_dir=journal_dir or "")
    driver = pkg.drv.ElasticDriver(es, ["true"])
    out = []
    exit_83 = lambda: PREEMPT_EXIT_CODE  # noqa: E731
    try:
        monkeypatch.setattr(driver, "_spawn", _fake_spawn(driver, pkg.drv))
        driver._reconcile(driver._discover_targets())
        # The arbiter, colocated with the driver, marks its victim
        # (journaled, term-stamped) BEFORE the target shrinks.
        ledger = pkg.ledger.LeaseLedger(pkg.ledger.DriverBackend(
            driver.server, journal=driver.journal, term_fn=driver._wt))
        ledger.mark_transfer("localhost:2", "lease-a")
        driver.workers["localhost:2"].proc.poll = exit_83
        out.append(driver._sweep_exits())
        out.append(dict(driver.preempt_causes))
        out.append(driver.server.get("fleet", "transfer.localhost:2"))
        # A plain cloud preemption (no marker) keeps its own cause.
        driver.workers["localhost:0"].proc.poll = exit_83
        out.append(driver._sweep_exits())
        out.append(dict(driver.preempt_causes))
        # A marked worker stopped by a shrink hands off at its commit
        # boundary: the reaping path counts it too.
        ledger.mark_transfer("localhost:1", "lease-b")
        driver._reconcile([])
        stopped, _ = driver.stopping[0]
        assert stopped.proc.terminated
        stopped.proc.poll = exit_83
        driver._reap_stopping()
        out.append(dict(driver.preempt_causes))
        out.append(driver.server.get("fleet", "transfer.localhost:1"))
        out += [driver.fail_counts, driver.blacklist]
    finally:
        if driver.journal is not None:
            driver.journal.close()
        driver.server.stop()
    return out


def test_exit_83_is_counted_by_cause_like_the_jax_driver(monkeypatch):
    got = _driver_accounting(T, monkeypatch)
    assert got == _driver_accounting(J, monkeypatch)
    assert got == [True, {"preempt": 0, "arbiter_transfer": 1}, None,
                   True, {"preempt": 1, "arbiter_transfer": 1},
                   {"preempt": 1, "arbiter_transfer": 2}, None, {}, set()]
    assert not hasattr(tdrv.ElasticDriver, "preempts")


def test_a_retired_marker_is_journaled(monkeypatch, tmp_path):
    _driver_accounting(T, monkeypatch, journal_dir=str(tmp_path / "j"))
    state, _, _ = tjournal.read_dir(str(tmp_path / "j"))
    assert state["kv"]["fleet"] == {}
    entries = [json.loads(line) for line in
               open(tmp_path / "j" / tjournal.JOURNAL_FILE)]
    fleet = [(e["op"], e["key"]) for e in entries
             if e.get("scope") == "fleet"]
    assert fleet == [("kv_put", "transfer.localhost:2"),
                     ("kv_delete", "transfer.localhost:2"),
                     ("kv_put", "transfer.localhost:1"),
                     ("kv_delete", "transfer.localhost:1")]

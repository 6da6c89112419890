"""The port's runtime checkers against the JAX package's, on the CPU.

- **Sanitizer** (``analysis/sanitizer.py``): every scenario of
  tests/test_sanitizer.py's ``TestLockOrder``, ``TestTripwire`` and
  ``TestDisabledGuard`` runs against both packages and gives the same
  outcome, with the same finding text up to the stacks.
- **Order guard** (``analysis/order_guard.py``): both packages' guards,
  fed the same seeded name streams, give byte-equal ``sync_payload``s, the
  same ``compare_payloads`` index or error, and equal ``dump`` JSON.
- **Launcher jobs** of tests/torch_port_analysis_runtime_worker.py on the
  gloo-delegated plane, two ranks, both checkers on: a clean run, its
  losses equal to the unchecked run's, and each rank's record equal to
  what the JAX guard writes for the same names; one rank swapping two
  gradient names makes every rank raise ``SubmissionOrderError`` naming
  it.
- **A CUDA collective's trace fin** waits for its done event: a stub event
  whose ``query()`` turns true later; after an abort the fin is recorded
  at once with ``err`` 1; the shutdown drain is bounded.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from horovod_tpu import coordinator as j_coord  # noqa: F401 (locks made off)
from horovod_tpu.analysis import order_guard as j_guard
from horovod_tpu.analysis import sanitizer as j_san
from horovod_tpu.exceptions import LockOrderError as JLockOrderError
from horovod_tpu.exceptions import SubmissionOrderError as JOrderError
from horovod_tpu_torch import coordinator as t_coord  # noqa: F401
from horovod_tpu_torch.analysis import order_guard as t_guard
from horovod_tpu_torch.analysis import sanitizer as t_san
from horovod_tpu_torch.exceptions import LockOrderError as TLockOrderError
from horovod_tpu_torch.exceptions import SubmissionOrderError as TOrderError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_analysis_runtime_worker.py")


def _jax_handle():
    from horovod_tpu.coordinator import Handle
    return Handle


def _torch_handle():
    from horovod_tpu_torch.coordinator import Handle
    return Handle


PACKAGES = {
    "jax": types.SimpleNamespace(san=j_san, LockOrderError=JLockOrderError,
                                 handle=_jax_handle),
    "torch": types.SimpleNamespace(san=t_san, LockOrderError=TLockOrderError,
                                   handle=_torch_handle),
}


@pytest.fixture
def both_off(monkeypatch):
    monkeypatch.delenv("HVDTPU_SANITIZE", raising=False)
    monkeypatch.delenv("HOROVOD_TPU_SANITIZE", raising=False)
    for pkg in PACKAGES.values():
        pkg.san.reset()
    yield monkeypatch
    for pkg in PACKAGES.values():
        pkg.san.reset()


def _headline(text):
    """A finding or error text up to its stacks: the lines that do not
    start with whitespace (a formatted stack's lines all do)."""
    return [ln for ln in text.splitlines() if ln and not ln[0].isspace()]


def _run(pkg, scenario, enabled, monkeypatch):
    """One scenario against one package, each with its own state: the
    package's sanitizer is reset (time.sleep restored) before and after,
    so the two packages never stack their sleep patches."""
    if enabled:
        monkeypatch.setenv("HVDTPU_SANITIZE", "1")
    else:
        monkeypatch.delenv("HVDTPU_SANITIZE", raising=False)
    pkg.san.reset()
    try:
        outcome = scenario(pkg)
        findings = [f.format() for f in pkg.san.findings()]
    finally:
        pkg.san.reset()
        monkeypatch.delenv("HVDTPU_SANITIZE", raising=False)
    return outcome, findings


def _both(scenario, monkeypatch, enabled=True):
    got = {name: _run(pkg, scenario, enabled, monkeypatch)
           for name, pkg in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _raised(pkg, fn):
    try:
        fn()
    except pkg.LockOrderError as exc:
        return _headline(str(exc))
    return None


def _on_critical_thread(pkg, fn, name="fake-cycle"):
    def body():
        pkg.san.mark_critical("fake-cycle")
        try:
            fn()
        finally:
            pkg.san.unmark_critical()
    t = threading.Thread(target=body, name=name)
    t.start()
    t.join(10)


# -- TestLockOrder ------------------------------------------------------------
def lock_abba(pkg):
    A = pkg.san.make_lock("fixture.A")
    B = pkg.san.make_lock("fixture.B")
    recorded = threading.Event()
    caught = []

    def first():
        with A:
            with B:
                pass
        recorded.set()

    def second():
        recorded.wait(5)
        try:
            with B:
                with A:
                    pass
        except pkg.LockOrderError as exc:
            caught.append(str(exc))

    for target, name in ((first, "abba-t1"), (second, "abba-t2")):
        t = threading.Thread(target=target, name=name)
        t.start()
        t.join(5)
    assert caught and "in first" in caught[0] and "in second" in caught[0]
    return _headline(caught[0])


def lock_poison(pkg):
    A = pkg.san.make_lock("poison.A")
    B = pkg.san.make_lock("poison.B")

    def nest(x, y):
        with x:
            with y:
                pass
    nest(A, B)
    err = _raised(pkg, lambda: nest(B, A))
    nest(A, B)   # the legitimate order still works
    return err


def lock_consistent(pkg):
    A = pkg.san.make_lock("ord.A")
    B = pkg.san.make_lock("ord.B")
    for _ in range(3):
        with A:
            with B:
                pass
    return "quiet"


def lock_reentrant(pkg):
    R = pkg.san.make_rlock("reent.R")
    with R:
        with R:
            pass
    return "quiet"


def lock_siblings(pkg):
    l1 = pkg.san.make_lock("pool.slot")
    l2 = pkg.san.make_lock("pool.slot")

    def nest():
        with l1:
            with l2:
                pass
    return _raised(pkg, nest)


def lock_try_acquire(pkg):
    A = pkg.san.make_lock("try.A")
    B = pkg.san.make_lock("try.B")
    with A:
        with B:
            pass
    with B:
        got = A.acquire(blocking=False)
        A.release()
    with A:
        with B:
            pass
    return got


def lock_condition(pkg):
    cond = pkg.san.make_condition("cv.test")
    with cond:
        cond.notify_all()
    with cond:
        return cond.wait(timeout=0.01)


def lock_transitive(pkg):
    A, B, C = (pkg.san.make_lock(f"tri.{n}") for n in "ABC")

    def nest(x, y):
        with x:
            with y:
                pass
    nest(A, B)
    nest(B, C)
    err = _raised(pkg, lambda: nest(C, A))
    nest(A, B)
    nest(B, C)
    return err


LOCK_ORDER = [lock_abba, lock_poison, lock_consistent, lock_reentrant,
              lock_siblings, lock_try_acquire, lock_condition,
              lock_transitive]


@pytest.mark.parametrize("scenario", LOCK_ORDER,
                         ids=[f.__name__ for f in LOCK_ORDER])
def test_lock_order_scenario_matches_the_jax_package(scenario, both_off):
    outcome, findings = _both(scenario, both_off)
    assert findings == []
    if scenario in (lock_abba, lock_poison, lock_siblings, lock_transitive):
        assert outcome and outcome[0].startswith("lock-order cycle:")
    if scenario is lock_abba:
        assert "-- current acquisition (thread 'abba-t2'):" in outcome
        assert any("(thread 'abba-t1')" in ln for ln in outcome)
    if scenario is lock_transitive:
        assert "acquiring 'tri.A' while holding 'tri.C'" in outcome[0]
        assert any("first recorded 'tri.A' -> 'tri.B'" in ln
                   for ln in outcome)


# -- TestTripwire -------------------------------------------------------------
def trip_sleep_and_wait(pkg):
    def body():
        time.sleep(pkg.san.SLEEP_ALLOWANCE_S + 0.05)
        pkg.san.check_blocking("Handle.wait", "grad.0")
    _on_critical_thread(pkg, body)
    return "ran"


def trip_pacing_and_allowed(pkg):
    def body():
        time.sleep(0.001)
        with pkg.san.allowed("bounded board I/O"):
            pkg.san.check_blocking("urlopen", "http://kv/x")
    _on_critical_thread(pkg, body)
    return "ran"


def trip_unmarked_on_exit(pkg):
    _on_critical_thread(pkg, lambda: None)
    return dict(pkg.san._state()._critical)


def trip_non_critical(pkg):
    pkg.san.check_blocking("urlopen", "http://kv/y")
    time.sleep(0.001)
    return "ran"


def trip_handle_wait(pkg):
    Handle = pkg.handle()
    got = []

    def body():
        h = Handle("tripwire.op")
        h._complete(42)
        got.append(h.wait(timeout=1))
    _on_critical_thread(pkg, body)
    return got


def trip_leak_audit(pkg):
    release = threading.Event()
    leak = threading.Thread(target=release.wait, name="leaky-worker",
                            daemon=False)
    leak.start()
    try:
        return "leaky-worker" in pkg.san.audit_shutdown()
    finally:
        release.set()
        leak.join(5)


def trip_dedupe(pkg):
    def body():
        for _ in range(5):
            pkg.san.check_blocking("urlopen", "http://kv/x")
    _on_critical_thread(pkg, body)
    return "ran"


def trip_finding_format(pkg):
    _on_critical_thread(
        pkg, lambda: pkg.san.check_blocking("Handle.wait", "grad.7"))
    (finding,) = pkg.san.findings()
    return [finding.kind, bool(finding.stack)]


def trip_nested_allowed(pkg):
    def body():
        with pkg.san.allowed("outer"):
            with pkg.san.allowed("inner"):
                pkg.san.check_blocking("urlopen", "http://kv/a")
            pkg.san.check_blocking("urlopen", "http://kv/b")
        pkg.san.check_blocking("urlopen", "http://kv/c")
    _on_critical_thread(pkg, body)
    return "ran"


def trip_daemon_audit(pkg):
    release = threading.Event()
    t = threading.Thread(target=release.wait, name="daemon-ok", daemon=True)
    t.start()
    try:
        return "daemon-ok" in pkg.san.audit_shutdown()
    finally:
        release.set()
        t.join(5)


TRIPWIRE = [trip_sleep_and_wait, trip_pacing_and_allowed,
            trip_unmarked_on_exit, trip_non_critical, trip_handle_wait,
            trip_leak_audit, trip_dedupe, trip_finding_format,
            trip_nested_allowed, trip_daemon_audit]
TRIPWIRE_FINDINGS = {
    "trip_sleep_and_wait": [
        "hvd-sanitize [blocking-call] time.sleep(0.250s) on fake-cycle "
        "thread (fake-cycle)",
        "hvd-sanitize [blocking-call] Handle.wait(grad.0) on fake-cycle "
        "thread (fake-cycle)"],
    "trip_handle_wait": [
        "hvd-sanitize [blocking-call] Handle.wait(tripwire.op) on "
        "fake-cycle thread (fake-cycle)"],
    "trip_leak_audit": [
        "hvd-sanitize [thread-leak] non-daemon thread 'leaky-worker' still "
        "alive on leaky-worker"],
    "trip_dedupe": [
        "hvd-sanitize [blocking-call] urlopen(http://kv/x) on fake-cycle "
        "thread (fake-cycle)"],
    "trip_finding_format": [
        "hvd-sanitize [blocking-call] Handle.wait(grad.7) on fake-cycle "
        "thread (fake-cycle)"],
    "trip_nested_allowed": [
        "hvd-sanitize [blocking-call] urlopen(http://kv/c) on fake-cycle "
        "thread (fake-cycle)"],
}


@pytest.mark.parametrize("scenario", TRIPWIRE,
                         ids=[f.__name__ for f in TRIPWIRE])
def test_tripwire_scenario_matches_the_jax_package(scenario, both_off):
    outcome, findings = _both(scenario, both_off)
    assert findings == TRIPWIRE_FINDINGS.get(scenario.__name__, [])
    if scenario is trip_unmarked_on_exit:
        assert outcome == {}
    if scenario is trip_handle_wait:
        assert outcome == [42]
    if scenario is trip_leak_audit:
        assert outcome is True
    if scenario is trip_daemon_audit:
        assert outcome is False


# -- TestDisabledGuard ----------------------------------------------------------
def off_plain_primitives(pkg):
    return [pkg.san.enabled(),
            type(pkg.san.make_lock("x")) is type(threading.Lock()),
            type(pkg.san.make_rlock("x")) is type(threading.RLock()),
            type(pkg.san.make_condition("x")) is threading.Condition]


def off_sleep_unpatched(pkg):
    return getattr(time.sleep, "__hvd_sanitize__", False)


def off_noops(pkg):
    pkg.san.mark_critical("anything")
    pkg.san.check_blocking("urlopen", "http://x")
    time.sleep(0.001)
    pkg.san.unmark_critical()
    return pkg.san.audit_shutdown()


DISABLED = [off_plain_primitives, off_sleep_unpatched, off_noops]


@pytest.mark.parametrize("scenario", DISABLED,
                         ids=[f.__name__ for f in DISABLED])
def test_disabled_scenario_matches_the_jax_package(scenario, both_off):
    outcome, findings = _both(scenario, both_off, enabled=False)
    assert findings == []
    assert outcome == {off_plain_primitives: [False, True, True, True],
                       off_sleep_unpatched: False,
                       off_noops: []}[scenario]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_enable_then_disable_restores_sleep(pkg, both_off):
    san = PACKAGES[pkg].san
    both_off.setenv("HVDTPU_SANITIZE", "1")
    san.reset()
    assert san.enabled() and getattr(time.sleep, "__hvd_sanitize__", False)
    both_off.delenv("HVDTPU_SANITIZE")
    san.reset()
    assert not san.enabled()
    assert not getattr(time.sleep, "__hvd_sanitize__", False)


def test_port_locks_are_plain_with_the_knob_unset(both_off):
    """With HVDTPU_SANITIZE unset the named locks the port makes through
    the factories are plain primitives (the JAX package's disabled
    path), and the coordinator holds no order guard."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.telemetry import core as telemetry
    both_off.delenv("HVDTPU_ORDER_CHECK", raising=False)
    both_off.delenv("HOROVOD_TPU_ORDER_CHECK", raising=False)
    hvd.init(device="cpu")
    try:
        coord = basics.runtime().coordinator
        assert type(coord._lock) is type(threading.Lock())
        assert coord._order_guard is None
        assert type(telemetry.registry()._lock) is type(threading.Lock())
        assert not getattr(time.sleep, "__hvd_sanitize__", False)
    finally:
        hvd.shutdown()


# -- the order guard ------------------------------------------------------------
GUARDS = {"jax": j_guard.SubmissionOrderGuard,
          "torch": t_guard.SubmissionOrderGuard}
ORDER_ERRORS = {"jax": JOrderError, "torch": TOrderError}


def _names(seed, n):
    rng = np.random.RandomState(seed)
    return [f"grad.{i}" if rng.rand() < 0.8 else f"allgather.noname.{i}"
            for i in rng.permutation(n)]


def _compare(pkg, rows):
    try:
        return ("index", GUARDS[pkg].compare_payloads(rows))
    except ORDER_ERRORS[pkg] as exc:
        return ("order", str(exc))
    except ValueError as exc:
        return ("value", str(exc))


GUARD_CASES = {
    # name: (per-rank name streams, guard kwargs per rank)
    "aligned": lambda: ([_names(1, 300)] * 2, [{}] * 2),
    "diverged": lambda: ([_names(2, 300), _names(3, 300)], [{}] * 2),
    "skewed": lambda: ([_names(4, 300), _names(4, 300)[:200]], [{}] * 2),
    "three_ranks_one_off": lambda: (
        [_names(5, 200)] * 2 + [_names(5, 200)[::-1]], [{}] * 3),
    "every_differs": lambda: ([_names(6, 128)] * 2,
                              [{"checkpoint_every": 32},
                               {"checkpoint_every": 64}]),
    "slid_out": lambda: ([_names(7, 100), _names(7, 100)[:40]],
                         [{"checkpoint_every": 4, "window": 2}] * 2),
    "no_checkpoint_yet": lambda: ([_names(8, 30)] * 2, [{}] * 2),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_order_guard_matches_the_jax_package(case, tmp_path):
    streams, kwargs = GUARD_CASES[case]()
    out = {}
    for pkg, cls in GUARDS.items():
        guards = [cls(rank=r, record=True, max_record=150, **kw)
                  for r, kw in enumerate(kwargs)]
        for g, names in zip(guards, streams):
            for i, name in enumerate(names):
                g.record(name, "allreduce", callsite=f"train.py:{i % 7}")
        payloads = [g.sync_payload() for g in guards]
        dumps = []
        for g in guards:
            path = g.dump(str(tmp_path / f"{pkg}.{{rank}}.json"))
            with open(path) as f:
                dumps.append(json.load(f))
        out[pkg] = ([p.tobytes() for p in payloads], _compare(pkg, payloads),
                    [g.digest() for g in guards], dumps)
    assert out["torch"] == out["jax"]
    verdict = out["torch"][1]
    expected = {"aligned": "index", "diverged": "order", "skewed": "index",
                "three_ranks_one_off": "order", "every_differs": "value",
                "slid_out": "index", "no_checkpoint_yet": "index"}[case]
    assert verdict[0] == expected, verdict
    if case == "three_ranks_one_off":
        assert "ranks [2] ->" in verdict[1]
    if case in ("slid_out", "no_checkpoint_yet"):
        assert verdict[1] is None
    assert out["torch"][3][0]["truncated"] == (len(streams[0]) > 150)


def test_order_guard_verify_reshapes_a_concatenated_allgather():
    names = _names(9, 200)
    guards = [t_guard.SubmissionOrderGuard(rank=r) for r in range(3)]
    for g in guards:
        for n in names:
            g.record(n)
    gathered = torch.cat([torch.from_numpy(g.sync_payload())
                          for g in guards]).numpy()
    assert guards[0].verify(gathered, 3) == 3


# -- launcher jobs (gloo-delegated plane) ---------------------------------------
JOB_ENV = {"PORT_TEST_DEVICE": "cpu", "RUNTIME_LAYERS": "2",
           "RUNTIME_HIDDEN": "32", "RUNTIME_STEPS": "6",
           "HOROVOD_TPU_ORDER_CHECK_INTERVAL": "0.5"}
CHECKED = {"HVDTPU_SANITIZE": "1", "HOROVOD_TPU_ORDER_CHECK": "1"}


def _job(mode, n, out, extra):
    from test_torch_port_guardian import _env
    out.mkdir(parents=True, exist_ok=True)
    env = _env({**JOB_ENV, **extra})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(n), "--start-timeout", "120", sys.executable, WORKER, mode,
         str(out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    res = {}
    for r in range(n):
        path = out / f"r{r}.json"
        res[r] = json.loads(path.read_text()) if path.exists() else None
    assert all(res.values()), \
        f"{mode} rc={proc.returncode}:\n" + (proc.stdout + proc.stderr)[-6000:]
    return res, proc


@pytest.fixture(scope="module")
def clean_jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runtime-checkers")
    record = str(root / "record.{rank}.json")
    checked, _ = _job("train", 2, root / "checked",
                      {**CHECKED,
                       "HOROVOD_TPU_ORDER_CHECK_RECORD": record})
    plain, _ = _job("train", 2, root / "plain", {})
    return checked, plain, record


def test_gloo_job_with_both_checkers_is_clean(clean_jobs):
    checked, plain, _ = clean_jobs
    for r, res in checked.items():
        assert res["backend"] == "gloo-global" and res["sanitize"]
        assert res["error"] is None and res["shutdown"], res
        assert res["findings"] == [] and res["leaks"] == [], res
        # the guard compared a common checkpoint at least once
        assert any(v for v in res["verified"]), res["verified"]
        assert res["losses"] == plain[r]["losses"]
        assert res["steps"] == 6 and res["guard"] > 6
    for res in plain.values():
        assert not res["sanitize"] and res["guard"] is None
        assert res["verified"] == []


def test_gloo_job_record_equals_the_jax_guards(clean_jobs, tmp_path):
    checked, _, record = clean_jobs
    for r in checked:
        with open(record.format(rank=r)) as f:
            ported = json.load(f)
        seq = ported["sequence"]
        assert ported["count"] == len(seq) == checked[r]["guard"]
        # the initial broadcasts, then each step's gradients in the order
        # they were submitted
        grads = [e["name"] for e in seq if e["kind"] == "allreduce"]
        per_step = len(grads) // checked[r]["steps"]
        assert [e["kind"] for e in seq[:len(seq) - len(grads)]] == \
            ["broadcast"] * (len(seq) - len(grads))
        assert grads == [f"grad.{i}" for _ in range(checked[r]["steps"])
                         for i in range(per_step)]
        jg = j_guard.SubmissionOrderGuard(rank=r, record=True)
        for e in seq:
            jg.record(e["name"], e["kind"], callsite=e["site"])
        with open(jg.dump(str(tmp_path / "jax.{rank}.json"))) as f:
            assert json.load(f) == ported


def test_gloo_job_swapped_order_raises_on_every_rank(tmp_path):
    res, _ = _job("swap", 2, tmp_path / "swap",
                  {**CHECKED, "RUNTIME_SWAP_RANK": "1",
                   "RUNTIME_SWAP_DEADLINE": "60"})
    for r, one in res.items():
        assert one["error"] and one["error"].startswith(
            "SubmissionOrderError: collective submission order diverged"), \
            (r, one["error"])
        assert "ranks [1] ->" in one["error"] and "ranks [0] ->" in \
            one["error"]
        assert one["swap_s"] is not None and one["swap_s"] < 30


# -- fault 1: a CUDA fin at completion --------------------------------------------
class _StubEvent:
    def __init__(self):
        self.done = False
        self.queries = 0

    def query(self):
        self.queries += 1
        return self.done


class _StubClock:
    def __init__(self, wall):
        self.wall = wall

    def wall_of(self, event):
        return self.wall


def _coordinator(tracer, backend):
    from horovod_tpu_torch import coordinator as tc
    coord = tc.Coordinator.__new__(tc.Coordinator)
    coord._tracer = tracer
    coord.runtime = types.SimpleNamespace(backend=backend)
    coord._lock = threading.Lock()
    coord._pending_names = {}
    return coord


def _entry(name):
    from horovod_tpu_torch.coordinator import TensorEntry
    return TensorEntry(name, "allreduce", [torch.ones(2)],
                       types.SimpleNamespace(process_set_id=0))


def _fins(tracer):
    return [r for r in tracer._flight.snapshot() if r["e"] == "fin"]


def test_cuda_fin_is_stamped_when_its_done_event_completes():
    from horovod_tpu_torch.tracing import recorder
    tracer = recorder.Tracer(0, 1, "0",
                             flight=recorder.FlightRecorder(64))
    backend = types.SimpleNamespace(aborted=False)
    backend.device_aborted = lambda: backend.aborted
    coord = _coordinator(tracer, backend)
    shared, late = _StubEvent(), _StubEvent()
    a, b, c, host = (_entry(n) for n in ("grad.0", "grad.1", "grad.2",
                                          "host.0"))
    for e in (a, b, c, host):
        tracer.on_submit(e)
    a.device_done = b.device_done = (shared, _StubClock(100.25))
    c.device_done = (late, _StubClock(200.5))
    for e in (a, b, c):
        coord._entry_done(e)
    coord._entry_done(host)      # no device event: stamped now
    assert [r["n"] for r in _fins(tracer)] == ["host.0"]
    coord._poll_device_fins()
    assert [r["n"] for r in _fins(tracer)] == ["host.0"]
    shared.done = True
    coord._poll_device_fins()
    fins = _fins(tracer)
    assert [(r["n"], r["t"]) for r in fins[1:]] == [("grad.0", 100.25),
                                                    ("grad.1", 100.25)]
    assert all("err" not in r for r in fins)
    # one query per poll of the shared event, not one per entry
    assert shared.queries == 2
    assert tracer.device_pending()
    late.done = True
    coord._poll_device_fins()
    assert [(r["n"], r["t"], r["o"]) for r in _fins(tracer)[3:]] == [
        ("grad.2", 200.5, 1)]
    assert not tracer.device_pending()


def test_cuda_fin_after_an_abort_is_an_error_at_once():
    from horovod_tpu_torch.tracing import recorder
    tracer = recorder.Tracer(0, 1, "0",
                             flight=recorder.FlightRecorder(64))
    backend = types.SimpleNamespace(aborted=False)
    backend.device_aborted = lambda: backend.aborted
    coord = _coordinator(tracer, backend)
    never = _StubEvent()
    e = _entry("grad.0")
    tracer.on_submit(e)
    e.device_done = (never, _StubClock(1.0))
    coord._entry_done(e)
    coord._poll_device_fins()
    assert _fins(tracer) == []
    backend.aborted = True
    t0 = time.time()
    coord._poll_device_fins()
    (fin,) = _fins(tracer)
    assert fin["err"] == 1 and fin["t"] >= t0
    # a failed completion is stamped now, whatever its event
    f = _entry("grad.1")
    f.device_done = (_StubEvent(), _StubClock(1.0))
    coord._entry_done(f, ok=False)
    assert _fins(tracer)[-1]["n"] == "grad.1" and _fins(tracer)[-1]["err"]


def test_cuda_fin_shutdown_drain_is_bounded():
    from horovod_tpu_torch.tracing import recorder
    tracer = recorder.Tracer(0, 1, "0",
                             flight=recorder.FlightRecorder(64))
    e = _entry("grad.0")
    tracer.on_submit(e)
    tracer.defer_complete(e, _StubEvent(), _StubClock(1.0))
    t0 = time.monotonic()
    tracer.drain_device(0.05)
    assert time.monotonic() - t0 < 1.0
    (fin,) = _fins(tracer)
    assert fin["err"] == 1 and not tracer.device_pending()


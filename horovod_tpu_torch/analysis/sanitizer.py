"""hvd-sanitize runtime layer: concurrency and liveness sanitizer (port of
``horovod_tpu/analysis/sanitizer.py``).

The control plane is a small crowd of background threads: the coordinator
cycle, the watchdog's scan thread, the heartbeat lease, the timeline and
trace writers, the runner's HTTP server, the telemetry pusher. The faults
that matter there (ABBA deadlocks, a blocking call starving the cycle, a
leaked thread pinning the process at exit) never show in tests that drive
one thread at a time. This module is the runtime half of ``hvd-sanitize``
(the static half is the HVD3xx rules in ast_lint.py).

Three instruments, all gated by ``HVDTPU_SANITIZE``:

- **Lock-order graph**: ``make_lock``/``make_rlock``/``make_condition``
  return instrumented primitives that record, per process, the order in
  which locks nest ("acquired B while holding A" = edge A->B). An
  acquisition that would close a cycle raises
  :class:`~..exceptions.LockOrderError` *before* blocking, naming both
  acquisition stacks.
- **Blocking-call tripwire**: threads that drive collectives register via
  ``mark_critical`` (the coordinator cycle and, in the port, the
  watchdog's own scan thread); ``check_blocking`` call sites at the
  blocking choke points (``Handle.wait``, the KV client's ``urlopen``,
  worker spawns) plus a patched ``time.sleep`` (flagging sleeps longer
  than ``SLEEP_ALLOWANCE_S``) record a finding when executed on a
  critical thread.
- **Shutdown thread-leak audit**: ``audit_shutdown`` (called by
  ``hvd.shutdown()``) names non-daemon threads still alive after
  teardown.

With ``HVDTPU_SANITIZE`` unset the factories return *plain*
``threading.Lock``/``RLock``/``Condition`` objects, and
``mark_critical``/``check_blocking``/``audit_shutdown`` cost one global
read and compare. ``time.sleep`` is only patched while enabled;
``reset()`` restores it. Pure stdlib: no torch or telemetry imports (the
tripwire loads from the launcher process and from inside telemetry).
"""

import threading
import time
import traceback

from ..exceptions import LockOrderError
from ..utils import envparse
from ..utils.logging_util import get_logger

# A sleep at most this long on a critical thread is pacing, not
# blocking: the cycle loop's own `time.sleep(cycle_time_s)` (<= 10 ms
# even under autotune) and chaos `delay` defaults stay under it.
SLEEP_ALLOWANCE_S = 0.2
_STACK_LIMIT = 16


class Finding:
    """One runtime finding (blocking call or thread leak)."""

    __slots__ = ("kind", "what", "thread", "stack")

    def __init__(self, kind, what, thread, stack=""):
        self.kind = kind
        self.what = what
        self.thread = thread
        self.stack = stack

    def format(self):
        return f"hvd-sanitize [{self.kind}] {self.what} on {self.thread}"


def _stack_text(skip=2):
    """Formatted stack of the caller, trimmed of sanitizer frames."""
    return "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-skip])


class _Sanitizer:
    """Per-process sanitizer state (exists only while enabled)."""

    def __init__(self):
        # Internal lock: PLAIN on purpose — instrumenting the graph's
        # own lock would recurse; it is a leaf held for dict ops only.
        self._mu = threading.Lock()
        # (holder_name, acquired_name) -> (thread_name, stack_text) at
        # the first time that nesting was observed.
        self._edges = {}
        self._adj = {}          # holder_name -> set(acquired_name)
        self._held = threading.local()
        self._allow = threading.local()  # depth of allowed() scopes
        self._critical = {}     # thread ident -> role
        self.findings = []
        self._finding_keys = set()
        self._log = get_logger()

    # -- lock-order graph --------------------------------------------------
    def _stack(self):
        held = getattr(self._held, "stack", None)
        if held is None:
            held = self._held.stack = []
        return held

    def before_acquire(self, lock, name):
        """Record nesting edges for ``name`` against every lock the
        current thread already holds; raise ``LockOrderError`` when the
        new edge closes a cycle. Runs BEFORE the real acquire so the
        report fires instead of the deadlock."""
        held = self._stack()
        if any(entry[0] is lock for entry in held):
            return  # reentrant acquire (RLock): no new ordering info
        stack_text = None
        for held_lock, held_name in held:
            if held_name == name:
                # A same-named sibling lock (two instances of one lock
                # class) nesting under itself: flag like a cycle — the
                # class has no instance order, so two threads nesting
                # opposite instances deadlock.
                self._raise_cycle(name, name, held_name)
            with self._mu:
                edge = (held_name, name)
                if edge in self._edges:
                    continue  # vetted when first recorded
                # Cycle check BEFORE recording: is held_name reachable
                # FROM name through previously recorded nestings? If
                # so, some code path acquires them in the opposite
                # order — raise WITHOUT inserting the reverse edge, or
                # the graph would be poisoned and the legitimate order
                # would raise forever after the first offender.
                if self._reachable(name, held_name):
                    first_on_path = self._first_edge_on_path(name,
                                                             held_name)
                    self._raise_cycle(name, held_name, first_on_path)
                if stack_text is None:
                    stack_text = _stack_text(skip=3)
                self._edges[edge] = (threading.current_thread().name,
                                     stack_text)
                self._adj.setdefault(held_name, set()).add(name)

    def after_acquire(self, lock, name):
        self._stack().append((lock, name))

    def after_release(self, lock):
        held = self._stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    def _reachable(self, src, dst):
        """DFS over the recorded nesting graph (caller holds _mu)."""
        seen = set()
        stack = [src]
        while stack:
            node = stack.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(self._adj.get(node, ()))
        return False

    def _first_edge_on_path(self, src, dst):
        """Some recorded edge leaving ``src`` on a path to ``dst`` —
        the reverse-order acquisition to show in the report (caller
        holds _mu). Falls back to the direct edge when present."""
        if (src, dst) in self._edges:
            return (src, dst)
        for nxt in self._adj.get(src, ()):
            if nxt == dst or self._reachable(nxt, dst):
                return (src, nxt)
        return None

    def _raise_cycle(self, acquiring, holding, edge_key_or_name):
        cur_thread = threading.current_thread().name
        cur_stack = _stack_text(skip=4)
        if acquiring == holding:
            prior = (f"(two distinct locks named {acquiring!r} nested "
                     "on one thread — a lock class cannot order its own "
                     "instances)")
        else:
            if isinstance(edge_key_or_name, tuple):
                edge = edge_key_or_name
            else:
                edge = (acquiring, holding)
            rec = self._edges.get(edge)
            if rec is None:
                prior = "(reverse-order acquisition stack not recorded)"
            else:
                prior = (f"-- first recorded {edge[0]!r} -> {edge[1]!r} "
                         f"nesting (thread {rec[0]!r}):\n{rec[1]}")
        raise LockOrderError(
            f"lock-order cycle: acquiring {acquiring!r} while holding "
            f"{holding!r} reverses a nesting recorded earlier in this "
            "process — two threads interleaving these paths can "
            "deadlock (ABBA).\n"
            f"-- current acquisition (thread {cur_thread!r}):\n"
            f"{cur_stack}{prior}\n"
            "Pick one global acquisition order (docs/lint.md, "
            "hvd-sanitize).")

    # -- blocking-call tripwire --------------------------------------------
    def mark_critical(self, role):
        self._critical[threading.get_ident()] = role

    def unmark_critical(self):
        self._critical.pop(threading.get_ident(), None)

    def critical_role(self):
        return self._critical.get(threading.get_ident())

    def push_allowed(self):
        self._allow.depth = getattr(self._allow, "depth", 0) + 1

    def pop_allowed(self):
        self._allow.depth = max(0, getattr(self._allow, "depth", 1) - 1)

    def note_blocking(self, what):
        role = self.critical_role()
        if role is None or getattr(self._allow, "depth", 0) > 0:
            return
        stack = _stack_text(skip=3)
        key = (role, what.split("(")[0], stack.splitlines()[-2:][0]
               if stack.splitlines() else "")
        thread = f"{role} thread ({threading.current_thread().name})"
        finding = Finding("blocking-call", what, thread, stack)
        with self._mu:
            # One finding (and one log line) per call-site: a blocking
            # call inside a ms-cadence loop must not grow the findings
            # list by one multi-KB stack per cycle for hours.
            if key in self._finding_keys:
                return
            self._finding_keys.add(key)
            self.findings.append(finding)
        self._log.warning(
            "hvd-sanitize: blocking call %s on the %s — it starves "
            "every in-flight collective for its duration; bound it "
            "(timeout=/deadline=) or move it off this thread. At:\n%s",
            what, thread, stack)

    # -- shutdown audit ----------------------------------------------------
    def audit_shutdown(self):
        current = threading.current_thread()
        leaks = []
        for t in threading.enumerate():
            if t is current or t is threading.main_thread():
                continue
            if t.daemon or not t.is_alive():
                continue
            leaks.append(t.name)
            with self._mu:
                self.findings.append(
                    Finding("thread-leak", f"non-daemon thread "
                            f"{t.name!r} still alive", t.name))
        if leaks:
            self._log.warning(
                "hvd-sanitize: %d non-daemon thread(s) still alive "
                "after shutdown(): %s — they will keep the process "
                "from exiting (start with daemon=True or join them "
                "before shutdown)", len(leaks), ", ".join(sorted(leaks)))
        return leaks


# -- instrumented primitives ------------------------------------------------

class TrackedLock:
    """A named Lock/RLock wrapper feeding the lock-order graph. Supports
    the full acquire/release + context-manager surface, and delegates
    the private Condition hooks so ``threading.Condition`` can wrap a
    tracked RLock."""

    __slots__ = ("_lock", "_name", "_san")

    def __init__(self, lock, name, san):
        self._lock = lock
        self._name = name
        self._san = san

    @property
    def name(self):
        return self._name

    def acquire(self, blocking=True, timeout=-1):
        # Non-blocking try-acquires are the standard deadlock-AVOIDANCE
        # pattern: they cannot deadlock, so they neither get the order
        # check (a reverse-order try is legitimate) nor record an edge
        # (a failed try must not poison the graph).
        if blocking:
            self._san.before_acquire(self, self._name)
        # Instrumented pass-through: callers own the release
        # discipline, TrackedLock.release() mirrors this acquire.
        # hvd-lint: disable=HVD302
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._san.after_acquire(self, self._name)
        return got

    def release(self):
        self._lock.release()
        self._san.after_release(self)

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._lock.locked()

    # Condition integration (only RLocks have these in CPython).
    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        state = self._lock._release_save()
        self._san.after_release(self)
        return state

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)
        self._san.after_acquire(self, self._name)


# -- module state -----------------------------------------------------------

_STATE = None       # tri-state: None = unresolved, False = off, _Sanitizer
_ORIG_SLEEP = None  # time.sleep before patching (only while enabled)
# Resolution must be serialized: two threads racing _resolve() could
# both see time.sleep unpatched, and the loser would capture the
# WRAPPER as _ORIG_SLEEP — every later sleep then recurses forever.
_RESOLVE_LOCK = threading.Lock()


# time.sleep as imported, before any patching — the fallback for a
# _traced_sleep already in flight when reset() nulls _ORIG_SLEEP.
_REAL_SLEEP = time.sleep


def _traced_sleep(seconds):
    s = _STATE
    if (s not in (None, False) and seconds > SLEEP_ALLOWANCE_S
            and s.critical_role() is not None):
        s.note_blocking(f"time.sleep({float(seconds):.3f}s)")
    orig = _ORIG_SLEEP
    (orig if orig is not None else _REAL_SLEEP)(seconds)


_traced_sleep.__hvd_sanitize__ = True


def _resolve():
    global _STATE, _ORIG_SLEEP
    with _RESOLVE_LOCK:
        if _STATE is not None:      # lost the race: already resolved
            return _STATE
        if envparse.get_bool(envparse.SANITIZE):
            state = _Sanitizer()
            if not getattr(time.sleep, "__hvd_sanitize__", False):
                _ORIG_SLEEP = time.sleep
                time.sleep = _traced_sleep
            _STATE = state
        else:
            _STATE = False
        return _STATE


def _state():
    s = _STATE
    return _resolve() if s is None else s


def enabled():
    """True when HVDTPU_SANITIZE is on. Resolved once, lazily, at the
    first factory/guard call (the telemetry/chaos pattern)."""
    return bool(_state())


def reset():
    """Drop all graph/finding state, restore ``time.sleep``, and
    re-resolve from the environment (test hook)."""
    global _STATE, _ORIG_SLEEP
    with _RESOLVE_LOCK:
        if _ORIG_SLEEP is not None:
            time.sleep = _ORIG_SLEEP
            _ORIG_SLEEP = None
        _STATE = None


def findings():
    """Recorded runtime findings (empty when disabled)."""
    s = _state()
    return list(s.findings) if s else []


def make_lock(name):
    """A ``threading.Lock`` — instrumented and named when the sanitizer
    is on, the plain primitive otherwise (zero added work)."""
    s = _state()
    if not s:
        return threading.Lock()
    return TrackedLock(threading.Lock(), name, s)


def make_rlock(name):
    s = _state()
    if not s:
        return threading.RLock()
    return TrackedLock(threading.RLock(), name, s)


def make_condition(name, lock=None):
    """A ``threading.Condition`` over a tracked RLock (or a caller-
    provided tracked lock) when on; a plain Condition otherwise."""
    s = _state()
    if not s:
        return threading.Condition(lock)
    return threading.Condition(lock if lock is not None
                               else make_rlock(name))


def mark_critical(role):
    """Register the current thread as collective-critical (cycle loop,
    watchdog): blocking calls on it become findings."""
    s = _state()
    if s:
        s.mark_critical(role)


def unmark_critical():
    s = _state()
    if s:
        s.unmark_critical()


class _AllowedScope:
    """Context manager suppressing the tripwire for calls a critical
    thread makes DELIBERATELY with a bound (the guardian's short-budget
    board I/O, an injected chaos delay). Shared no-op when disabled."""

    __slots__ = ()

    def __enter__(self):
        s = _state()
        if s:
            s.push_allowed()
        return self

    def __exit__(self, *exc):
        s = _STATE
        if s:
            s.pop_allowed()


_ALLOWED = _AllowedScope()


def allowed(reason=""):
    """``with sanitizer.allowed("bounded board I/O"):`` — mark a block
    as intentionally blocking-with-a-bound on a critical thread."""
    return _ALLOWED


def check_blocking(what, detail=""):
    """Tripwire call site for a potentially long blocking operation
    (``Handle.wait``, ``urlopen``, ``subprocess``): records a finding
    when executed on a critical thread. Disabled cost: one global read
    + compare."""
    s = _STATE
    if s is None:
        s = _resolve()
    if not s:
        return
    s.note_blocking(f"{what}({detail})" if detail else what)


def audit_shutdown():
    """Name non-daemon threads still alive after ``hvd.shutdown()``.
    Returns the leaked thread names (empty when disabled or clean)."""
    s = _state()
    if not s:
        return []
    return s.audit_shutdown()

"""Deterministic fault injection for the control plane (port of
``horovod_tpu/chaos/__init__.py``).

The elastic runtime's recovery paths (KV retry, heartbeat liveness,
graceful preemption — docs/fault_tolerance.md) are only trustworthy if
they can be exercised on demand. This subsystem threads named injection
points through the KV client, coordinator, native backend, elastic
commit loop, and heartbeat thread; ``HVDTPU_CHAOS`` selects what fires
where (grammar in spec.py, ``hvd-chaos`` CLI to validate it).

Cost model (the same contract as telemetry's disabled mode):

- **Disabled** (``HVDTPU_CHAOS`` unset): the spec resolves once, lazily,
  to the shared ``NULL_PLAN`` whose ``fire`` is empty — an injection
  point pays one global read + identity compare, allocates nothing, and
  mutates nothing. Hot paths additionally cache ``enabled()`` so the
  call itself is skipped.
- **Enabled**: rules are matched per point; every firing decision is
  driven by per-rule counters (``n``/``after``), an optional seeded RNG
  (``p``/``seed`` — crc32 of the rule text when no seed is given, so
  every process of a cohort samples identically), and an optional
  cross-process ``marker`` file (fire once per JOB, surviving elastic
  respawns). Fired injections log a warning, append to
  ``HVDTPU_CHAOS_LOG`` when set, and count
  ``hvd_chaos_injections_total{point,action}``.

A malformed spec raises ``ChaosSpecError`` at the first injection point
instead of silently disabling chaos — a chaos test that never injects
would pass for the wrong reason.

The spec grammar, points and actions are the JAX package's, so one
``HVDTPU_CHAOS`` parses the same in both packages, and every point fires
at its site: the fleet plane's ``transfer`` (fleet/arbiter.py, after each
lease transition's ledger write) and ``drain`` (fleet/actuators.py), the
serving plane's ``migrate_out`` and ``migrate_in``. An injected ``delay``
is exempt from the sanitizer's blocking tripwire.
"""

import os
import random
import signal
import time
import urllib.error
import zlib

from ..exceptions import ChaosInjectedError, HorovodInternalError
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger
from .spec import (  # noqa: F401  (re-exported API)
    ACTIONS, POINTS, SIGNAL_ACTION_POINTS, ChaosSpecError, Rule,
    parse_spec,
)


class ChaosSignal(Exception):
    """A fired *signal* action (``mismatch``/``stall``/``corrupt``):
    the effect is applied by the injection site itself, so ``inject``
    raises this for the site to catch — never an error to surface.
    The spec parser rejects signal actions at points whose sites do
    not catch it (spec.SIGNAL_ACTION_POINTS)."""

    def __init__(self, action, rule):
        super().__init__(f"chaos signal {action} ({rule.source})")
        self.action = action
        self.rule = rule


class _NullPlan:
    """Shared no-op plan when chaos is off. One instance, no state."""

    __slots__ = ()
    rules = ()

    def fire(self, point, ctx):
        pass


NULL_PLAN = _NullPlan()


def _stable_seed(text):
    """Deterministic cross-process seed (``hash()`` is salted per
    interpreter; every rank must sample the same coin flips)."""
    return zlib.crc32(text.encode())


class _RuleState:
    """A Rule plus its per-process firing state."""

    __slots__ = ("rule", "hits", "fired", "_rng")

    def __init__(self, rule):
        self.rule = rule
        self.hits = 0
        self.fired = 0
        self._rng = random.Random(
            rule.seed if rule.seed is not None
            else _stable_seed(rule.source))

    def matches(self, ctx):
        import fnmatch
        r = self.rule
        if r.rank is not None:
            rank = ctx.get("rank")
            if rank is None:
                rank = envparse.get_int(envparse.RANK, -1)
            if int(rank) != r.rank:
                return False
        if r.wid is not None:
            wid = ctx.get("wid") or envparse.get_str(envparse.WORKER_ID)
            if wid != r.wid:
                return False
        if r.after_commits is not None:
            if int(ctx.get("commits", -1)) <= r.after_commits:
                return False
        for key in ("name", "kind", "scope", "key"):
            pat = getattr(r, key)
            if pat is None:
                continue
            value = ctx.get(key)
            if value is None or not fnmatch.fnmatchcase(str(value), pat):
                return False
        return True

    def take(self):
        """Consume one firing opportunity; True when the rule fires."""
        r = self.rule
        self.hits += 1
        if self.hits <= r.after:
            return False
        if r.n is not None and self.fired >= r.n:
            return False
        if r.p is not None and self._rng.random() >= r.p:
            return False
        if r.marker:
            # Atomic create = the cross-process fire-once lease: the
            # first process to fire wins; everyone else (including a
            # respawn of the same slot) sees the marker and skips.
            try:
                open(r.marker, "x").close()
            except FileExistsError:
                return False
            except OSError:
                pass  # unwritable marker dir: still fire, just unfenced
        self.fired += 1
        return True


class Plan:
    """Parsed rules grouped by point, plus firing bookkeeping."""

    def __init__(self, rules, log_path=""):
        self.rules = list(rules)
        self._log_path = log_path
        self._by_point = {}
        for rule in self.rules:
            self._by_point.setdefault(rule.point, []).append(
                _RuleState(rule))
        self._log = get_logger()
        self._m_injections = telemetry.counter(
            "hvd_chaos_injections_total",
            "Chaos rules fired", labelnames=("point", "action"))

    def fire(self, point, ctx):
        for rs in self._by_point.get(point, ()):
            if not rs.matches(ctx):
                continue
            if not rs.take():
                continue
            self._record(rs, point, ctx)
            _execute(rs.rule, point)

    def _record(self, rs, point, ctx):
        rule = rs.rule
        self._log.warning("chaos: firing %r at %s (ctx=%s, fired=%d)",
                          rule.source, point, ctx, rs.fired)
        self._m_injections.labels(point=point, action=rule.action).inc()
        # Flight-recorder breadcrumb: a postmortem that follows an
        # injection shows the injection next to the abort it caused.
        from .. import tracing
        tracing.trace_event("chaos", rule.action, point=point,
                            rule=rule.source)
        if self._log_path:
            try:
                with open(self._log_path, "a") as f:
                    f.write(f"{os.getpid()} {point} {rule.action} "
                            f"{rule.source} fired={rs.fired}\n")
            except OSError:
                pass


def _failure_for(rule, point):
    # migrate_out failures are transport-shaped so the migration
    # client's chunk-retry machinery (not a crash) absorbs them.
    if point.startswith("kv_") or point in ("heartbeat", "migrate_out"):
        err = rule.err or "reset"
        if err == "refused":
            return urllib.error.URLError(ConnectionRefusedError(
                f"chaos: injected connection refused ({rule.source})"))
        if err == "timeout":
            return TimeoutError(
                f"chaos: injected timeout ({rule.source})")
        return urllib.error.URLError(ConnectionResetError(
            f"chaos: injected connection reset ({rule.source})"))
    if point in ("collective", "backend_submit"):
        return HorovodInternalError(
            f"chaos: injected collective failure ({rule.source})")
    return ChaosInjectedError(
        f"chaos: injected failure ({rule.source})")


def _execute(rule, point):
    action = rule.action
    if action == "delay":
        # Injected on purpose: exempt from the hvd-sanitize blocking
        # tripwire, so that a chaos run with HVDTPU_SANITIZE=1 stays quiet.
        from ..analysis import sanitizer
        with sanitizer.allowed("chaos delay injection"):
            time.sleep((rule.ms if rule.ms is not None else 100)
                       / 1000.0)
    elif action == "fail":
        raise _failure_for(rule, point)
    elif action == "hang":
        os.kill(os.getpid(), signal.SIGSTOP)
    elif action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif action == "preempt":
        os.kill(os.getpid(), signal.SIGTERM)
    elif action == "exit":
        os._exit(rule.code if rule.code is not None else 17)
    elif action in SIGNAL_ACTION_POINTS:
        raise ChaosSignal(action, rule)


_PLAN = None  # tri-state: None = not yet resolved


def _resolve():
    global _PLAN
    text = envparse.get_str(envparse.CHAOS, "")
    if not text:
        _PLAN = NULL_PLAN
    else:
        _PLAN = Plan(parse_spec(text),
                     log_path=envparse.get_str(envparse.CHAOS_LOG, ""))
    return _PLAN


def plan():
    """The resolved Plan (NULL_PLAN when chaos is off)."""
    return _PLAN if _PLAN is not None else _resolve()


def enabled():
    """True when HVDTPU_CHAOS carries at least one rule. Resolved once;
    hot paths cache this to skip the inject() call entirely."""
    return plan() is not NULL_PLAN


def reset():
    """Drop firing state and re-resolve from the environment (test
    hook; mirrors telemetry.reset)."""
    global _PLAN
    _PLAN = None


def inject(point, **ctx):
    """Fire any matching chaos rules at ``point``. The disabled path is
    one global read + identity compare."""
    p = _PLAN if _PLAN is not None else _resolve()
    if p is NULL_PLAN:
        return
    p.fire(point, ctx)

"""The fleet arbiter: the control loop over ledger, policy, and
actuators (port of ``horovod_tpu/fleet/arbiter.py``: the same ticks,
writes and their order).

One ``tick`` = read serving stats, step the in-flight lease (at most
one), else ask the policy for a new transfer. Every transition is
**ledger-before-actuation**: the new state is written durably
(journal + term fence via the backend) first, then the chaos
``transfer`` point fires, then the idempotent actuation runs — so a
crash anywhere in that sandwich is recoverable from the ledger alone.
``resume`` is the recovery half: a freshly-promoted standby's arbiter
finds the in-flight lease, rolls a ``proposed`` lease back (nothing
was actuated) and rolls anything later forward by re-issuing the
current state's actuation verbatim.

Transfer state machines (docs/fault_tolerance.md "Fleet arbitration"):

- ``train_to_serve``: proposed -> preempting (shrink the training
  target; the training driver delivers graceful SIGTERM preemption at
  the next commit boundary, victims exit 83) -> resharding (the
  shrunk cohort re-forms at the new elastic version with its committed
  state — no lost steps) -> activating (grow the serving target; freed
  slots join through the router's KV registration) -> complete.
- ``serve_to_train``: proposed -> draining (per-worker drain flags;
  accepted requests finish) -> returning (shrink serving, grow
  training back through the same planner leg) -> complete.
"""

import threading
import time

from . import ledger as ledger_mod
from . import metrics as _m
from .policy import FleetPolicy, fleet_knobs
from ..chaos import inject as _chaos_inject
from ..serving.autoscale import scale_knobs
from ..utils.logging_util import get_logger


class FleetArbiter:
    """Composes a LeaseLedger, actuators, probes, and a FleetPolicy
    into the chip-budget control loop."""

    def __init__(self, ledger, actuators, probes, *, policy=None,
                 train_slots=None, serve_slots=None, stats_fn=None,
                 train_idle_fn=None, drain_timeout=None, tick_s=None):
        self.ledger = ledger
        self.act = actuators
        self.probes = probes
        self.policy = policy if policy is not None else FleetPolicy()
        self.stats_fn = stats_fn or probes.cohort_stats
        self.train_idle_fn = train_idle_fn
        self.drain_timeout = (drain_timeout
                              if drain_timeout is not None
                              else scale_knobs()["drain_timeout"])
        self.tick_s = (tick_s if tick_s is not None
                       else fleet_knobs()["tick_s"])
        self.log = get_logger()
        self._stop = threading.Event()
        self._thread = None
        split = self.ledger.split()
        if split is None:
            if train_slots is None or serve_slots is None:
                raise ValueError(
                    "no recorded split and no initial "
                    "train_slots/serve_slots given")
            split = {"train": int(train_slots),
                     "serve": int(serve_slots), "leased": 0}
            self.ledger.set_split(**split)
        self.split = split
        self._gauge_split()

    # -- recovery ----------------------------------------------------------
    def resume(self):
        """Adopt an in-flight lease left by a previous arbiter (e.g.
        before a standby promotion). Returns the action taken:
        None / 'rollback' / 'roll_forward'."""
        lease = self.ledger.active()
        if lease is None:
            return None
        action = ledger_mod.resume_action(lease)
        if action == "rollback":
            self._finish(lease, "rolled_back")
            self.log.warning(
                "fleet arbiter: lease %s recovered at 'proposed' — "
                "nothing was actuated; rolled back", lease["id"])
        elif action == "roll_forward":
            self.log.warning(
                "fleet arbiter: lease %s recovered at %r — re-issuing "
                "its actuation and rolling forward", lease["id"],
                lease["state"])
            self._reissue(lease)
        return action

    def _reissue(self, lease):
        """Re-run the current state's entry actuation. Safe because
        every actuation is an idempotent desired-state write."""
        state = lease["state"]
        if state == "preempting":
            for wid in lease["wids"]:
                self.ledger.mark_transfer(wid, lease["id"])
            self.act.set_train_slots(lease["train_slots"])
        elif state == "resharding":
            self.act.set_train_slots(lease["train_slots"])
        elif state == "activating":
            self.act.set_serve_slots(lease["serve_slots"])
        elif state == "draining":
            for wid in lease["wids"]:
                self.act.drain(wid)
        elif state == "returning":
            self.act.set_serve_slots(lease["serve_slots"])
            self.act.set_train_slots(lease["train_slots"])

    # -- the control loop --------------------------------------------------
    def tick(self, now=None):
        """One arbiter step. Returns the in-flight lease (possibly
        just finished) or None when idle."""
        now = time.time() if now is None else now
        lease = self.ledger.active()
        if lease is not None:
            _m.lease_age_seconds().set(
                max(0.0, now - lease["created"]))
            return self._step(lease, now)
        _m.lease_age_seconds().set(0.0)
        cohorts = self.stats_fn()
        train_idle = bool(self.train_idle_fn()) \
            if self.train_idle_fn else False
        decision = self.policy.decide(
            self.split, cohorts, self.split.get("leased", 0), now,
            train_idle=train_idle)
        if decision is None:
            return None
        return self._begin(decision, now)

    def _begin(self, decision, now):
        self.log.warning("fleet arbiter: proposing %s of %d slot(s) "
                         "(%s)", decision.direction, decision.slots,
                         decision.reason)
        lease = self.ledger.open(decision.direction, decision.slots,
                                 now=now)
        self.policy.note_transfer(now)
        _chaos_inject("transfer", name="proposed",
                      kind=lease["direction"])
        return self._step(lease, now)

    def _advance(self, lease, state, now, **fields):
        """Ledger write, then chaos point, then the caller actuates —
        the one ordering everything else here relies on."""
        lease = self.ledger.advance(lease, state, now=now, **fields)
        _chaos_inject("transfer", name=state,
                      kind=lease["direction"])
        return lease

    def _step(self, lease, now):
        if lease["direction"] == ledger_mod.TRAIN_TO_SERVE:
            return self._step_surge(lease, now)
        return self._step_ebb(lease, now)

    def _step_surge(self, lease, now):
        state = lease["state"]
        if state == "proposed":
            t, m, s = (self.split["train"], self.split["serve"],
                       lease["slots"])
            victims = self.act.pick_train_victims(t, t - s)
            for wid in victims:
                self.ledger.mark_transfer(wid, lease["id"])
            lease = self._advance(lease, "preempting", now,
                                  wids=victims, train_slots=t - s,
                                  serve_slots=m + s)
            self.act.set_train_slots(t - s)
        elif state == "preempting":
            if self.probes.train_victims_gone(lease["wids"]):
                lease = self._advance(lease, "resharding", now)
        elif state == "resharding":
            if self.probes.train_size() == lease["train_slots"]:
                lease = self._advance(lease, "activating", now)
                self.act.set_serve_slots(lease["serve_slots"])
        elif state == "activating":
            if self.probes.serve_size() >= lease["serve_slots"]:
                lease = self._finish(lease, "complete", now)
        return lease

    def _step_ebb(self, lease, now):
        state = lease["state"]
        if state == "proposed":
            t, m, s = (self.split["train"], self.split["serve"],
                       lease["slots"])
            victims = self.act.pick_serve_victims(m, m - s)
            lease = self._advance(lease, "draining", now,
                                  wids=victims, train_slots=t + s,
                                  serve_slots=m - s)
            for wid in victims:
                self.act.drain(wid)
        elif state == "draining":
            drained = self.probes.serve_drained(lease["wids"])
            timed_out = now - lease["updated"] > self.drain_timeout
            if drained or timed_out:
                if timed_out and not drained:
                    self.log.warning(
                        "fleet arbiter: lease %s drain timed out "
                        "after %.0fs; returning slots anyway",
                        lease["id"], self.drain_timeout)
                lease = self._advance(lease, "returning", now)
                self.act.set_serve_slots(lease["serve_slots"])
                self.act.set_train_slots(lease["train_slots"])
        elif state == "returning":
            if self.probes.train_size() == lease["train_slots"]:
                lease = self._finish(lease, "complete", now)
        return lease

    def _finish(self, lease, outcome, now=None):
        lease = self.ledger.advance(lease, outcome, now=now)
        if outcome == "complete":
            delta = lease["slots"]
            if lease["direction"] == ledger_mod.TRAIN_TO_SERVE:
                leased = self.split.get("leased", 0) + delta
            else:
                leased = max(0, self.split.get("leased", 0) - delta)
            self.split = {"train": lease["train_slots"],
                          "serve": lease["serve_slots"],
                          "leased": leased}
            self.ledger.set_split(**self.split)
            self._gauge_split()
        for wid in lease.get("wids", ()):
            self.ledger.clear_transfer(wid)
        _m.transfers_total(lease["direction"], outcome).inc()
        self.log.warning("fleet arbiter: lease %s %s (split now "
                         "train=%d serve=%d leased=%d)", lease["id"],
                         outcome, self.split["train"],
                         self.split["serve"],
                         self.split.get("leased", 0))
        return lease

    def _gauge_split(self):
        _m.train_slots().set(self.split["train"])
        _m.serve_slots().set(self.split["serve"])

    # -- threaded mode ------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="fleet-arbiter", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must not die silently
                self.log.exception(
                    "fleet arbiter: tick failed; arbiter stopped "
                    "(the ledger holds the in-flight lease for "
                    "resume)")
                return
            self._stop.wait(self.tick_s)

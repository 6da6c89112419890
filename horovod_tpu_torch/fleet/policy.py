"""The arbiter's decision core: pressure signals in, Decision out (port
of ``horovod_tpu/fleet/policy.py``: the same rule, knobs and reasons).

Pure policy — no KV, no processes, no clocks of its own (the caller
passes ``now``), so the whole surge/ebb behaviour is unit-testable
with synthetic stats. Two signals feed one window-smoothed breach
counter, mirroring the serving autoscaler (serving/autoscale.py):

- **queue pressure**: total queued + running at or above
  ``HVDTPU_SERVING_SCALE_UP_DEPTH``;
- **p99 SLO breach**: worst per-cohort p99 end-to-end latency at or
  above ``HVDTPU_SERVING_SLO_P99`` (the slow-but-not-queued overload
  a depth trigger misses).

``window`` consecutive breached observations (one, when training
reports idle — an idle donor makes lending cheap) propose a
train->serve lease of one slot; ``HVDTPU_FLEET_EBB_IDLE_S`` of calm
with leased slots outstanding proposes the serve->train ebb.
``HVDTPU_FLEET_COOLDOWN`` spaces transfers in either direction so an
oscillating load cannot thrash the reshard machinery, and the
``HVDTPU_FLEET_MIN_*_SLOTS`` floors are never crossed.
"""

import collections

from ..serving.autoscale import scale_knobs
from ..utils import envparse

Decision = collections.namedtuple("Decision",
                                  ["direction", "slots", "reason"])


def fleet_knobs():
    return {
        "min_train_slots": envparse.get_int(
            envparse.FLEET_MIN_TRAIN_SLOTS, 1),
        "min_serve_slots": envparse.get_int(
            envparse.FLEET_MIN_SERVE_SLOTS, 1),
        "window": envparse.get_int(envparse.FLEET_WINDOW, 3),
        "cooldown_s": envparse.get_float(envparse.FLEET_COOLDOWN,
                                         30.0),
        "ebb_idle_s": envparse.get_float(envparse.FLEET_EBB_IDLE_S,
                                         60.0),
        "tick_s": envparse.get_float(envparse.FLEET_TICK_S, 1.0),
    }


class FleetPolicy:
    """Stateful smoothing around a stateless decision rule."""

    def __init__(self, *, min_train_slots=None, min_serve_slots=None,
                 window=None, cooldown_s=None, ebb_idle_s=None,
                 scale_up_depth=None, slo_p99=None):
        knobs = fleet_knobs()
        serving = scale_knobs()

        def pick(value, default):
            return default if value is None else value

        self.min_train_slots = pick(min_train_slots,
                                    knobs["min_train_slots"])
        self.min_serve_slots = pick(min_serve_slots,
                                    knobs["min_serve_slots"])
        self.window = int(pick(window, knobs["window"]))
        self.cooldown_s = float(pick(cooldown_s, knobs["cooldown_s"]))
        self.ebb_idle_s = float(pick(ebb_idle_s, knobs["ebb_idle_s"]))
        self.scale_up_depth = pick(scale_up_depth,
                                   serving["scale_up_depth"])
        self.slo_p99 = pick(slo_p99, serving["slo_p99"])
        self._streak = 0
        self._calm_since = None
        self._last_transfer = float("-inf")

    @staticmethod
    def pressure(cohorts):
        return sum(int(s.get("queue_depth", 0)) + int(s.get("running",
                                                            0))
                   for s in cohorts.values())

    @staticmethod
    def worst_p99(cohorts):
        return max((float(s.get("p99_latency") or 0.0)
                    for s in cohorts.values()), default=0.0)

    def note_transfer(self, now):
        """The arbiter opened a lease — start the cooldown."""
        self._last_transfer = now
        self._streak = 0
        self._calm_since = None

    def decide(self, split, cohorts, leased_out, now, *,
               train_idle=False):
        """One observation. ``split`` is ``{"train": n, "serve": n}``;
        ``cohorts`` the serving stats map; ``leased_out`` how many
        slots train->serve leases currently hold. Returns a Decision
        or None."""
        total = self.pressure(cohorts)
        p99 = self.worst_p99(cohorts)
        slo_breach = self.slo_p99 > 0 and p99 >= self.slo_p99
        pressured = total >= self.scale_up_depth or slo_breach
        if pressured:
            self._streak += 1
            self._calm_since = None
        else:
            self._streak = 0
            if self._calm_since is None:
                self._calm_since = now
        if now - self._last_transfer < self.cooldown_s:
            return None
        # -- surge: take a slot from training -----------------------------
        need = self.window if not train_idle else 1
        if (self._streak >= need
                and split["train"] - 1 >= self.min_train_slots):
            reason = (f"p99 {p99:.3f}s >= SLO {self.slo_p99:.3f}s"
                      if slo_breach and total < self.scale_up_depth
                      else f"pressure {total} >= {self.scale_up_depth}")
            if train_idle:
                reason += " (training idle)"
            return Decision(direction="train_to_serve", slots=1,
                            reason=reason)
        # -- ebb: return a leased slot to training ------------------------
        if (leased_out > 0 and self._calm_since is not None
                and now - self._calm_since >= self.ebb_idle_s
                and split["serve"] - 1 >= self.min_serve_slots):
            return Decision(
                direction="serve_to_train", slots=1,
                reason=(f"serving calm {now - self._calm_since:.0f}s "
                        f"with {leased_out} leased slot(s) out"))
        return None

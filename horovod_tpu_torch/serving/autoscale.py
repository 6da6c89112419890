"""Elastic autoscaling of serving cohorts from queue-depth/latency
signals (port of ``horovod_tpu/serving/autoscale.py``).

The autoscaler closes the loop between the KV-plane stats workers push
(queue depth, running count — the backpressure signals) and the
elastic machinery that owns process lifecycles:

- **scale-up**: total cohort pressure (queued + running) at or above
  ``HVDTPU_SERVING_SCALE_UP_DEPTH`` for ``window`` consecutive
  observations fires the ``scale_up`` hook (once per cooldown);
- **scale-down**: a cohort idle for ``idle_s`` fires ``drain`` first —
  in-flight and queued sequences complete, workers reject new
  admissions — and only a cohort that *reports drained-and-idle* (or
  exceeds ``HVDTPU_SERVING_DRAIN_TIMEOUT``) reaches the ``scale_down``
  hook. Scale-down never drops accepted requests.

The hooks are deliberately thin callables so the same policy core
drives any actuator. The stock actuator is the existing elastic
machinery itself: :func:`write_target` maintains a desired-host-count
file and :func:`discovery_script_lines` renders the standard elastic
discovery script that reads it — an ``ElasticDriver`` pointed at that
script reconciles the serving cohort to the autoscaler's target through
the exact spawn/stop/blacklist paths training uses
(docs/serving.md "Autoscaling").
"""

import os
import time

from ..utils import envparse
from ..utils.logging_util import get_logger


def scale_knobs():
    return {
        "scale_up_depth": envparse.get_int(
            envparse.SERVING_SCALE_UP_DEPTH, 32),
        "drain_timeout": envparse.get_float(
            envparse.SERVING_DRAIN_TIMEOUT, 30.0),
        "slo_p99": envparse.get_float(envparse.SERVING_SLO_P99, 0.0),
    }


class Autoscaler:
    """Policy core: observe cohort stats, fire scale hooks."""

    def __init__(self, scale_up, scale_down=None, drain=None, *,
                 scale_up_depth=None, drain_timeout=None, slo_p99=None,
                 window=3, cooldown_s=10.0, idle_s=30.0):
        knobs = scale_knobs()
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.drain = drain
        self.scale_up_depth = (scale_up_depth
                               if scale_up_depth is not None
                               else knobs["scale_up_depth"])
        self.drain_timeout = (drain_timeout
                              if drain_timeout is not None
                              else knobs["drain_timeout"])
        self.slo_p99 = (slo_p99 if slo_p99 is not None
                        else knobs["slo_p99"])
        self.window = int(window)
        self.cooldown_s = float(cooldown_s)
        self.idle_s = float(idle_s)
        self._breaches = 0
        self._last_scale_up = float("-inf")  # no scale-up yet
        self._idle_since = {}     # cohort -> monotonic idle start
        self._draining = {}       # cohort -> drain start
        self.events = []          # (kind, cohort-or-depth) audit log
        self._log = get_logger()

    def _pressure(self, cohort_stats):
        return int(cohort_stats.get("queue_depth", 0)) \
            + int(cohort_stats.get("running", 0))

    def observe(self, cohorts, now=None):
        """One control tick over the router's cohort view
        (``Router.stats()['cohorts']``). Returns the events fired this
        tick (also appended to ``self.events``)."""
        now = time.monotonic() if now is None else now
        fired = []
        total = sum(self._pressure(s) for s in cohorts.values())
        worst_p99 = max(
            (float(s.get("p99_latency") or 0.0)
             for s in cohorts.values()), default=0.0)
        # -- scale-up ------------------------------------------------------
        # Two breach conditions feed one window-smoothed counter: queue
        # pressure (the fast signal) and a p99 SLO violation (the
        # slow-but-not-queued overload the depth trigger misses — every
        # request admitted, each one crawling).
        slo_breach = self.slo_p99 > 0 and worst_p99 >= self.slo_p99
        if total >= self.scale_up_depth or slo_breach:
            self._breaches += 1
        else:
            self._breaches = 0
        if (self._breaches >= self.window
                and now - self._last_scale_up >= self.cooldown_s):
            self._breaches = 0
            self._last_scale_up = now
            if slo_breach and total < self.scale_up_depth:
                self._log.warning(
                    "serving autoscale: p99 %.3fs >= SLO %.3fs for %d "
                    "ticks (queue shallow at %d); scaling up",
                    worst_p99, self.slo_p99, self.window, total)
            else:
                self._log.warning(
                    "serving autoscale: pressure %d >= %d for %d "
                    "ticks; scaling up", total, self.scale_up_depth,
                    self.window)
            self.scale_up()
            fired.append(("scale_up", total))
        # -- scale-down (drain first) --------------------------------------
        for cohort, s in cohorts.items():
            if cohort in self._draining:
                started = self._draining[cohort]
                drained = (self._pressure(s) == 0
                           and s.get("queue_depth", 0) == 0)
                if drained or now - started > self.drain_timeout:
                    del self._draining[cohort]
                    if self.scale_down is not None:
                        if not drained:
                            self._log.warning(
                                "serving autoscale: cohort %s drain "
                                "timed out after %.0fs; scaling down "
                                "anyway", cohort, self.drain_timeout)
                        self.scale_down(cohort)
                        fired.append(("scale_down", cohort))
                continue
            if self._pressure(s) == 0:
                since = self._idle_since.setdefault(cohort, now)
                if (now - since >= self.idle_s
                        and self.drain is not None
                        and self.scale_down is not None
                        and len(cohorts) > 1):
                    # Never drain the last cohort: scale-to-zero is an
                    # operator decision, not an idle-timer one.
                    del self._idle_since[cohort]
                    self._draining[cohort] = now
                    self._log.warning(
                        "serving autoscale: cohort %s idle %.0fs; "
                        "draining before scale-down", cohort,
                        now - since)
                    self.drain(cohort)
                    fired.append(("drain", cohort))
            else:
                self._idle_since.pop(cohort, None)
        self.events.extend(fired)
        return fired


# --------------------------------------------------------------------------
# The stock actuator: desired-host-count file + elastic discovery script
# --------------------------------------------------------------------------

def write_target(path, hosts_per_line):
    """Atomically + durably write the desired host list (one
    ``host:slots`` per line) the discovery script serves to the
    elastic driver. fsync before the rename: a rename alone is atomic
    against concurrent readers but not against power loss — a crash
    could surface an *empty* target file, which the discovery script
    would faithfully report as "cohort of zero" and the driver would
    obediently tear everything down."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("\n".join(hosts_per_line) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def discovery_script_lines(target_file):
    """The elastic discovery script body that reconciles the serving
    cohort to the autoscaler's target file — scale-up is
    ``write_target`` + the driver's own discovery/spawn cycle, the
    same machinery that replaces failed training workers."""
    return ["#!/bin/sh", f'cat "{target_file}" 2>/dev/null || true']

"""Candidate score sources: what a knob config is judged by (port of
``horovod_tpu/autotune/score.py``).

The original tuner scored candidates by coordinator bytes/sec — a
proxy that rewards moving bytes, not finishing steps (a config that
inflates traffic scores *better*). The trace plane (PR 8) measures the
thing that actually bounds training: per-step critical-path time. This
module turns its always-on flight-recorder ring into a live score:

Every closed window reports BOTH units — ``{"bytes": rate, "steps":
rate-or-None}`` — because fallback windows and trace-scored windows
are not comparable (a bytes/sec ~1e8 would always beat a steps/sec
~10); the tuner's decisions (halving survivors, the re-validation
verdict) pick ONE unit per comparison set: steps when every window in
the set has step structure, else bytes, which every window carries.

- :class:`BytesScore` — the legacy cycle-thread bytes/sec (mean of the
  window's per-active-cycle rates). Always available.
- :class:`TraceScore` — **steps/sec** over the scoring window. A step
  is one occurrence number with every submitted collective finished
  (the same name x occurrence correlation the offline analyzer joins
  on); the window's score is completed steps over the span from the
  first submit to the last finish — submit-to-finish critical path
  plus the compute gaps between collectives, i.e. real step pacing.
  The window's mean step span and collective overlap fraction are
  published as gauges so a sweep is debuggable from /metrics. When the
  live ``hvd_straggler_delay_seconds`` gauge is being fed (a job
  running ``hvd-trace report --metrics`` alongside), this rank's newly
  attributed straggler delay stretches the effective span — a config
  that makes THIS rank the one gating peers scores worse even when its
  local throughput looks fine. Falls back to bytes/sec when the
  window saw fewer than two complete steps (or the ring is off).

``HVDTPU_AUTOTUNE_SCORE`` picks: ``auto`` (trace when it has step
structure, bytes otherwise — the default), ``steps`` (trace or loud
fallback), ``bytes`` (legacy only).

Scores stay rank-local and timing-noisy by design — the determinism
contract lives in the cycle-driven candidate switches and the
round-boundary broadcast of rank 0's survivors (core.py), not in the
scores.
"""

import time

from ..telemetry import core as telemetry
from ..utils.logging_util import get_logger

#: Minimum complete steps a window must show before steps/sec is
#: trusted over bytes/sec.
MIN_STEPS = 2


def _mean(values):
    return sum(values) / len(values) if values else 0.0


class BytesScore:
    """Legacy score: mean per-active-cycle bytes/sec of the window."""

    name = "bytes"

    def open_window(self):
        pass

    def close_window(self, cycle_rates):
        return {"bytes": _mean(cycle_rates), "steps": None}


def window_stats(events, t0, t1):
    """Step structure of the ring events in ``(t0, t1]``.

    Returns ``None`` when fewer than :data:`MIN_STEPS` occurrence
    groups completed cleanly, else a dict with ``steps`` (count),
    ``span_s`` (first submit -> last finish over the complete steps),
    ``mean_step_s`` and ``overlap_fraction`` (1 - union/total of the
    completed collectives' in-flight intervals). Groups that saw a
    finish without its submit (the submit predates the window or fell
    off the ring) are dirty and excluded rather than miscounted.
    """
    pending = {}
    groups = {}
    intervals = []
    for ev in events:
        t = ev.get("t")
        if t is None or t <= t0 or t > t1:
            continue
        kind = ev.get("e")
        if kind == "sub":
            key = (ev.get("n"), ev.get("o"))
            pending[key] = t
            g = groups.setdefault(ev.get("o"),
                                  {"sub": [], "fin": [], "open": 0,
                                   "dirty": False})
            g["sub"].append(t)
            g["open"] += 1
        elif kind == "fin":
            key = (ev.get("n"), ev.get("o"))
            sub_t = pending.pop(key, None)
            # A finish without its submit straddles the window start
            # (or the submit fell off the ring) — the whole occurrence
            # is dirty, even when the group doesn't exist yet: later
            # in-window collectives of the same occurrence must not
            # make it look like a clean (shorter) step. An err-flagged
            # finish is dirty too: a fast-FAILING collective must not
            # score as a fast step.
            g = groups.setdefault(ev.get("o"),
                                  {"sub": [], "fin": [], "open": 0,
                                   "dirty": False})
            if sub_t is None or ev.get("err"):
                g["dirty"] = True
                continue
            g["fin"].append(t)
            g["open"] -= 1
            intervals.append((sub_t, t))
    complete = [g for g in groups.values()
                if g["fin"] and not g["open"] and not g["dirty"]]
    if len(complete) < MIN_STEPS:
        return None
    first_sub = min(min(g["sub"]) for g in complete)
    last_fin = max(max(g["fin"]) for g in complete)
    span = last_fin - first_sub
    if span <= 0:
        return None
    spans = [max(g["fin"]) - min(g["sub"]) for g in complete]
    total = sum(b - a for a, b in intervals)
    union, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                union += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        union += cur[1] - cur[0]
    return {
        "steps": len(complete),
        "span_s": span,
        "mean_step_s": _mean(spans),
        "overlap_fraction": (1.0 - union / total) if total > 0 else 0.0,
    }


class TraceScore:
    """Steps/sec from the flight-recorder ring, bytes/sec fallback."""

    name = "steps"

    def __init__(self, runtime, rank=0, strict=False):
        self._runtime = runtime
        self._rank = str(rank)
        self._strict = strict
        self._warned = False
        self._t0 = time.time()
        self._straggler0 = 0.0
        self._log = get_logger()
        self._metrics_on = telemetry.enabled()
        self._m_step_s = telemetry.gauge(
            "hvd_autotune_step_seconds",
            "Mean step span (first submit -> last finish) of the last "
            "trace-scored autotune window")
        self._m_overlap = telemetry.gauge(
            "hvd_autotune_window_overlap_fraction",
            "Collective overlap fraction of the last trace-scored "
            "autotune window (ring-derived)")

    def _ring(self):
        tracer = getattr(self._runtime, "tracer", None)
        flight = getattr(tracer, "_flight", None)
        return None if flight is None else flight.snapshot()

    def _straggler_delay(self):
        """This rank's cumulative attributed straggler delay, when a
        live analyzer feeds the gauge (0.0 otherwise). Read through
        the registry snapshot: one dict walk per window, nothing per
        cycle."""
        if not self._metrics_on:
            return 0.0
        fam = (telemetry.snapshot().get("families") or {}).get(
            "hvd_straggler_delay_seconds")
        if not fam:
            return 0.0
        for sample in fam.get("samples") or []:
            if (sample.get("labels") or {}).get("rank") == self._rank:
                return float(sample.get("value") or 0.0)
        return 0.0

    def open_window(self):
        self._t0 = time.time()
        self._straggler0 = self._straggler_delay()

    def close_window(self, cycle_rates):
        events = self._ring()
        stats = None
        if events is not None:
            stats = window_stats(events, self._t0, time.time())
        out = {"bytes": _mean(cycle_rates), "steps": None}
        if stats is None:
            if self._strict and not self._warned:
                self._warned = True
                self._log.warning(
                    "autotune: HVDTPU_AUTOTUNE_SCORE=steps but the "
                    "window shows no step structure (flight recorder "
                    "off, or traffic has no repeated collective "
                    "names); scoring falls back to bytes/sec")
            return out
        self._m_step_s.set(stats["mean_step_s"])
        self._m_overlap.set(stats["overlap_fraction"])
        span = stats["span_s"]
        delta = max(0.0, self._straggler_delay() - self._straggler0)
        out["steps"] = stats["steps"] / (span + delta)
        return out


def make_source(runtime, mode, rank=0):
    """Score source for ``HVDTPU_AUTOTUNE_SCORE`` = auto|steps|bytes.
    Unknown values raise (the loud-typo contract every knob grammar in
    this codebase follows)."""
    if mode == "bytes":
        return BytesScore()
    if mode == "auto":
        return TraceScore(runtime, rank=rank, strict=False)
    if mode == "steps":
        return TraceScore(runtime, rank=rank, strict=True)
    raise ValueError(
        f"HVDTPU_AUTOTUNE_SCORE={mode!r}: expected auto, steps or "
        "bytes (docs/autotune.md)")

"""Span API (port of ``horovod_tpu/telemetry/spans.py``): one context
manager that feeds both the timeline and a histogram. Entering emits the
timeline's begin event, exiting its end event and the elapsed seconds.
With neither sink the shared ``NULL_SPAN`` is returned, so a disabled hot
path allocates nothing."""

import time

from .core import NULL


class Span:
    __slots__ = ("_names", "_activity", "_timeline", "_histogram", "_t0")

    def __init__(self, names, activity, timeline=None, histogram=None):
        self._names = names
        self._activity = activity
        self._timeline = timeline
        self._histogram = histogram
        self._t0 = 0.0

    def __enter__(self):
        if self._timeline is not None:
            self._timeline.begin(self._names, self._activity)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        elapsed = time.perf_counter() - self._t0
        if self._histogram is not None:
            self._histogram.observe(elapsed)
        if self._timeline is not None and exc_type is None:
            # A failure leaves the event open: the error is what matters.
            self._timeline.end(self._names, self._activity)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


def span(names, activity, timeline=None, histogram=None):
    """A span over ``names``; the no-op when both sinks are absent."""
    if histogram is None or histogram is NULL:
        if timeline is None:
            return NULL_SPAN
        histogram = None
    return Span(names, activity, timeline=timeline, histogram=histogram)

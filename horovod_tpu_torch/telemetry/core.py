"""Metric factories (port of the parts of ``horovod_tpu/telemetry/core.py``
that the coordinator and the backends call).

With ``HOROVOD_TPU_METRICS`` unset (the default) every factory returns the
shared ``NULL`` no-op, as in the JAX package, so an instrumented call site
pays one empty method call and nothing accumulates. The registry, its
exposition and ``metrics_snapshot`` come with the rest of ``telemetry/``
(ROADMAP item 13); until then an enabled metric is a plain in-process
series that nothing reads but tests.
"""

import bisect
import math
import threading

from ..utils import envparse

class _NullMetric:
    """Shared no-op stand-in for every metric type when metrics are off."""

    __slots__ = ()

    def labels(self, **kwargs):
        return self

    def inc(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    @property
    def value(self):
        return 0.0


NULL = _NullMetric()

# Latency buckets 10 us .. ~80 s, as the JAX package's SECONDS_BUCKETS.
_SECONDS_BUCKETS = [1e-5 * 2 ** i for i in range(24)]


class _Metric:
    """One labeled family: label values -> a scalar (counter, gauge) or
    bucket counts and a sum (histogram)."""

    def __init__(self, name, labelnames=(), buckets=None):
        self.name = name
        self.labelnames = tuple(labelnames)
        self._buckets = buckets
        self._lock = threading.Lock()
        self._series = {}
        self._key = ()

    def labels(self, **labels):
        child = _Metric(self.name, (), self._buckets)
        child._lock, child._series = self._lock, self._series
        child._key = tuple(str(labels[n]) for n in self.labelnames)
        return child

    def inc(self, amount=1):
        with self._lock:
            self._series[self._key] = self._series.get(self._key, 0.0) \
                + amount

    def set(self, value):
        with self._lock:
            self._series[self._key] = float(value)

    def observe(self, value):
        idx = bisect.bisect_left(self._buckets, value)
        with self._lock:
            counts, total = self._series.get(
                self._key, ([0] * (len(self._buckets) + 1), 0.0))
            counts[idx] += 1
            self._series[self._key] = (counts, total + value)

    @property
    def value(self):
        v = self._series.get(self._key, 0.0)
        return v[1] if isinstance(v, tuple) else v


_ENABLED = None
_FAMILIES = {}
_FAMILIES_LOCK = threading.Lock()


def enabled():
    """True when HOROVOD_TPU_METRICS is on (resolved once)."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = envparse.get_bool(envparse.METRICS)
    return _ENABLED


def _family(name, labelnames, buckets=None):
    if not enabled():
        return NULL
    with _FAMILIES_LOCK:
        fam = _FAMILIES.get(name)
        if fam is None:
            fam = _FAMILIES[name] = _Metric(name, labelnames, buckets)
        return fam


def counter(name, help="", labelnames=()):
    return _family(name, labelnames)


def gauge(name, help="", labelnames=()):
    return _family(name, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    return _family(name, labelnames, list(buckets or _SECONDS_BUCKETS))


def payload_nbytes(x):
    """Bytes of a tensor or nested list of tensors (non-tensors count 0)."""
    if isinstance(x, (list, tuple)):
        return sum(payload_nbytes(a) for a in x)
    try:
        return math.prod(x.shape) * x.element_size()
    except (AttributeError, TypeError):
        return 0

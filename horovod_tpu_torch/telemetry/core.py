"""Thread-safe metrics core: Counter / Gauge / Histogram (port of
``horovod_tpu/telemetry/core.py``).

Named metric families with labels, log-bucketed latency and byte
histograms, and a registry that snapshots to JSON and Prometheus text
(``exposition.py``). The snapshot format is the JAX package's, so either
package's exposition, roll-up and CLI read the other's snapshots.

Cost model (the contract every instrumented hot path relies on):

- **Disabled** (``HOROVOD_TPU_METRICS`` unset or 0): every factory returns
  the shared ``NULL`` singleton whose methods are empty. No metric object
  is created, the registry stays empty, and an instrumented call site pays
  one no-op method call.
- **Enabled**: one small ``threading.Lock`` per child guards the
  read-modify-write; a histogram observation is a bisect over ~20 bucket
  bounds.

Enablement is resolved once, lazily, at the first factory call; ``reset()``
re-reads it (tests flip the knob, elastic full restarts start over).
"""

import bisect
import math
import threading
import time

from ..utils import envparse


def log_buckets(lo, hi, factor=2.0):
    """Geometric bucket upper bounds from ``lo`` until ``hi`` is covered.
    The +Inf bucket is implicit."""
    if lo <= 0 or factor <= 1:
        raise ValueError("log_buckets needs lo > 0 and factor > 1")
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * factor)
    return bounds


# Latency spans 10 us .. ~80 s; byte sizes span 64 B .. 1 GiB.
SECONDS_BUCKETS = log_buckets(1e-5, 80.0)
BYTES_BUCKETS = log_buckets(64.0, float(1 << 30), factor=4.0)


class _NullMetric:
    """Shared no-op stand-in for every metric type when metrics are off
    (and for spans' "no histogram" case). One instance, no state."""

    __slots__ = ()

    def labels(self, **kwargs):
        return self

    def inc(self, amount=1):
        pass

    def dec(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    @property
    def value(self):
        return 0.0


NULL = _NullMetric()


class _Child:
    """One labeled series: a scalar for counters and gauges, bucket
    counts and a sum for histograms."""

    __slots__ = ("_lock", "_value", "_bounds", "_counts", "_sum")

    def __init__(self, bounds=None):
        # A leaf lock: held for a scalar update, nothing acquired under it.
        self._lock = threading.Lock()
        self._value = 0.0
        self._bounds = bounds
        if bounds is not None:
            self._counts = [0] * (len(bounds) + 1)  # +1 for +Inf
            self._sum = 0.0

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    def set(self, value):
        with self._lock:
            self._value = float(value)

    @property
    def value(self):
        return self._value

    def observe(self, value):
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value

    @property
    def sum(self):
        return self._sum

    @property
    def count(self):
        return sum(self._counts)

    def bucket_counts(self):
        """[(upper_bound, cumulative_count), ...] ending with +Inf."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for bound, c in zip(self._bounds + [float("inf")], counts):
            cum += c
            out.append((bound, cum))
        return out


class MetricFamily:
    """A named metric with a fixed label schema; its children are the
    labeled series. A label-less family passes updates to its single
    ``()`` child, so that ``counter("x").inc()`` works."""

    kind = None

    def __init__(self, name, help="", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children = {}
        self._lock = threading.Lock()

    def _new_child(self):
        return _Child()

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def inc(self, amount=1):
        self.labels().inc(amount)

    def dec(self, amount=1):
        self.labels().dec(amount)

    def set(self, value):
        self.labels().set(value)

    def observe(self, value):
        self.labels().observe(value)

    @property
    def value(self):
        return self.labels().value

    def samples(self):
        with self._lock:
            items = sorted(self._children.items())
        out = []
        for key, child in items:
            labels = dict(zip(self.labelnames, key))
            if self.kind == "histogram":
                out.append({"labels": labels, "sum": child.sum,
                            "count": child.count,
                            "buckets": child.bucket_counts()})
            else:
                out.append({"labels": labels, "value": child.value})
        return out


class Counter(MetricFamily):
    kind = "counter"


class Gauge(MetricFamily):
    kind = "gauge"


class Histogram(MetricFamily):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        self.buckets = list(buckets if buckets is not None
                            else SECONDS_BUCKETS)

    def _new_child(self):
        return _Child(bounds=self.buckets)


class Registry:
    """Name -> family table. Factories get or create, so that one metric
    defined from two modules (or across elastic re-inits) shares one
    series."""

    def __init__(self):
        self._table = {}
        self._lock = threading.Lock()

    def _families(self):
        return self._table

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            table = self._families()
            fam = table.get(name)
            if fam is None:
                fam = cls(name, help, labelnames, **kwargs)
                table[name] = fam
                return fam
        if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name} re-registered with a different "
                f"type/label schema")
        return fam

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def families(self):
        with self._lock:
            return dict(self._families())

    def snapshot(self):
        """JSON-able view of every family (``exposition.py`` renders
        it)."""
        fams = {}
        families = self.families()
        for name in sorted(families):
            fam = families[name]
            fams[name] = {"type": fam.kind, "help": fam.help,
                          "labelnames": list(fam.labelnames),
                          "samples": fam.samples()}
        return {"ts": time.time(), "families": fams}


class _ProcessRegistry(Registry):
    """The process's registry. Its table is the module's ``_FAMILIES``
    (name -> family), which tests may swap for an empty one."""

    def _families(self):
        return _FAMILIES


_FAMILIES = {}
_REGISTRY = _ProcessRegistry()
_ENABLED = None  # None: not resolved yet


def enabled():
    """True when HOROVOD_TPU_METRICS is on. Resolved once; the cached
    answer keeps disabled call sites at one global read and compare."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = envparse.get_bool(envparse.METRICS)
    return _ENABLED


def reset():
    """Drop every recorded series and re-resolve enablement from the
    environment."""
    global _FAMILIES, _ENABLED
    _FAMILIES = {}
    _ENABLED = None


def registry():
    return _REGISTRY


def counter(name, help="", labelnames=()):
    if not enabled():
        return NULL
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    if not enabled():
        return NULL
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    if not enabled():
        return NULL
    return _REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def snapshot():
    if not enabled():
        return {"ts": time.time(), "families": {}}
    return _REGISTRY.snapshot()


def payload_nbytes(x):
    """Total bytes of a tensor or array, or of a nested list of them
    (non-arrays count 0): the backends' per-collective byte counters."""
    if isinstance(x, (list, tuple)):
        return sum(payload_nbytes(a) for a in x)
    try:
        itemsize = x.element_size() if hasattr(x, "element_size") \
            else x.dtype.itemsize
        return math.prod(x.shape) * itemsize
    except (AttributeError, TypeError):
        return 0

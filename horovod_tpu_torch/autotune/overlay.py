"""Autotune knob overlay: tuned values for construction-time knobs (port
of ``horovod_tpu/autotune/overlay.py``).

Most tuned knobs apply instantly (the coordinator's fusion threshold
and cycle time are plain attributes the cycle thread re-reads).
``HVDTPU_ZERO_BUCKET_BYTES`` does not: ``train.DistributedOptimizer``
reads it once, when it is constructed, into its ZeRO shard plan. The
overlay is the indirection that closes that gap: the tuner (a
warm-started cache hit at init, or a zero-arm candidate mid-sweep)
writes here, and the constructor reads through :func:`resolve_int` so a
tuned value wins over the raw environment. The ZeRO step additionally
polls :func:`generation` (one int compare per step) so a mid-run change
re-plans the shards at the next step.

Values persist across elastic re-inits on purpose: the new cohort's
fresh ParameterManager re-validates them against the warm-start store
(docs/autotune.md) instead of silently dropping the tuned config.
"""

import threading

_lock = threading.Lock()
_values = {}
_generation = 0


def set_int(name, value):
    """Overlay knob ``name`` (an envparse registry name, no prefix)
    with a tuned integer value; bumps the generation counter consumers
    poll for cheap change detection."""
    global _generation
    with _lock:
        _values[name] = int(value)
        _generation += 1


def get_int(name, default=None):
    """Tuned value for ``name``, or ``default`` when the tuner never
    touched it."""
    with _lock:
        return _values.get(name, default)


def resolve_int(name, default=None):
    """The one overlay-then-env-then-default resolution every
    construction-time reader uses: a tuned value wins over the raw
    environment knob, which wins over ``default``."""
    value = get_int(name)
    if value is not None:
        return value
    from ..utils import envparse
    return envparse.get_int(name, default)


def generation():
    """Monotonic change counter (0 = nothing overlaid yet)."""
    return _generation


def snapshot():
    """Copy of the overlay dict (CLI / test surface)."""
    with _lock:
        return dict(_values)


def clear():
    """Drop every overlaid value (test hook; bumps the generation so
    pollers notice)."""
    global _generation
    with _lock:
        _values.clear()
        _generation += 1

"""Metrics plane, the part the coordinator and the backends call (port of
``horovod_tpu/telemetry/``): metric factories that return the shared
``NULL`` no-op unless ``HOROVOD_TPU_METRICS`` is on, and the span API."""

from .core import NULL, counter, enabled, gauge, histogram  # noqa: F401
from .spans import NULL_SPAN, span  # noqa: F401

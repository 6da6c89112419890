"""horovod_tpu_torch.serving: multi-host continuous-batching inference on
the GPU (port of ``horovod_tpu/serving/``).

A request router on the runner HTTP/KV plane feeds per-host
continuous-batching workers, with bounded queues and backpressure end to
end, a paged KV cache on the card with watermark admission, preemption +
recompute-on-resume and verified live migration between hosts, sharded
model state loaded via the ZeRO-1 plan geometry (``load_for_inference``,
``load_from_shards``), elastic autoscaling of serving cohorts from
queue-depth/latency signals, and SLO telemetry (``hvd_serving_*``
families). The wire protocols are the JAX package's: either package's
router, worker and migration records talk to the other's.

Layers:

- :mod:`kv_cache`   — fixed-size page pool per host (its payload a tensor
  on the card), page tables per sequence, watermark admission,
  preemption frees pages, verified export/import.
- :mod:`scheduler`  — continuous batching: prefill admission interleaved
  with in-flight decode, the batch recomposed every step.
- :mod:`model`      — the ``ModelAdapter`` contract + the deterministic
  ``ToyLM`` (batched decode on the card, one host sync a step).
- :mod:`worker`     — per-host serving loop, HTTP surface, KV-plane
  registration + stats push, drain with live migration.
- :mod:`router`     — assigns requests to host cohorts, 429 +
  Retry-After past the queue limit, re-routes streams off dead workers.
- :mod:`migration`  — chunked, digest-verified page transfer.
- :mod:`state`      — train (ZeRO shards / live tensors) → inference
  layout on the redistribution planner, on the tensors' device.
- :mod:`autoscale`  — queue-depth/latency driven cohort scale-up and
  drain-first scale-down.

CLI: ``python -m horovod_tpu_torch.serving.cli route|stats|drain``.
"""

from .kv_cache import PagePool, PageTable, PoolExhausted  # noqa: F401
from .model import ModelAdapter, ToyLM  # noqa: F401
from .scheduler import Request, Scheduler, SequenceResult  # noqa: F401
from .worker import ServingWorker  # noqa: F401
from .router import Router, WorkerClient, InProcClient  # noqa: F401
from .autoscale import Autoscaler  # noqa: F401


def load_for_inference(*args, **kwargs):
    """Lazy re-export of :func:`state.load_for_inference` (the state
    module pulls in the redistribution planner; the serving hot path does
    not need it)."""
    from .state import load_for_inference as _impl
    return _impl(*args, **kwargs)

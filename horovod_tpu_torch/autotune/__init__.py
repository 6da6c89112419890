"""Trace-driven online autotuner (port of ``horovod_tpu/autotune/``).

The feedback loop between the trace plane's live measurements and the
knob registry: an online tuner that searches the landed perf planes —
fusion threshold x cycle time x delegated min bucket, overlap bucket
bytes, compression codec x threshold, ZeRO leg buckets — with
per-plane successive-halving arms, scores candidates by real per-step
signals from the flight-recorder ring (steps/sec over correlated
submit/finish spans, not just cycle-thread bytes/sec), and persists
converged winners per (model-signature, world-size,
codec-availability) key for instant warm start on repeat runs.

Modules:

- :mod:`core`    — the :class:`ParameterManager` state machine
  (warmup -> warm-start decision -> confirm windows or per-arm sweep);
- :mod:`score`   — the bytes/sec and trace-derived steps/sec sources;
- :mod:`store`   — the persistent warm-start JSON store;
- :mod:`overlay` — tuned values for construction-time knobs
  (``HVDTPU_BUCKET_BYTES`` / ``HVDTPU_ZERO_BUCKET_BYTES``);
- :mod:`cli`     — the ``hvd-autotune`` console entry
  (show/history/diff/clear).

Disabled contract (the telemetry/chaos/guardian standard): with
``HVDTPU_AUTOTUNE`` unset, ``basics.init`` never constructs a
ParameterManager — ``runtime.autotuner`` stays ``None`` and the
coordinator cycle pays one attribute check.

The arms build under the JAX package's conditions. On the card (the
NCCL-delegated plane) that leaves the ``host`` arm as fusion threshold x
cycle time: ``nccl_global`` has no ``set_min_bucket``, the port has no
overlap plane (``coord._overlap``), a delegated compression plane is no
catch-all the tuner may rewrite, and the ``zero`` arm builds only in a
single-process job. The store's file format is the JAX package's: each
package warm-starts from the other's file.
"""

from . import overlay, score, store  # noqa: F401  (subsystem surface)
from .core import (  # noqa: F401  (re-exported API)
    BUCKET_BYTES_CANDIDATES_MIB, BUCKET_CANDIDATES,
    CYCLE_CANDIDATES_MS, CYCLES_PER_CANDIDATE, FUSION_CANDIDATES_MIB,
    ParameterManager, WARMUP_CYCLES, ZERO_BUCKET_CANDIDATES_MIB,
)

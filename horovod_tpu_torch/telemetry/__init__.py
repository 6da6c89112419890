"""The metrics plane (port of ``horovod_tpu/telemetry/``).

Counters, gauges and log-bucketed histograms with labels (``core.py``), a
span API feeding both the histograms and the timeline (``spans.py``),
Prometheus and JSON exposition (``exposition.py``) served from the
launcher's token-gated ``/metrics`` route, the launcher-side cluster
roll-up and the ranks' snapshot pusher (``aggregate.py``), and the console
client ``python -m horovod_tpu_torch.telemetry.cli`` (``cli.py``).

Enable with ``HOROVOD_TPU_METRICS=1``; off, every factory returns a shared
no-op and an instrumented hot path costs one empty method call. Snapshot
in process with ``horovod_tpu_torch.metrics_snapshot()``.
"""

from .core import (  # noqa: F401
    NULL, BYTES_BUCKETS, SECONDS_BUCKETS, Counter, Gauge, Histogram,
    Registry, counter, enabled, gauge, histogram, log_buckets, registry,
    reset, snapshot,
)
from .spans import NULL_SPAN, Span, span  # noqa: F401
from .exposition import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE, parse_prometheus, render_json,
    render_prometheus,
)
from .aggregate import (  # noqa: F401
    METRICS_SCOPE, MetricsPusher, parse_rank_snapshots, push_snapshot,
    quantile_from_buckets, store_snapshots,
)
# The roll-up under a name that does not shadow the submodule.
from .aggregate import aggregate as aggregate_snapshots  # noqa: F401


def archive_snapshot(snap, path=None):
    """Write ``snap`` as JSON to ``path``, by default
    ``HVDTPU_METRICS_SNAPSHOT`` (``BENCH_metrics.json``): where a benchmark
    run keeps its telemetry for ``cli diff``. Returns the path."""
    from ..utils import envparse
    path = path or envparse.get_str(envparse.METRICS_SNAPSHOT,
                                    "BENCH_metrics.json")
    with open(path, "w") as f:
        f.write(render_json(snap, indent=1))
    return path

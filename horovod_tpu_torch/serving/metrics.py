"""SLO telemetry families of the serving plane (port of
``horovod_tpu/serving/metrics.py``: the same names, labels and help text,
on the port's ``telemetry/core.py``).

Factories resolve at call time like the rest of the tree (zero.py,
http_client.py): with ``HOROVOD_TPU_METRICS`` off every call returns the
NULL no-op, so the serving hot path pays one dead method call per
observation. The cluster roll-up (``*_cluster{stat=}``) comes for free
from the existing MetricsPusher + /metrics aggregation: p50/p99 of the
latency histograms are exactly the SLO numbers docs/serving.md cites.
"""

# Latency histograms need sub-millisecond resolution at the low end
# (decode steps of a small model) and minute-scale at the top (queue
# waits under overload): 1e-4 .. ~100s log buckets.
_LATENCY_LO, _LATENCY_HI = 1e-4, 128.0


def latency(phase):
    """``hvd_serving_latency_seconds{phase=queue|prefill|decode}`` —
    per-request time in each serving phase. ``decode`` observes the
    whole decode tail of a request (first-token-to-done), per-step
    timing rides the span/trace plane."""
    from ..telemetry import core as telemetry
    return telemetry.histogram(
        "hvd_serving_latency_seconds",
        "Per-request serving latency by phase (queue wait, prefill, "
        "decode tail)",
        labelnames=("phase",),
        buckets=telemetry.log_buckets(_LATENCY_LO, _LATENCY_HI),
    ).labels(phase=phase)


def tokens_total():
    """``hvd_serving_tokens_total`` — generated tokens (decode output;
    prompt tokens are not counted)."""
    from ..telemetry import core as telemetry
    return telemetry.counter(
        "hvd_serving_tokens_total",
        "Tokens generated by the serving plane")


def queue_depth():
    """``hvd_serving_queue_depth`` — requests waiting for admission on
    this host (the backpressure signal the router and autoscaler read)."""
    from ..telemetry import core as telemetry
    return telemetry.gauge(
        "hvd_serving_queue_depth",
        "Requests queued for admission on this serving host")


def kv_pages_free():
    """``hvd_serving_kv_pages_free`` — free pages in this host's KV
    pool; admission blocks when a prefill would push it below the
    watermark."""
    from ..telemetry import core as telemetry
    return telemetry.gauge(
        "hvd_serving_kv_pages_free",
        "Free KV-cache pages in this host's page pool")


def rejected_total(reason):
    """``hvd_serving_rejected_total{reason}`` — requests turned away
    with 429/503 (reason: queue_full, draining, overload)."""
    from ..telemetry import core as telemetry
    return telemetry.counter(
        "hvd_serving_rejected_total",
        "Requests rejected by the serving plane, by reason",
        labelnames=("reason",)).labels(reason=reason)


def preempted_total():
    """``hvd_serving_preempted_total`` — sequences whose KV pages were
    reclaimed mid-decode (they resume by recomputing prefill)."""
    from ..telemetry import core as telemetry
    return telemetry.counter(
        "hvd_serving_preempted_total",
        "Sequences preempted from the KV page pool (resume recomputes)")


def rerouted_total():
    """``hvd_serving_rerouted_total`` — accepted requests the router
    re-submitted to a different worker after the first one died."""
    from ..telemetry import core as telemetry
    return telemetry.counter(
        "hvd_serving_rerouted_total",
        "Accepted requests re-routed off a dead serving worker")


def migrations_total(outcome):
    """``hvd_serving_migrations_total{outcome}`` — live-migration
    attempts by how they ended. Source-side outcomes: ``complete``,
    ``no_peer``, ``no_headroom``, ``digest_mismatch``,
    ``version_fence``, ``timeout``, ``refused``, ``error``; the target
    counts ``imported`` and its own refusals. Every non-``complete``
    outcome is a *loud fallback* to the recompute/reroute path."""
    from ..telemetry import core as telemetry
    return telemetry.counter(
        "hvd_serving_migrations_total",
        "KV-cache live-migration attempts by outcome (anything but "
        "complete/imported fell back to recompute)",
        labelnames=("outcome",)).labels(outcome=outcome)


def migrated_pages_total():
    """``hvd_serving_migrated_pages_total`` — KV pages successfully
    transferred to a peer (digest-verified and placed)."""
    from ..telemetry import core as telemetry
    return telemetry.counter(
        "hvd_serving_migrated_pages_total",
        "KV-cache pages live-migrated to a peer host")


def migration_seconds():
    """``hvd_serving_migration_seconds`` — wall time of one completed
    migrate-out (export through the peer's commit ack)."""
    from ..telemetry import core as telemetry
    return telemetry.histogram(
        "hvd_serving_migration_seconds",
        "End-to-end duration of completed KV-cache live migrations",
        buckets=telemetry.log_buckets(1e-3, _LATENCY_HI))

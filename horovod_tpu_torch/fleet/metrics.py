"""Telemetry families of the fleet arbiter (port of
``horovod_tpu/fleet/metrics.py``: the same names, labels and help text,
on the port's ``telemetry/core.py``; docs/metrics.md).

Same lazy-factory contract as the serving plane (serving/metrics.py):
resolution happens at call time, and with ``HOROVOD_TPU_METRICS`` off
every call returns the NULL no-op — the arbiter tick pays a dead
method call, nothing else.
"""


def transfers_total(direction, outcome):
    """``hvd_fleet_transfers_total{direction,outcome}`` — lease
    transfers by direction (``train_to_serve``/``serve_to_train``)
    and outcome (``complete``/``rolled_back``)."""
    from ..telemetry import core as telemetry
    return telemetry.counter(
        "hvd_fleet_transfers_total",
        "Fleet lease transfers, by direction and outcome",
        labelnames=("direction", "outcome"),
    ).labels(direction=direction, outcome=outcome)


def lease_age_seconds():
    """``hvd_fleet_lease_age_seconds`` — age of the in-flight lease
    (0 when none): a transfer stuck mid-flight shows as unbounded
    growth here long before anyone reads the ledger."""
    from ..telemetry import core as telemetry
    return telemetry.gauge(
        "hvd_fleet_lease_age_seconds",
        "Age of the in-flight fleet lease (0 = no transfer running)")


def train_slots():
    """``hvd_fleet_train_slots`` — the training side of the split."""
    from ..telemetry import core as telemetry
    return telemetry.gauge(
        "hvd_fleet_train_slots",
        "Chip slots currently assigned to the training cohort")


def serve_slots():
    """``hvd_fleet_serve_slots`` — the serving side of the split."""
    from ..telemetry import core as telemetry
    return telemetry.gauge(
        "hvd_fleet_serve_slots",
        "Chip slots currently assigned to the serving cohort")

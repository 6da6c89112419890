"""Driver-side cluster roll-up: per-rank snapshots to one snapshot (port
of ``horovod_tpu/telemetry/aggregate.py``).

Each worker pushes its registry snapshot (JSON) into the launcher's KV
store under ``metrics/<rank>`` on a timer (``MetricsPusher``, started by
``basics.init`` when metrics are on and the job has a rendezvous). The
launcher's ``/metrics`` route and the CLI then roll the per-rank snapshots
up: scalar families get min/max/mean/sum across ranks; histograms are
bucket-merged and report p50/p99 estimated from the merged cumulative
counts. Rolled-up families are ``<name>_cluster{stat=...}`` gauges, so one
scrape of the launcher carries the whole job.
"""

import json
import threading
import time

from . import core

METRICS_SCOPE = "metrics"
DEFAULT_PUSH_INTERVAL_S = 5.0


def quantile_from_buckets(buckets, q):
    """Estimate quantile ``q`` from cumulative ``[(le, cum), ...]``
    (Prometheus-style: the answer is the upper bound of the bucket the
    quantile falls in — conservative, monotone)."""
    if not buckets:
        return 0.0
    total = buckets[-1][1]
    if total == 0:
        return 0.0
    target = q * total
    prev_bound = 0.0
    for bound, cum in buckets:
        if cum >= target:
            return bound if bound != float("inf") else prev_bound
        prev_bound = bound
    return prev_bound


def _merge_buckets(per_rank):
    """Sum cumulative counts across ranks (bucket bounds are identical:
    every rank runs the same metric definitions)."""
    merged = {}
    for buckets in per_rank:
        for bound, cum in buckets:
            merged[bound] = merged.get(bound, 0) + cum
    return sorted(merged.items())


def aggregate(snapshots):
    """Roll a ``{rank: snapshot}`` map up into one snapshot-like dict of
    ``<name>_cluster`` gauge families with a ``stat`` label."""
    fams = {}
    # family -> label-key -> list of per-rank samples
    collected = {}
    for _rank, snap in sorted(snapshots.items()):
        for name, fam in snap.get("families", {}).items():
            meta = collected.setdefault(
                name, {"type": fam["type"], "help": fam.get("help", ""),
                       "series": {}})
            for sample in fam["samples"]:
                key = tuple(sorted(sample.get("labels", {}).items()))
                meta["series"].setdefault(key, []).append(sample)

    for name, meta in sorted(collected.items()):
        samples = []
        for key, per_rank in sorted(meta["series"].items()):
            labels = dict(key)
            if meta["type"] == "histogram":
                merged = _merge_buckets(
                    [s["buckets"] for s in per_rank])
                count = sum(s["count"] for s in per_rank)
                total = sum(s["sum"] for s in per_rank)
                stats = {
                    "mean": (total / count) if count else 0.0,
                    "p50": quantile_from_buckets(merged, 0.50),
                    "p99": quantile_from_buckets(merged, 0.99),
                    "count": float(count),
                }
            else:
                values = [s["value"] for s in per_rank]
                stats = {
                    "min": min(values),
                    "max": max(values),
                    "mean": sum(values) / len(values),
                    "sum": float(sum(values)),
                }
            for stat, value in sorted(stats.items()):
                samples.append(
                    {"labels": {**labels, "stat": stat}, "value": value})
        fams[f"{name}_cluster"] = {
            "type": "gauge",
            "help": (meta["help"] + " (cluster roll-up)").strip(),
            "labelnames": [], "samples": samples}
    return {"ts": time.time(), "ranks": len(snapshots), "families": fams}


# -- KV-store plumbing -----------------------------------------------------

def push_snapshot(addr, port, token, rank, snap=None):
    """PUT this process's snapshot under metrics/<rank> (worker side)."""
    from ..runner import http_client
    snap = snap if snap is not None else core.snapshot()
    http_client.put_kv(addr, port, METRICS_SCOPE, str(rank),
                       json.dumps(snap), token=token)


def parse_rank_snapshots(raw):
    """``{rank_key: json bytes/str}`` → ``{rank: snapshot}``.
    Unparseable entries are skipped, not fatal — one wedged worker must
    not take down the whole roll-up."""
    snaps = {}
    for key, value in raw.items():
        try:
            snaps[int(key)] = json.loads(
                value.decode() if isinstance(value, bytes) else value)
        except (ValueError, AttributeError):
            continue
    return snaps


def store_snapshots(server):
    """Read every pushed rank snapshot out of a KVStoreServer
    (driver side)."""
    return parse_rank_snapshots(
        {key: server.get(METRICS_SCOPE, key)
         for key in server.scope_keys(METRICS_SCOPE)})


class MetricsPusher:
    """Daemon thread pushing snapshots on an interval; one final push on
    stop, so that shutdown-time counters (elastic restarts) reach the
    launcher.

    Every attribute is set in ``__init__`` before ``start()`` and never
    reassigned; the thread only reads them. ``stop()`` joins with a
    timeout, so a push stuck in the KV client may still be in flight while
    ``stop()`` issues the final push: both write the same per-rank key,
    and the last writer wins."""

    def __init__(self, addr, port, token, rank,
                 interval_s=DEFAULT_PUSH_INTERVAL_S):
        self._args = (addr, port, token, rank)
        self._interval = max(0.5, float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-tpu-metrics-push", daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _push(self):
        try:
            push_snapshot(*self._args)
        except OSError:
            pass  # the launcher is gone or restarting: never fatal

    def _loop(self):
        while not self._stop.wait(self._interval):
            self._push()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self._push()

"""The cross-rank trace plane (port of ``horovod_tpu/tracing/``).

The per-rank Chrome timeline (``timeline.py``) cannot say which rank made
a collective late, where a step's critical path ran, or what every rank
was doing when the watchdog fired. This package does:

- ``recorder.py``: per-rank JSONL shards with correlated collective spans
  (name x occurrence x elastic version), and the flight recorder's ring
  that the guardian's paths dump to a postmortem shard;
- ``clock.py``: NTP-style offset sampling against the launcher's
  ``/clock`` route, so that clock skew does not make stragglers up;
- ``merge.py``: one Perfetto/Chrome trace from the shards, a track per
  rank and flow arrows joining each collective's per-rank spans, and
  ``collect_shards`` from the launcher's KV store;
- ``analyze.py``: per-step critical path, per-collective straggler
  attribution (``hvd_straggler_delay_seconds{rank}``), comm breakdown;
- ``cli.py``: ``python -m horovod_tpu_torch.tracing.cli
  collect|merge|report|postmortem``.

Shards are the JAX package's format: either package's tools read the
other's. With ``HVDTPU_TRACE`` unset and ``HVDTPU_FLIGHT_RECORDER=0``,
:func:`make_tracer` returns ``None`` and instrumented sites pay one
``None`` check; :func:`trace_event` (the hook for code that holds no
coordinator) is one global read and a ``None`` check. The flight recorder
is on by default, a bounded deque append per collective, so every abort
leaves its last events behind even in jobs that never asked for tracing.
"""

import os

from ..utils import envparse
from ..utils.logging_util import get_logger
from .recorder import (  # noqa: F401  (re-exported API)
    DEFAULT_FLIGHT_EVENTS, FlightRecorder, ShardWriter, TRACE_SCOPE,
    Tracer, trace_scope,
)

# The process-active tracer: the backends, the guardian and elastic record
# through trace_event() without holding a coordinator reference.
_ACTIVE = None


def active():
    """The process-active Tracer, or None when tracing AND the flight
    recorder are both off."""
    return _ACTIVE


def trace_event(cat, name, **fields):
    """Record a generic event on the active tracer; one global read +
    None check when the plane is off."""
    tr = _ACTIVE
    if tr is not None:
        tr.event(cat, name, **fields)


def _set_active(tracer):
    """Test hook / factory internal."""
    global _ACTIVE
    _ACTIVE = tracer


def make_tracer(runtime):
    """Build the rank's Tracer from the env knobs, or None when both
    ``HVDTPU_TRACE`` and ``HVDTPU_FLIGHT_RECORDER`` are off (the
    coordinator then pays one attribute check per submit and nothing
    else). Registers the tracer as the process-active one."""
    trace_on = envparse.get_bool(envparse.TRACE)
    flight_n = (envparse.get_int(envparse.FLIGHT_RECORDER_EVENTS,
                                 DEFAULT_FLIGHT_EVENTS)
                if envparse.get_bool(envparse.FLIGHT_RECORDER, True)
                else 0)
    if not trace_on and flight_n <= 0:
        _set_active(None)
        return None

    rank = runtime.topology.rank
    size = runtime.topology.size
    version = envparse.get_int(envparse.ELASTIC_VERSION, 0)
    flight = FlightRecorder(flight_n) if flight_n > 0 else None
    trace_dir = envparse.get_str(envparse.TRACE_DIR, "hvd_traces")

    # Clock alignment is sampled in BOTH modes when a rendezvous
    # exists: flight-only postmortems merge cross-rank too, and an
    # unaligned bundle reorders the forensics by exactly the skew.
    from ..runner import rendezvous as rdv
    push_cfg = rdv.rendezvous_config()
    off, rtt = 0.0, None
    if push_cfg is not None:
        from . import clock
        addr, port, token = push_cfg
        off, rtt = clock.estimate_offset(addr, port, token=token)

    writer = None
    if trace_on:
        try:
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(
                trace_dir,
                f"shard.r{rank}.p{os.getpid()}.v{version}.jsonl")
            import socket
            import time
            meta = {"e": "meta", "kind": "shard", "rank": rank,
                    "size": size, "ver": version, "pid": os.getpid(),
                    "off": off, "rtt": rtt,
                    "host": socket.gethostname(), "t": time.time()}
            writer = ShardWriter(path, meta)
        except OSError as exc:
            get_logger().warning(
                "tracing: cannot open trace shard under %s (%s); "
                "shard tracing disabled, flight recorder stays on",
                trace_dir, exc)
            writer = None

    tracer = Tracer(rank, size, version, shard_writer=writer,
                    flight=flight, trace_dir=trace_dir,
                    push_cfg=push_cfg, clock=(off, rtt))
    _set_active(tracer)
    return tracer

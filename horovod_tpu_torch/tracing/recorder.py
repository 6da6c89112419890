"""Per-rank trace recording: the JSONL shard writer and the flight
recorder's ring (port of ``horovod_tpu/tracing/recorder.py``).

- **Shard writer** (``HVDTPU_TRACE=1``): every collective submission and
  completion, and the negotiation, guardian and elastic events, as one
  compact JSON object per line, stamped with wall-clock time and a
  *correlation key* (tensor name x occurrence x elastic version) that is
  the same on every rank of a correct program. The launcher-side merge
  (``merge.py``) joins shards on that key; clock skew is corrected with
  the offset sampled against the launcher's ``/clock`` route
  (``clock.py``).
- **Flight recorder** (``HVDTPU_FLIGHT_RECORDER``, on by default): the
  same records into a bounded ring (``collections.deque(maxlen=N)``), so
  it stays on when shard tracing is off. The watchdog's abort and the
  consistency check's mismatch dump the ring to a postmortem shard.

The shard format is the JAX package's (keys ``e``, ``t``, ``n``, ``k``,
``o``, ``b``, ``err``, ``cat`` and the ``meta`` header line): either
package's ``merge`` and ``analyze`` read the other's shards.

With ``HVDTPU_TRACE`` unset and ``HVDTPU_FLIGHT_RECORDER=0``,
``tracing.make_tracer`` returns ``None`` and every instrumented site pays
one ``None`` check. With only the flight recorder on, no file is opened
and nothing is pushed.
"""

import collections
import json
import os
import queue
import socket
import threading
import time

from ..analysis import sanitizer
from ..telemetry import core as telemetry
from ..utils.logging_util import get_logger

DEFAULT_FLIGHT_EVENTS = 4096
# Re-anchor a DeviceClock once an event lies this far past its anchor:
# the card's elapsed time is a float32 count of milliseconds, whose step
# grows with the interval.
REANCHOR_MS = 10_000.0
# Shard/postmortem bytes pushed to the driver KV store are capped: the
# store is an in-memory dict in the launcher process, and one chatty
# rank must not evict the job's control plane. Truncation keeps the
# meta header + the newest lines (the tail is what postmortems need).
PUSH_CAP_BYTES = 4 * 1024 * 1024
#: KV scope prefix for pushed shards: trace.<elastic_version>
TRACE_SCOPE = "trace"


def trace_scope(version):
    return f"{TRACE_SCOPE}.{version}"


def _payload_bytes(entry):
    """Total payload bytes of a submission's tensors (0 for a barrier):
    the ``b`` field the cost model's calibration fits bandwidth from."""
    return telemetry.payload_nbytes(list(getattr(entry, "tensors", ())
                                         or ()))


class FlightRecorder:
    """Bounded ring of recent trace records. Append-only from the hot
    path; ``snapshot()`` copies under the GIL (deque iteration is
    atomic enough for a postmortem — a torn read loses one event, not
    the bundle)."""

    __slots__ = ("_ring",)

    def __init__(self, capacity):
        self._ring = collections.deque(maxlen=int(capacity))

    def append(self, rec):
        self._ring.append(rec)

    def snapshot(self):
        return list(self._ring)

    def __len__(self):
        return len(self._ring)


class DeviceClock:
    """Wall time of events on one CUDA device: an anchor event whose wall
    time is known, and the card's own elapsed time from it, so that a
    ``fin`` is the anchor's wall time plus ``anchor.elapsed_time(done)``.
    Made once per stream when the stream is idle (one ``synchronize()``
    of the anchor, never one per collective)."""

    __slots__ = ("anchor", "wall")

    def __init__(self, stream):
        import torch
        self.anchor = torch.cuda.Event(enable_timing=True)
        self.anchor.record(stream)
        self.anchor.synchronize()
        self.wall = time.time()

    @staticmethod
    def event(stream):
        """A timing event recorded on ``stream`` now."""
        import torch
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        return event

    def wall_of(self, event):
        """Wall time at which ``event`` (completed) ran on the card."""
        ms = self.anchor.elapsed_time(event)
        t = self.wall + ms / 1e3
        if ms > REANCHOR_MS:
            self.anchor, self.wall = event, t
        return t


class ShardWriter:
    """Append-only JSONL writer for one rank's trace shard.

    Serialization + file I/O run on a dedicated writer thread (the
    timeline.py pattern): producers — framework threads submitting
    collectives, the coordinator cycle thread completing them — pay one
    ``queue.put`` and never touch the file, so trace writes cannot
    stall the data plane. The writer drains in batches and flushes once
    per drain; ``close()`` sends the sentinel and the WRITER closes the
    file (a timed-out join must not race its last writes)."""

    def __init__(self, path, meta):
        self.path = path
        self._queue = queue.Queue()
        self._queue.put(meta)
        self._thread = threading.Thread(
            target=self._writer, args=(open(path, "w"), self._queue),
            name="hvd-torch-trace-writer", daemon=True)
        self._thread.start()

    def write(self, rec):
        self._queue.put(rec)

    @staticmethod
    def _writer(file, q):
        """Drain-then-flush loop, owned state only (file + queue):
        one blocking get, then everything queued meanwhile, one flush
        per drain. Ends (and closes the file) at the None sentinel."""
        try:
            stop = False
            while not stop:
                rec = q.get()
                if rec is None:
                    break
                lines = [json.dumps(rec, separators=(",", ":"),
                                    default=str)]
                while True:
                    try:
                        rec = q.get_nowait()
                    except queue.Empty:
                        break
                    if rec is None:
                        stop = True
                        break
                    lines.append(json.dumps(rec, separators=(",", ":"),
                                            default=str))
                file.write("\n".join(lines) + "\n")
                file.flush()
        finally:
            try:
                file.close()
            except OSError:
                pass

    def close(self):
        self._queue.put(None)
        self._thread.join(timeout=5)


class Tracer:
    """Facade the coordinator (and, via the module-level hook in
    ``tracing/__init__.py``, the backends, the guardian and elastic) record
    through. Owns the occurrence counters that make correlation keys
    line up across ranks: each rank counts its own submissions per
    tensor name, which advance identically on every rank of a correct
    program (the same invariant the guardian's sampled slots rely on)."""

    def __init__(self, rank, size, version, shard_writer=None,
                 flight=None, trace_dir=None, push_cfg=None,
                 clock=(0.0, None)):
        self.rank = rank
        self.size = size
        self.version = version
        self.trace_dir = trace_dir
        # (offset_s, rtt_s) to the driver's clock (clock.py) — stamped
        # into EVERY meta header this tracer writes, postmortem dumps
        # included: an unaligned postmortem would reorder cross-rank
        # forensics by exactly the skew the plane exists to remove.
        self.clock_off, self.clock_rtt = clock
        self._writer = shard_writer
        self._flight = flight
        self._push_cfg = push_cfg  # (addr, port, token) or None
        self._occ = {}
        self._lock = sanitizer.make_lock("tracing.occ")
        # CUDA collectives whose ``fin`` waits for the card, in stream
        # order: (done event, DeviceClock, [entries]); the cycle thread
        # alone defers and polls them.
        self._device = collections.deque()
        self._log = get_logger()
        self._m_events = telemetry.counter(
            "hvd_trace_events_total",
            "Trace records emitted (shard and/or flight ring)")
        self._m_dumps = telemetry.counter(
            "hvd_flight_dumps_total",
            "Flight-recorder postmortem dumps")

    # -- hot path ----------------------------------------------------------
    def on_submit(self, entry):
        """Stamp ``entry.corr`` with this name's occurrence number and
        record the submission. Called from framework threads (the lock
        covers the counter only)."""
        name = entry.name or entry.kind
        with self._lock:
            occ = self._occ.get(name, 0) + 1
            self._occ[name] = occ
        entry.corr = occ
        rec = {"e": "sub", "t": time.time(), "n": name,
               "k": entry.kind, "o": occ}
        nbytes = _payload_bytes(entry)
        if nbytes:
            rec["b"] = nbytes
        self._emit(rec)

    def on_complete(self, entry, ok=True, t=None):
        name = entry.name or entry.kind
        rec = {"e": "fin", "t": time.time() if t is None else t, "n": name,
               "o": getattr(entry, "corr", None) or 0}
        if not ok:
            rec["err"] = 1
        self._emit(rec)

    # -- CUDA completions ---------------------------------------------------
    def defer_complete(self, entry, event, clock):
        """A CUDA collective's ``fin``: recorded once ``event`` (recorded
        on its stream after the collective) has completed, at the card's
        time of it (``poll_device``). Entries that share an event share
        one query."""
        q = self._device
        if q and q[-1][0] is event:
            q[-1][2].append(entry)
        else:
            q.append((event, clock, [entry]))

    def device_pending(self):
        return bool(self._device)

    def poll_device(self):
        """Record the deferred ``fin``s whose event has completed: one
        non-blocking ``query()`` per distinct event, in stream order,
        stopping at the first that has not."""
        q = self._device
        while q:
            event, clock, entries = q[0]
            try:
                if not event.query():
                    return
                t = clock.wall_of(event)
            except RuntimeError as exc:   # a CUDA error: the card is lost
                self._log.warning("tracing: a collective's done event "
                                  "failed (%s)", exc)
                self.fail_device()
                return
            q.popleft()
            for entry in entries:
                self.on_complete(entry, t=t)

    def fail_device(self):
        """The backend aborted: record every deferred ``fin`` now, with
        ``err`` 1, without waiting for the card."""
        q = self._device
        while q:
            for entry in q.popleft()[2]:
                self.on_complete(entry, ok=False)

    def drain_device(self, timeout_s):
        """Shutdown: wait at most ``timeout_s`` for the deferred ``fin``s,
        then record what is left with ``err`` 1."""
        deadline = time.monotonic() + timeout_s
        while self._device and time.monotonic() < deadline:
            self.poll_device()
            if self._device:
                time.sleep(0.001)
        self.fail_device()

    def event(self, cat, name, **fields):
        """Generic record (negotiation, guardian, elastic...)."""
        rec = {"e": "ev", "t": time.time(), "cat": cat, "n": name}
        rec.update(fields)
        self._emit(rec)

    def _emit(self, rec):
        fl = self._flight
        if fl is not None:
            fl.append(rec)
        w = self._writer
        if w is not None:
            w.write(rec)
        self._m_events.inc()

    # -- postmortem / lifecycle --------------------------------------------
    def _meta(self, kind, **extra):
        meta = {"e": "meta", "t": time.time(), "kind": kind,
                "rank": self.rank, "size": self.size,
                "ver": self.version, "pid": os.getpid(),
                "host": socket.gethostname(),
                "off": self.clock_off, "rtt": self.clock_rtt}
        meta.update(extra)
        return meta

    def dump_postmortem(self, reason):
        """Write the flight ring to a postmortem shard next to the trace
        shards and push it to the driver KV store — called from the
        guardian abort/mismatch paths, so it must never raise."""
        if self._flight is None:
            return None
        try:
            events = self._flight.snapshot()
            d = self.trace_dir or "."
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"postmortem.r{self.rank}.p{os.getpid()}"
                   f".v{self.version}.jsonl")
            meta = self._meta("postmortem", reason=str(reason)[:500],
                              events=len(events))
            with open(path, "w") as f:
                f.write(json.dumps(meta, separators=(",", ":")) + "\n")
                for rec in events:
                    f.write(json.dumps(rec, separators=(",", ":"),
                                       default=str) + "\n")
            self._m_dumps.inc()
            self._push_file(path, f"postmortem.{self.rank}")
            self._log.warning(
                "tracing: flight-recorder postmortem (%d events, "
                "reason: %s) written to %s", len(events),
                str(reason)[:80], path)
            return path
        except Exception as exc:  # noqa: BLE001 — forensics, never fatal
            self._log.warning("tracing: postmortem dump failed: %s", exc)
            return None

    def _push_file(self, path, key):
        """Best-effort bounded push of a shard file to the driver KV
        store, so that the tracing CLI's ``collect`` works without shared
        storage."""
        if self._push_cfg is None:
            return
        try:
            with open(path, "rb") as f:
                data = f.read()
            if len(data) > PUSH_CAP_BYTES:
                # Keep the meta header line + the newest tail lines.
                head, _, rest = data.partition(b"\n")
                tail = rest[-PUSH_CAP_BYTES:]
                tail = tail[tail.index(b"\n") + 1:] if b"\n" in tail \
                    else tail
                data = head + b"\n" + tail
            from ..runner import http_client
            addr, port, token = self._push_cfg
            # A bounded push (2 retries, 5 s), made from the abort path on
            # the cycle thread too: exempt from the sanitize tripwire.
            with sanitizer.allowed("trace shard push (bounded)"):
                http_client.put_kv(addr, port, trace_scope(self.version),
                                   key, data, token=token, retries=2,
                                   deadline=5.0)
        except Exception as exc:  # noqa: BLE001 — advisory plane
            self._log.warning("tracing: shard push %s failed: %s", key,
                              exc)

    def close(self):
        """Flush + close the shard and push it to the driver KV store
        (shutdown path; idempotent)."""
        w = self._writer
        if w is not None:
            w.close()
            self._writer = None
            self._push_file(w.path, f"shard.{self.rank}")

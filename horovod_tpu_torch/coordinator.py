"""Background coordinator: tensor queue, fusion, dispatch, async handles
(port of ``horovod_tpu/coordinator.py``; reference: horovod/common/
operations.cc:385 BackgroundThreadLoop, controller.cc:73
ComputeResponseList).

- Framework threads **submit** named tensors and get a handle back at once
  (reference: EnqueueTensorAllreduces, operations.cc:1384). A name is
  unique among in-flight operations of a process set.
- One background thread drains the queue every cycle (default 1 ms). In a
  single-process job (the Python plane) it groups compatible allreduces,
  **fuses** each group under the fusion threshold (reference:
  controller.cc:808 FuseResponses, 128 MiB, operations.cc:491) and hands
  each bucket to the loopback backend in one call. In a launcher job the
  backend drives its own cycle: the native core negotiates which named
  tensors are ready on every rank, fuses them and checks for stalls, and
  the backend executes the agreed responses (``_loop_native``).

On CUDA tensors: ``submit`` records an event on the submitting thread's
current stream; the cycle thread makes its own stream wait on it before it
touches a tensor, and completes the handle with an event recorded after
the operation was issued. ``Handle.wait`` blocks the host only until the
cycle thread has issued the operation, then makes the caller's current
stream wait on that event.
"""

import contextlib
import itertools
import threading
import time

import torch

from . import chaos
from .analysis import sanitizer
from .analysis.order_guard import GUARD_PREFIX
from .exceptions import DuplicateNameError, HorovodInternalError
from .telemetry import core as telemetry
from .telemetry import span as tele_span
from .utils import envparse
from .utils.callsite import format_user_frame
from .utils.logging_util import get_logger

DEFAULT_CYCLE_TIME_MS = 1.0
DEFAULT_FUSION_THRESHOLD = 128 * 1024 * 1024  # reference: operations.cc:491
# Warn when a submitted op stays in flight this long (reference stall
# inspector default, horovod/common/stall_inspector.cc).
DEFAULT_STALL_WARN_S = 60.0
# A native cycle with nothing in flight on this rank waits this long for a
# submission instead of one cycle time: the thread then stops taking the
# GIL from the submitting threads 1000 times a second. Peers that
# negotiate meanwhile wait for it only for ops this rank has not
# submitted, which a submission ends at once.
IDLE_CYCLE_S = 0.05
# At shutdown, the longest wait for the card to finish the collectives
# whose trace ``fin`` is still pending.
FIN_DRAIN_S = 5.0
# Seconds between the cross-rank submission-order checks (ORDER_CHECK).
DEFAULT_ORDER_CHECK_INTERVAL_S = 5.0


def _tensors_of(result):
    if isinstance(result, torch.Tensor):
        return (result,)
    if isinstance(result, (list, tuple)):
        return tuple(r for r in result if isinstance(r, torch.Tensor))
    return ()


class Handle:
    """Async completion handle (analog of the reference's int handle and
    handle_manager, horovod/torch/mpi_ops_v2.cc:604-624)."""

    __slots__ = ("_event", "_result", "_exception", "_done", "name",
                 "enqueue_time")

    def __init__(self, name):
        self._event = threading.Event()
        self._result = None
        self._exception = None
        self._done = None   # (CUDA event, device): the operation was issued
        self.name = name
        self.enqueue_time = None   # stamped by TensorEntry

    def _complete(self, result, done=None):
        self._result = result
        self._done = done
        self._event.set()

    def _fail(self, exc):
        self._exception = exc
        self._event.set()

    def poll(self):
        """True when ``wait`` would return without blocking the host
        (reference: PollHandle, horovod/torch/mpi_ops_v2.cc:604)."""
        return self._event.is_set()

    def wait(self, timeout=None):
        """The result. On CUDA tensors the caller's current stream is made
        to wait for the operation; the host does not wait for the card."""
        # hvd-sanitize tripwire: a wait on the cycle or watchdog thread
        # would starve every other in-flight collective (one global read
        # when HVDTPU_SANITIZE is off).
        sanitizer.check_blocking("Handle.wait", self.name or "")
        if not self._event.wait(timeout):
            age = ("" if self.enqueue_time is None else
                   f"; in flight {time.monotonic() - self.enqueue_time:.1f}s"
                   " since submit")
            raise TimeoutError(
                f"Operation {self.name!r} did not complete within "
                f"{timeout}s{age}")
        if self._exception is not None:
            raise self._exception
        if self._done is not None:
            event, device = self._done
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in _tensors_of(self._result):
                if t.is_cuda:
                    t.record_stream(stream)
        return self._result


_READY_LOCK = threading.Lock()
_READY_SEQ = itertools.count()


def wait_ready(stream, entries):
    """Make ``stream`` wait until every entry's tensors were produced: one
    wait per submitting stream, on its latest ready event."""
    latest = {}
    for e in entries:
        if e.ready is not None:
            key, seq, event = e.ready
            if key not in latest or latest[key][0] < seq:
                latest[key] = (seq, event)
    for _, event in latest.values():
        stream.wait_event(event)


class TensorEntry:
    """One submitted operation. ``tensors`` are dense; for CUDA tensors
    ``ready`` holds an event recorded on the submitting thread's current
    stream."""

    __slots__ = ("name", "kind", "tensors", "op", "root_rank", "splits",
                 "prescale", "postscale", "process_set", "handle",
                 "enqueue_time", "ready", "device", "site", "codec",
                 "uneven", "guard_token", "corr", "chaos_mismatch",
                 "device_done")

    def __init__(self, name, kind, tensors, process_set, op=None,
                 root_rank=None, splits=None, prescale=None, postscale=None,
                 codec=None, uneven=False):
        self.name = name
        self.kind = kind
        self.tensors = tensors
        self.process_set = process_set
        self.op = op
        self.root_rank = root_rank   # index within the process set
        self.splits = splits
        self.prescale = prescale
        self.postscale = postscale
        self.handle = Handle(name)
        self.enqueue_time = time.monotonic()
        self.handle.enqueue_time = self.enqueue_time
        self.site = None
        # Compression: a codec name at submit (an explicit
        # Compression.int8-style marker), resolved by the plane's stamp()
        # into the (name, block) pair the fusion plane groups by; None =
        # uncompressed.
        self.codec = codec
        # A ragged allgather: dim 0 may differ per rank (the consistency
        # digest leaves it out).
        self.uneven = uneven
        # Set by the consistency guard when this submission is one it
        # verifies before dispatch: (name, occurrence, digest).
        self.guard_token = None
        # The trace plane's occurrence number of this name (its
        # correlation key across ranks), stamped by Tracer.on_submit.
        self.corr = None
        # Chaos 'collective:mismatch': the guardian publishes a corrupted
        # digest for this submission.
        self.chaos_mismatch = False
        # A CUDA collective's (done event, tracing.DeviceClock), set when
        # it was issued: its trace ``fin`` waits for that event.
        self.device_done = None
        self.device = tensors[0].device if tensors else None
        self.ready = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            event = torch.cuda.Event()
            with _READY_LOCK:
                # (stream, order of recording, event): a waiter needs only
                # the latest event of each stream.
                event.record(stream)
                self.ready = (stream.cuda_stream, next(_READY_SEQ), event)


def _nbytes(t):
    return t.numel() * t.element_size()


class Coordinator:
    def __init__(self, runtime):
        self.runtime = runtime
        self.cycle_time_s = envparse.get_float(
            envparse.CYCLE_TIME, DEFAULT_CYCLE_TIME_MS) / 1000.0
        self.fusion_threshold = envparse.get_int(
            envparse.FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD)
        self._queue = []
        # Chaos 'collective:stall' victims: never dispatched, kept so that
        # an abort or shutdown still fails their waiters.
        self._chaos_stalled = []
        # Set when a watchdog abort could not release the backend's work.
        self._broken = None
        # Launcher jobs with a watchdog: its scan runs on a thread of its
        # own (a native cycle blocked on a frozen peer never returns to
        # scan), which hands an abort to the cycle thread.
        self._watch_thread = None
        self._abort_request = None
        self._in_cycle_since = None
        # (process_set_id, name) -> [enqueue_time, callsite] for every
        # in-flight named op: duplicate detection and the stall scan.
        self._pending_names = {}
        self._lock = sanitizer.make_lock("coordinator.queue")
        self._wakeup = threading.Event()
        self._running = False
        self._thread = None
        self._stream = None   # the Python plane's CUDA stream
        self._clock = None    # its tracing.DeviceClock (tracer on)
        self._log = get_logger()
        self.cycles = 0
        self.busy_s = 0.0     # the native loop's time outside its waits
        self.submitted = 0
        self.bytes_processed = 0
        self.tensors_processed = 0
        # Stall warning (HOROVOD_TPU_STALL_CHECK_TIME, legacy spelling
        # STALL_CHECK_TIME_SECONDS; 0 / STALL_CHECK_DISABLE turns it off).
        if envparse.get_bool(envparse.STALL_CHECK_DISABLE):
            self.stall_warn_s = 0.0
        else:
            self.stall_warn_s = envparse.get_float(
                envparse.STALL_CHECK_TIME, envparse.get_float(
                    envparse.STALL_CHECK_TIME_SECONDS,
                    DEFAULT_STALL_WARN_S))
        # Data-plane guardian (guardian.py): both None when their knobs are
        # unset, and the hot paths pay one attribute check.
        from . import guardian
        self._guardian = guardian.make_guard(runtime)
        self._watchdog = guardian.make_watchdog(runtime)
        self._stall_scan_period = (max(1.0, min(self.stall_warn_s / 2.0,
                                                10.0))
                                   if self.stall_warn_s > 0 else 10.0)
        # Age past which an op counts as stalled for the scan: the warning
        # threshold, tightened to half the abort timeout under a watchdog;
        # the scans come often enough to notice the timeout.
        self._stall_observe_s = (self.stall_warn_s if self.stall_warn_s > 0
                                 else float("inf"))
        if self._watchdog is not None:
            self._stall_scan_period = max(0.25, min(
                self._stall_scan_period, self._watchdog.timeout_s / 4.0))
            self._stall_observe_s = min(self._stall_observe_s,
                                        self._watchdog.timeout_s / 2.0)
        self._last_stall_scan = time.monotonic()
        self._stall_logged = set()
        self._stall_last_log = -float("inf")
        # Metrics plane: with HOROVOD_TPU_METRICS off every factory returns
        # the shared no-op, so the hot paths stay unconditional.
        self._metrics_on = telemetry.enabled()
        self._m_cycle_s = telemetry.histogram(
            "hvd_coordinator_cycle_seconds",
            "Duration of coordinator cycles that moved tensors")
        self._m_queue_depth = telemetry.gauge(
            "hvd_coordinator_queue_depth",
            "Entries drained from the submission queue by the last cycle")
        self._m_queue_wait_s = telemetry.histogram(
            "hvd_coordinator_queue_wait_seconds",
            "Time an entry waited between submit() and dispatch")
        self._m_dispatch_s = telemetry.histogram(
            "hvd_coordinator_dispatch_seconds",
            "Backend dispatch latency per operation (span duration)",
            labelnames=("kind",))
        self._m_ops = telemetry.counter(
            "hvd_coordinator_ops_total",
            "Operations dispatched to the backend", labelnames=("kind",))
        self._m_fused_bytes = telemetry.counter(
            "hvd_coordinator_fused_bytes_total",
            "Payload bytes through the fusion plane", labelnames=("dtype",))
        # The port's fusion pads nothing (a fused buffer is the tensors
        # concatenated): padding stays 0 and the efficiency 1.
        self._m_fusion_payload = telemetry.counter(
            "hvd_coordinator_fusion_payload_bytes_total",
            "Fused payload bytes (excluding atomic-unit padding)")
        self._m_fusion_padding = telemetry.counter(
            "hvd_coordinator_fusion_padding_bytes_total",
            "Bytes of atomic-unit padding the fusion plane would add")
        self._m_fusion_eff = telemetry.gauge(
            "hvd_coordinator_fusion_efficiency",
            "payload / (payload + padding) of the last fused buffer")
        # The JAX package's bucketed-overlap families, under their names
        # and schema. Their source, the overlap plane (HVDTPU_OVERLAP),
        # is not ported: the port's cycle thread never blocks on a
        # collective (NCCL runs on the backend's stream), so they hold no
        # sample.
        self._m_overlap_fraction = telemetry.gauge(
            "hvd_overlap_fraction",
            "Share of the last cycle's collective in-flight time hidden "
            "under other work (issue/prep of later buckets) rather than "
            "blocking the cycle thread")
        self._m_overlap_hidden_s = telemetry.histogram(
            "hvd_overlap_hidden_seconds",
            "Per-bucket collective time hidden under later dispatches")
        self._m_stalled = telemetry.gauge(
            "hvd_coordinator_stalled_ops",
            "In-flight operations older than the stall threshold")
        self._m_stalled_oldest = telemetry.gauge(
            "hvd_coordinator_stalled_oldest_age_seconds",
            "Age of the oldest stalled operation")
        self._m_aborts = telemetry.counter(
            "hvd_collective_abort_total",
            "Coordinated watchdog aborts of in-flight collectives")
        # Gradient-compression plane (compression/): None when
        # HVDTPU_COMPRESSION is unset, built on demand for an explicit
        # per-call codec. Sparse gradient plane (ops/sparse.py): None when
        # HVDTPU_SPARSE is unset (sparse gradients then densify).
        from . import compression as compression_mod
        from .ops import sparse as sparse_mod
        self._compression = compression_mod.make_plane(runtime)
        self._sparse = sparse_mod.make_plane()
        # Cross-rank trace plane (tracing/): None when HVDTPU_TRACE is off
        # and the flight recorder is disabled; then submit and completion
        # pay one attribute check. With only the (default-on) flight
        # recorder, each event is a bounded deque append.
        from . import tracing
        self._tracer = tracing.make_tracer(runtime)
        runtime.tracer = self._tracer
        # Chaos 'collective' point (HVDTPU_CHAOS): cached, so that the
        # disabled path costs one attribute check per submission.
        self._chaos_on = chaos.enabled()
        # Opt-in submission-order guard (HOROVOD_TPU_ORDER_CHECK=1). None
        # when disabled: the hot path pays one attribute check and
        # allocates nothing (analysis/order_guard.py).
        self._order_guard = None
        self._order_error = None
        self._order_thread = None
        self._order_record_path = None
        if envparse.get_bool(envparse.ORDER_CHECK):
            from .analysis.order_guard import SubmissionOrderGuard
            self._order_record_path = (
                envparse.get_str(envparse.ORDER_CHECK_RECORD) or None)
            spmd = getattr(runtime, "mode", None) == "spmd"
            self._order_guard = SubmissionOrderGuard(
                rank=runtime.topology.rank,
                record=(not spmd) or bool(self._order_record_path))

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        # start() drains a previous cycle thread first, then creates and
        # starts the new one under the lock, so that a concurrent stop()
        # never joins a stale thread and two cycle threads never run.
        with self._lock:
            if self._running:
                return
            prev = self._thread
        if prev is not None:
            prev.join(timeout=10)
        with self._lock:
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="hvd-torch-coordinator", daemon=True)
            self._thread.start()
            if self._watchdog is not None and getattr(
                    self.runtime.backend, "drives_own_cycle", False):
                self._watch_thread = threading.Thread(
                    target=self._watch_loop, name="hvd-torch-watchdog",
                    daemon=True)
                self._watch_thread.start()
        if (self._order_guard is not None
                and getattr(self.runtime, "mode", None) == "spmd"
                and self.runtime.topology.size > 1):
            self._order_thread = threading.Thread(
                target=self._order_check_loop,
                name="hvd-torch-order-check", daemon=True)
            self._order_thread.start()

    def stop(self):
        with self._lock:
            if not self._running:
                return
            # Flip under the lock so that no submit() slips into a queue
            # that will never be serviced.
            self._running = False
        self._wakeup.set()
        self._thread.join(timeout=10)
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=10)
        if self._order_thread is not None:
            self._order_thread.join(timeout=10)
        if (self._order_guard is not None
                and self._order_record_path is not None):
            try:
                path = self._order_guard.dump(self._order_record_path)
                self._log.info("submission-order record written to %s",
                               path)
            except OSError as exc:
                self._log.warning("could not write ORDER_CHECK record: %s",
                                  exc)
        if self._tracer is not None:
            if self._device_aborted():
                self._tracer.fail_device()
            else:
                self._tracer.drain_device(FIN_DRAIN_S)
        with self._lock:
            stranded = self._queue + self._chaos_stalled
            self._queue = []
            self._chaos_stalled = []
            self._pending_names.clear()
        for e in stranded:
            e.handle._fail(HorovodInternalError(
                "Coordinator shut down with operations in flight"))

    # -- submission (framework-thread side) --------------------------------
    def submit(self, entry):
        if self._chaos_on:
            # A matching fail rule raises HorovodInternalError here, the
            # exception a real collective failure surfaces, so that the
            # elastic restore path runs end to end. The signal actions
            # (stall, mismatch) are applied here.
            try:
                chaos.inject("collective", name=entry.name,
                             kind=entry.kind)
            except chaos.ChaosSignal as sig:
                if sig.action == "stall":
                    return self._chaos_swallow(entry)
                if sig.action == "mismatch":
                    entry.chaos_mismatch = True
        if entry.kind == "allreduce" and (self._compression is not None
                                          or entry.codec is not None):
            if self._compression is None:
                # An explicit Compression.int8-style marker with the env
                # policy unset: build the plane now.
                from . import compression as compression_mod
                self._compression = compression_mod.make_plane(
                    self.runtime, force=True)
                self.runtime.backend.compression_plane = self._compression
            # Raises the Adasum and process-set rejects here, on the
            # submitting thread; before the digest, so that every rank's
            # digest carries the codec it selected.
            self._compression.stamp(entry)
        if self._guardian is not None:
            # Publish the digest before the entry can reach a cycle, so
            # that a peer's verify never waits for it; outside the lock.
            self._guardian.on_submit(entry)
        if self._tracer is not None:
            # Stamp the correlation key (name x occurrence x elastic
            # version) and record the submission: the cross-rank merge
            # joins every rank's span on this key.
            self._tracer.on_submit(entry)
        key = (entry.process_set.process_set_id, entry.name)
        if entry.name and entry.site is None:
            entry.site = format_user_frame(skip=3)
        guard = self._order_guard
        with self._lock:
            if self._broken is not None:
                raise self._broken
            if not self._running:
                raise HorovodInternalError(
                    "Coordinator is shut down; cannot submit operations")
            if guard is not None and self._order_error is not None:
                raise self._order_error
            if entry.name and key in self._pending_names:
                raise self._duplicate_error(entry, key)
            if entry.name:
                self._pending_names[key] = [entry.enqueue_time, entry.site]
            self._queue.append(entry)
            self.submitted += 1
            if (guard is not None and entry.name
                    and not entry.name.startswith(GUARD_PREFIX)):
                # Inside the lock, so that the digest stream is the queue's
                # order even with concurrent submitting threads.
                guard.record(entry.name, entry.kind, callsite=entry.site)
        self._wakeup.set()
        return entry.handle

    def _chaos_swallow(self, entry):
        """Chaos 'collective:stall': this rank never submits the op, its
        peers stall on it and the watchdog has to name this rank and
        abort. The entry waits in ``_chaos_stalled``, so that the abort
        (or shutdown) still fails its waiter."""
        with self._lock:
            if not self._running:
                raise HorovodInternalError(
                    "Coordinator is shut down; cannot submit operations")
            self._chaos_stalled.append(entry)
        self._log.warning(
            "chaos: collective %r swallowed (stall injection): this rank "
            "will never submit it", entry.name)
        return entry.handle

    def _duplicate_error(self, entry, key):
        return DuplicateNameError(
            f"Duplicate tensor name {entry.name!r} in flight for process "
            f"set {entry.process_set.process_set_id}: first submitted at "
            f"{self._pending_names[key][1]}, duplicate submitted at "
            f"{entry.site}. Names must be unique among in-flight "
            "operations (reference: horovod/common/tensor_queue.cc). If "
            "the name is auto-generated, rank-divergent call orders are "
            "the usual cause.")

    def _release_name(self, entry):
        if entry.name:
            with self._lock:
                self._pending_names.pop(
                    (entry.process_set.process_set_id, entry.name), None)

    def _entry_done(self, entry, ok=True):
        """Native-plane completion callback: release the name before the
        backend completes the handle, and record the trace completion
        (``ok=False`` on failure paths, so that merged traces and
        postmortems flag the failed collective). A response the native
        core fused completes each of its entries here: every entry keeps
        its own span, from its submission to the response's completion,
        so the entries of one response share their end."""
        self._release_name(entry)
        self._trace_done(entry, ok)

    def _trace_done(self, entry, ok=True):
        """Record an entry's trace completion. A CUDA collective's ``fin``
        is the time its done event ran on the card, recorded once the
        event has completed (``Tracer.defer_complete``, polled by the
        cycle thread); a failure and a host-plane operation are stamped
        now. The handle itself completed at enqueue: only the record
        waits."""
        tracer = self._tracer
        if tracer is None:
            return
        if ok and entry.device_done is not None:
            tracer.defer_complete(entry, *entry.device_done)
        else:
            tracer.on_complete(entry, ok=ok)

    def _device_aborted(self):
        aborted = getattr(self.runtime.backend, "device_aborted", None)
        return aborted is not None and aborted()

    def _poll_device_fins(self):
        """The cycle thread's sweep of the deferred ``fin``s: recorded
        with ``err`` 1 at once when the backend aborted, else those whose
        event has completed."""
        if self._device_aborted():
            self._tracer.fail_device()
        else:
            self._tracer.poll_device()

    # -- background cycle --------------------------------------------------
    def _loop(self):
        # The cycle thread paces the whole data plane, so any blocking
        # call on it is a finding for the sanitize tripwire. Unmarked on
        # exit: thread idents are recycled, and a stale entry would mark
        # an unrelated later thread critical across elastic restarts.
        sanitizer.mark_critical("coordinator-cycle")
        try:
            dev = self.runtime.device
            if dev.type != "cuda":
                self._run_loop()
                return
            with torch.cuda.device(dev):
                self._stream = torch.cuda.Stream(dev)
                if self._tracer is not None and not getattr(
                        self.runtime.backend, "drives_own_cycle", False):
                    # The Python plane's fins (a launcher job's backend
                    # times its own stream).
                    from .tracing.recorder import DeviceClock
                    self._clock = DeviceClock(self._stream)
                self._run_loop()
        finally:
            sanitizer.unmark_critical()

    def _run_loop(self):
        backend = self.runtime.backend
        if getattr(backend, "drives_own_cycle", False):
            self._loop_native(backend)
            return
        while self._running:
            self._wakeup.wait(timeout=0.25)
            self._wakeup.clear()
            if not self._running:
                break
            time.sleep(self.cycle_time_s)
            self._run_cycle()
            if self._tracer is not None and self._tracer.device_pending():
                self._poll_device_fins()
            if self.stall_warn_s > 0 or self._watchdog is not None:
                self._check_stalls()

    def _loop_native(self, backend):
        """Launcher jobs: the native core owns negotiation and fusion
        (local grouping decisions would diverge across ranks), so every
        entry goes to the backend and the loop drives cycles (reference:
        operations.cc:706 RunLoopOnce). Cycles run with nothing in flight
        too, every ``IDLE_CYCLE_S`` or at the next submission: peers may
        need this rank to negotiate."""
        backend.entry_done_cb = self._entry_done
        backend.runtime = self.runtime   # the timeline, for its spans
        # The tcp-native plane runs wire codecs with error feedback through
        # the compression plane (None when off).
        backend.compression_plane = self._compression
        if self._watchdog is not None:
            # Executed responses stay in view until the card finished them.
            backend.track_device = True
        while self._running:
            if not (self._queue or backend.pending_count()):
                self._wakeup.wait(timeout=IDLE_CYCLE_S)
            self._wakeup.clear()
            # A cycle time between the first submission and the drain, as on
            # the Python plane: the submissions of a burst fuse.
            time.sleep(self.cycle_time_s)
            # Raw begin/end pair instead of the span API on purpose: the
            # pair also feeds busy_s on every cycle, and only cycles that
            # MOVED tensors may observe (the native loop polls
            # continuously and idle ticks would drown the histogram),
            # while a span observes unconditionally.
            # hvd-lint: disable=HVD207
            t0 = time.perf_counter()
            with self._lock:
                batch = self._queue
                self._queue = []
            self.cycles += 1
            cycle_ts_us = time.perf_counter_ns() // 1000
            if self._guardian is not None and batch:
                batch = self._verify_consistency(batch)
            if self._metrics_on and batch:
                self._record_dispatch(batch)
            try:
                for e in batch:
                    backend.submit_entry(e)
                self._in_cycle_since = time.monotonic()
                processed = backend.run_cycle()
                self._in_cycle_since = None
                if self._tracer is not None and \
                        self._tracer.device_pending():
                    self._poll_device_fins()
                with self._lock:
                    diagnostic, self._abort_request = \
                        self._abort_request, None
                if diagnostic is not None:
                    self._abort_inflight(diagnostic)
            except Exception as exc:  # noqa: BLE001 - keeps waiters alive
                # The backend isolates each entry's failures; anything
                # else would leave every waiter blocked on a dead thread.
                self._log.exception("native cycle failed")
                backend.abort_inflight(HorovodInternalError(
                    f"native cycle failed: {exc}"))
                processed = 0
            busy = time.perf_counter() - t0
            self.busy_s += busy
            if self._metrics_on and processed:
                self._m_cycle_s.observe(busy)  # hvd-lint: disable=HVD207
                self._m_queue_depth.set(len(batch))
            self.tensors_processed += processed
            self.bytes_processed = backend.bytes_processed()
            timeline = self.runtime.timeline
            if processed and timeline is not None and timeline.mark_cycles:
                # Only cycles that moved tensors; idle ticks would flood
                # the trace.
                timeline.marker("CYCLE_START", ts_us=cycle_ts_us)
            tuner = getattr(self.runtime, "autotuner", None)
            if tuner is not None:
                # Candidate switches are driven by the count of cycles
                # that moved bytes, so every rank applies the same knob
                # at the same negotiation round.
                tuner.record_cycle()
            if self.stall_warn_s > 0 and self._watch_thread is None:
                self._check_stalls()

    def _watch_loop(self):
        """The watchdog's thread (launcher jobs): the stall scan, off the
        cycle thread. It carries the JAX package's cycle-thread role of
        running the watchdog scans, and it must never block (it aborts
        NCCL), so it is critical for the sanitize tripwire too."""
        sanitizer.mark_critical("coordinator-watchdog")
        try:
            while self._running:
                # Scan pacing: a bounded sleep, not a blocking call.
                with sanitizer.allowed("watchdog scan pacing (bounded)"):
                    time.sleep(0.25)   # the shortest scan period
                if self._running:
                    self._check_stalls()
        finally:
            sanitizer.unmark_critical()

    def _order_check_loop(self):
        """Cross-rank check of the submission-order digests (launcher
        jobs): allgather each rank's recent checkpoint digests and compare
        them at a common submission index (analysis/order_guard.py). The
        payload is a uint8 tensor on the rank's device (the NCCL plane's
        card, the CPU under gloo and tcp-native). On a thread of its own,
        so that the allgather never stalls the cycle thread; each rank's
        rounds run on its own clock, and the allgather of a round
        realigns them."""
        import numpy as np

        from .exceptions import SubmissionOrderError
        from .ops import collectives
        interval = max(0.2, envparse.get_float(
            envparse.ORDER_CHECK_INTERVAL, DEFAULT_ORDER_CHECK_INTERVAL_S))
        size = self.runtime.topology.size
        round_no = 0
        waited = 0.0
        while self._running:
            time.sleep(0.2)
            waited += 0.2
            if waited < interval or not self._running:
                continue
            waited = 0.0
            round_no += 1
            try:
                payload = torch.from_numpy(
                    self._order_guard.sync_payload()).to(self.runtime.device)
                handle = collectives.allgather_async(
                    payload, name=f"{GUARD_PREFIX}order_check.{round_no}")
                # A peer that stopped never joins this round: stop waiting
                # with the coordinator.
                while not handle.poll():
                    if not self._running:
                        return
                    time.sleep(0.01)
                gathered = handle.wait().cpu().numpy()
                self._order_guard.verify(np.asarray(gathered), size)
            except SubmissionOrderError as exc:
                self._order_error = exc
                self._log.error("%s", exc)
                return
            except Exception as exc:  # noqa: BLE001 - an advisory check
                if self._running:
                    self._log.debug("order check round skipped: %s", exc)

    def _request_abort(self, diagnostic):
        """Abort on the cycle thread, which owns the backend; from the
        watchdog's thread the request is handed over, and a cycle thread
        stuck in a native cycle for a scan period (a frozen peer) is
        unblocked first (``backend.unblock``)."""
        if self._watch_thread is None:
            self._abort_inflight(diagnostic)
            return
        with self._lock:
            self._abort_request = diagnostic
        self._wakeup.set()
        since = self._in_cycle_since
        if since is not None and \
                time.monotonic() - since > self._stall_scan_period:
            from .exceptions import CollectiveAbortError
            try:
                self.runtime.backend.unblock(CollectiveAbortError(diagnostic))
            except Exception as exc:  # noqa: BLE001 - raised to callers
                self._log.exception("unblocking the native cycle failed")
                self._broken = CollectiveAbortError(
                    f"{diagnostic}\nUnblocking the native cycle failed "
                    f"({type(exc).__name__}: {exc}); shut the runtime "
                    "down before the next collective.")

    def _check_stalls(self, now=None):
        """Scan for operations in flight longer than the stall threshold
        (the reference's stall inspector, horovod/common/
        stall_inspector.cc): feed the stalled-op gauges and log one summary
        per change of the stalled set, naming the ranks that never
        submitted the oldest op when a watchdog gathers the peers' views.
        With ``HVDTPU_COLLECTIVE_TIMEOUT`` armed, past the timeout (or on a
        peer's abort notice) every in-flight operation is aborted with
        ``CollectiveAbortError``. A response NCCL was handed counts as in
        flight until the card finished it (``device_inflight``): a peer
        frozen inside a collective leaves the host nothing else to see.
        Scans at most every ``_stall_scan_period`` seconds."""
        if now is None:
            now = time.monotonic()
        if now - self._last_stall_scan < self._stall_scan_period:
            return
        self._last_stall_scan = now
        stalled = []
        with self._lock:
            inflight = [key[1] for key in self._pending_names if key[1]]
            for key, info in self._pending_names.items():
                age = now - info[0]
                if age > self._stall_observe_s and \
                        not key[1].startswith(GUARD_PREFIX):
                    # The order guard's rounds wait in negotiation for
                    # the peers' timers, not on a stuck peer.
                    stalled.append((key[1], age, info[1]))
            for e in self._chaos_stalled:
                age = now - e.enqueue_time
                if age > self._stall_observe_s:
                    stalled.append((e.name, age, None))
        wd = self._watchdog
        peer_abort = None
        if wd is not None:
            device = getattr(self.runtime.backend, "device_inflight", None)
            for name, age in (device(now) if device is not None else ()):
                inflight.append(name)
                if age > self._stall_observe_s:
                    stalled.append((name, age, "the card (NCCL)"))
            # Every scan publishes this rank's view, so that a peer never
            # judges a stale one; the peers are read only on a stall.
            _, peer_abort = wd.observe(
                inflight, [(n, a) for n, a, _ in stalled], now)
        if not stalled:
            self._m_stalled.set(0)
            self._m_stalled_oldest.set(0.0)
            self._stall_logged = set()
            return
        stalled.sort(key=lambda item: -item[1])
        self._m_stalled.set(len(stalled))
        self._m_stalled_oldest.set(stalled[0][1])
        if wd is not None and (peer_abort is not None
                               or wd.should_abort(stalled[0][1])):
            if self._abort_request is None:
                self._request_abort(self._abort_diagnostic(stalled,
                                                           peer_abort))
            return
        # The watchdog may observe below the warning threshold: warn only
        # about ops past it.
        stalled = [s for s in stalled if s[1] > self.stall_warn_s] \
            if self.stall_warn_s > 0 else []
        if not stalled:
            return
        oldest_name, oldest_age, oldest_site = stalled[0]
        current = {name for name, _, _ in stalled}
        if (current == self._stall_logged
                and now - self._stall_last_log < self.stall_warn_s):
            return
        self._stall_logged = current
        self._stall_last_log = now
        self._log.warning(
            "%d tensor(s) submitted over %.0f s ago have not completed: "
            "ranks may have diverged (some rank never submitted the "
            "matching op). Oldest: %s (%.0f s%s)%s. Tune via "
            "HOROVOD_TPU_STALL_CHECK_TIME.", len(stalled), self.stall_warn_s,
            oldest_name, oldest_age,
            f", submitted at {oldest_site}" if oldest_site else "",
            wd.describe_missing(oldest_name) if wd is not None else "")

    def _abort_diagnostic(self, stalled, peer_abort):
        wd = self._watchdog
        if peer_abort is not None:
            return (f"coordinated abort joined (initiated by a peer): "
                    f"{peer_abort}")
        lines = []
        for name, age, site in stalled:
            at = f", submitted at {site}" if site else ""
            lines.append(f"  {name}: in flight {age:.0f}s{at}"
                         f"{wd.describe_missing(name)}")
        return (f"stuck-collective watchdog: {len(stalled)} operation(s) "
                f"exceeded HVDTPU_COLLECTIVE_TIMEOUT={wd.timeout_s:g}s; "
                "aborting all in-flight collectives:\n" + "\n".join(lines))

    def _abort_inflight(self, diagnostic):
        """Coordinated abort: fail every in-flight handle (queued, or held
        by the backend in negotiation or on the card) with
        ``CollectiveAbortError`` carrying the diagnostic, and post the
        abort notice so that peers stop waiting too. The backend's abort
        raises if it cannot release what it holds (a failed NCCL abort):
        that failure is the cycle thread's to report, never passed over."""
        from .exceptions import CollectiveAbortError
        exc = CollectiveAbortError(diagnostic)
        self._log.error("%s", diagnostic)
        self._m_aborts.inc()
        if self._tracer is not None:
            # The collectives already on the card end with the abort: their
            # pending fins are recorded failed, without waiting.
            self._tracer.fail_device()
            # The ring still holds the events before the abort, and every
            # rank that joins the coordinated abort dumps its own: the
            # postmortem bundle is the last events of every rank.
            self._tracer.event("guardian", "abort", detail=diagnostic[:400])
            self._tracer.dump_postmortem("collective_abort")
        self._watchdog.post_abort(diagnostic)
        with self._lock:
            victims = self._queue + self._chaos_stalled
            self._queue = []
            self._chaos_stalled = []
            self._pending_names.clear()
        try:
            self.runtime.backend.watchdog_abort(exc)
        except Exception as backend_exc:  # noqa: BLE001 - raised below
            # What the backend could not release may still hold the card:
            # this runtime runs no further collective, and every caller
            # from here on gets the failure.
            self._log.exception("the backend's abort failed")
            exc = CollectiveAbortError(
                f"{diagnostic}\nThe backend's abort failed "
                f"({type(backend_exc).__name__}: {backend_exc}); shut the "
                "runtime down before the next collective.")
            self._broken = exc
        for e in victims:
            e.handle._fail(exc)
        self._m_stalled.set(0)
        self._m_stalled_oldest.set(0.0)
        self._stall_logged = set()

    def _verify_consistency(self, batch):
        """Pre-dispatch digest verification (guardian.ConsistencyGuard):
        a sampled entry compares every rank's published metadata; a
        divergence (``CollectiveMismatchError``) or a peer that published
        nothing in time (``CollectiveAbortError``) fails that entry's
        handle alone, and the rest of the batch dispatches."""
        from .exceptions import CollectiveAbortError, CollectiveMismatchError
        ok = []
        for e in batch:
            if e.guard_token is None:
                ok.append(e)
                continue
            try:
                self._guardian.verify(e)
            except (CollectiveMismatchError, CollectiveAbortError) as exc:
                self._log.error("%s", exc)
                if self._tracer is not None:
                    if isinstance(exc, CollectiveMismatchError):
                        self._tracer.event("guardian", "mismatch",
                                           coll=e.name, detail=str(exc)[:400])
                        self._tracer.dump_postmortem("collective_mismatch")
                    self._tracer.on_complete(e, ok=False)
                self._release_name(e)
                e.handle._fail(exc)
                continue
            ok.append(e)
        return ok

    # -- the Python plane (single-process jobs) ----------------------------
    def _run_cycle(self):
        with self._lock:
            batch = self._queue
            self._queue = []
        if self._guardian is not None and batch:
            batch = self._verify_consistency(batch)
        if not batch:
            return
        self._m_queue_depth.set(len(batch))
        self.cycles += 1
        tuner = getattr(self.runtime, "autotuner", None)
        if tuner is not None:
            tuner.record_cycle()
        timeline = self.runtime.timeline
        if timeline is not None and timeline.mark_cycles:
            timeline.marker("CYCLE_START")
        backend = self.runtime.backend
        fusible = [e for e in batch if e.kind == "allreduce"]
        others = [e for e in batch if e.kind != "allreduce"]
        with tele_span((), "CYCLE", histogram=self._m_cycle_s):
            try:
                if fusible:
                    self._run_fused_allreduces(backend, fusible, timeline)
                for e in others:
                    self._run_single(backend, e, timeline)
            finally:
                # Failure paths: success paths released their names
                # before completing the handles.
                with self._lock:
                    for e in batch:
                        if e.name:
                            self._pending_names.pop(
                                (e.process_set.process_set_id, e.name),
                                None)

    def _run_fused_allreduces(self, backend, entries, timeline):
        """Group by (process set, op, scales, dtype, codec) and split each
        group into buckets under the fusion threshold, a whole entry at a
        time; one backend call per bucket. The codec is part of the key: a
        compressed bucket runs one quantized pipeline."""
        groups = {}
        for e in entries:
            pre = 1.0 if e.prescale is None else float(e.prescale)
            post = 1.0 if e.postscale is None else float(e.postscale)
            key = (e.process_set.process_set_id, e.op, pre, post,
                   e.tensors[0].dtype, e.codec)
            groups.setdefault(key, []).append(e)
        for group in groups.values():
            cur, cur_bytes = [], 0
            for e in group:
                b = sum(_nbytes(t) for t in e.tensors)
                if cur and cur_bytes + b > self.fusion_threshold:
                    self._execute_allreduce_bucket(backend, cur, timeline)
                    cur, cur_bytes = [], 0
                cur.append(e)
                cur_bytes += b
            if cur:
                self._execute_allreduce_bucket(backend, cur, timeline)

    def _issue(self, entries):
        """Order the cycle's stream after the submitters' streams; returns
        a context that runs the operation on it."""
        if self._stream is None:
            return contextlib.nullcontext()
        wait_ready(self._stream, entries)
        for e in entries:
            for t in e.tensors:
                t.record_stream(self._stream)
        return torch.cuda.stream(self._stream)

    def _done_event(self):
        if self._stream is None:
            return None
        # Timed when the tracer is on: the event is also the trace fin's.
        done = torch.cuda.Event(enable_timing=self._clock is not None)
        done.record(self._stream)
        return done, self._stream.device

    def _defer_fins(self, entries, done):
        """Tie the entries' trace ``fin`` to the Python plane's done
        event (tracer on, CUDA)."""
        if done is not None and self._clock is not None:
            for e in entries:
                e.device_done = (done[0], self._clock)

    def _execute_allreduce_bucket(self, backend, bucket, timeline):
        e0 = bucket[0]
        names = [e.name for e in bucket]
        if self._metrics_on:
            self._record_dispatch(bucket, fused=True)
        try:
            with tele_span(names, "FUSED_ALLREDUCE", timeline=timeline,
                           histogram=self._m_dispatch_s.labels(
                               kind="fused_allreduce")):
                flat = [t for e in bucket for t in e.tensors]
                with self._issue(bucket):
                    if e0.codec is not None:
                        results = self._run_compressed(backend, bucket, flat,
                                                       e0)
                    else:
                        results = backend.allreduce(
                            flat, e0.op, e0.process_set,
                            prescale=e0.prescale, postscale=e0.postscale)
                    done = self._done_event()
                self._defer_fins(bucket, done)
                i = 0
                for e in bucket:
                    k = len(e.tensors)
                    # Release the name BEFORE completing the handle: a
                    # waiter may resubmit the same name the moment wait()
                    # returns (reference: the tensor queue erases the entry
                    # when the response reaches the op layer).
                    self._release_name(e)
                    e.handle._complete(results[i:i + k], done)
                    self._trace_done(e)
                    self.tensors_processed += k
                    self.bytes_processed += sum(_nbytes(t)
                                                for t in e.tensors)
                    i += k
        except Exception as exc:  # noqa: BLE001 - propagate to handles
            self._log.error("fused allreduce failed: %s", exc)
            for e in bucket:
                e.handle._fail(_wrap_error(exc))
                if self._tracer is not None:
                    self._tracer.on_complete(e, ok=False)

    def _run_compressed(self, backend, bucket, flat, e0):
        """One compressed bucket. Cast codecs (fp16/bf16, from the env
        policy) ride a plain allreduce in the narrow dtype; wire codecs
        (int8/fp8) run the backend's quantized pipeline with the plane's
        error-feedback residuals."""
        from .compression import codecs
        codec_name, block = e0.codec
        codec = codecs.CODECS[codec_name]
        plane = self._compression
        if not codec.wire:
            cast = [codec.encode(t, block)[0] for t in flat]
            results = backend.allreduce(
                cast, e0.op, e0.process_set, prescale=e0.prescale,
                postscale=e0.postscale)
            plane.record(codec_name, bucket, flat, None)
            return [r.to(t.dtype) for r, t in zip(results, flat)]
        residuals = plane.residuals_in(bucket)
        results, new_residuals = backend.allreduce_quantized(
            flat, e0.op, e0.process_set, codec, block, prescale=e0.prescale,
            postscale=e0.postscale, residuals=residuals)
        if new_residuals is not None:
            plane.store_residuals(bucket, new_residuals)
        plane.record(codec_name, bucket, flat, new_residuals)
        return results

    def _run_single(self, backend, e, timeline):
        if self._metrics_on:
            self._record_dispatch([e])
        try:
            with tele_span([e.name], e.kind.upper(), timeline=timeline,
                           histogram=self._m_dispatch_s.labels(
                               kind=e.kind)):
                with self._issue([e]):
                    out = self._dispatch_single(backend, e)
                    done = self._done_event()
                self._defer_fins([e], done)
                self._release_name(e)
                e.handle._complete(out, done)
                self._trace_done(e)
        except Exception as exc:  # noqa: BLE001
            self._log.error("%s failed for %s: %s", e.kind, e.name, exc)
            e.handle._fail(_wrap_error(exc))
            if self._tracer is not None:
                self._tracer.on_complete(e, ok=False)

    def _record_dispatch(self, entries, fused=False):
        """Dispatch accounting (metrics on only): each entry's wait
        between submit() and dispatch, the operations by kind and, for a
        fused bucket, its payload bytes by dtype."""
        now = time.monotonic()
        for e in entries:
            self._m_queue_wait_s.observe(now - e.enqueue_time)
            self._m_ops.labels(kind=e.kind).inc()
        if not fused:
            return
        payload = sum(_nbytes(t) for e in entries for t in e.tensors)
        self._m_fused_bytes.labels(
            dtype=str(entries[0].tensors[0].dtype)).inc(payload)
        self._m_fusion_payload.inc(payload)
        self._m_fusion_padding.inc(0)   # nothing padded
        if payload:
            self._m_fusion_eff.set(1.0)

    def _dispatch_single(self, backend, e):
        if e.kind == "allgather":
            out = backend.allgather(e.tensors, e.process_set)
        elif e.kind == "broadcast":
            out = backend.broadcast(e.tensors, e.root_rank, e.process_set)
        elif e.kind == "alltoall":
            out = backend.alltoall(e.tensors[0], e.splits, e.process_set)
        elif e.kind == "reducescatter":
            out = backend.reducescatter(e.tensors, e.op, e.process_set)
        elif e.kind == "barrier":
            backend.barrier(e.process_set)
            out = None
        else:
            raise ValueError(f"Unknown op kind {e.kind}")
        self.tensors_processed += len(e.tensors)
        self.bytes_processed += sum(_nbytes(t) for t in e.tensors)
        return out


def _wrap_error(exc):
    if isinstance(exc, (HorovodInternalError, DuplicateNameError,
                        ValueError)):
        return exc
    return HorovodInternalError(str(exc))

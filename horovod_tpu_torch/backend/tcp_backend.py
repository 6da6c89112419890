"""Launcher-job data plane on CPU tensors, backed by the native core (port
of ``horovod_tpu/backend/tcp_backend.py``; the gloo analog, reference:
horovod/common/ops/gloo_operations.cc).

N launcher-spawned processes negotiate named tensors through the native
controller (``csrc/core/controller.cc``) and move the bytes with ring
collectives over a TCP mesh (``csrc/core/collectives.cc``). The backend
owns the cycle: local fusion decisions would diverge across ranks, so the
coordinator hands it every entry (``drives_own_cycle``) and drives
``run_cycle``.

This plane carries CPU tensors only: the core copies a tensor's bytes at
enqueue. ``nccl_global.py`` delegates the data of the same negotiation to
``torch.distributed`` instead.

The gradient-reduction options: a wire-codec entry (int8/fp8) allgathers
its quantized payload and scales and sums them at the sweep, with the
compression plane's error-feedback residuals; a cast-codec entry rides the
ring in its narrow dtype; Adasum runs in the core (VHDD), one request per
tensor of a group.
"""

import time

import torch

from .. import chaos, native, tracing
from ..exceptions import HorovodInternalError, StalledTensorError
from ..ops import reduce_ops
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger

# How long close() waits for every rank to agree to shut down.
SHUTDOWN_DRAIN_S = 30.0

_OP_TO_RED = {
    reduce_ops.Sum: native.RED_SUM,
    reduce_ops.Min: native.RED_MIN,
    reduce_ops.Max: native.RED_MAX,
    reduce_ops.Product: native.RED_PROD,
}


class _Pending:
    """Bookkeeping from one TensorEntry to its native handles."""

    __slots__ = ("entry", "handles", "unpack", "t0", "nbytes")

    def __init__(self, entry, handles, unpack):
        self.entry = entry
        self.handles = handles
        self.unpack = unpack
        self.t0 = 0.0       # submit time, metrics on only
        self.nbytes = 0


def _sub_names(entry):
    """Native names of an entry's tensors: its own name for one tensor,
    ``name.i`` for several."""
    if len(entry.tensors) == 1:
        return [entry.name]
    return [f"{entry.name}.{i}" for i in range(len(entry.tensors))]


class TcpBackend:
    name = "tcp-native"
    drives_own_cycle = True
    # Subclasses run the native core in delegated mode: negotiation and
    # fusion stay native, the data ops execute in Python.
    delegate_data_ops = False

    def __init__(self, topology):
        peers = envparse.get_str(envparse.PEERS, "")
        if not peers:
            raise HorovodInternalError(
                "a launcher job needs HVDTPU_PEERS=host:port,... (one "
                "native-core listener per rank, in rank order)")
        timeline = envparse.get_str(envparse.TIMELINE, "")
        self.core = native.NativeCore(
            topology.rank, topology.size, transport="tcp", peers=peers,
            fusion_threshold=envparse.get_int(envparse.FUSION_THRESHOLD, 0),
            cache_capacity=envparse.get_int(envparse.CACHE_CAPACITY, 0),
            stall_warning_s=envparse.get_float(
                envparse.STALL_CHECK_TIME_SECONDS, 0.0),
            stall_shutdown_s=envparse.get_float(
                envparse.STALL_SHUTDOWN_TIME_SECONDS, 0.0),
            timeline_path=(timeline + f".rank{topology.rank}") if timeline
            else "",
            delegate_data_ops=self.delegate_data_ops)
        self.topology = topology
        # Hierarchical collectives: host_of[] from the peer list's host
        # parts; engaged only when the job spans several hosts.
        hier = envparse.get_int(envparse.HIERARCHICAL_THRESHOLD, 1 << 20)
        if hier > 0:
            host_ids = {}
            host_of = [host_ids.setdefault(p.rsplit(":", 1)[0],
                                           len(host_ids))
                       for p in peers.split(",")]
            if len(host_ids) > 1:
                self.core.set_topology(host_of, hier)
        # Owned by the coordinator's cycle thread once it starts; close()
        # runs after coordinator.stop() joined that thread.
        self._pending = []
        # Chaos 'backend_submit:stall' victims: never enqueued with the
        # native core, kept so that an abort, a transport death or close()
        # still fails their waiters.
        self._chaos_swallowed = []
        self._sync_seq = 0
        self._sweep_event = None
        self._transport_dead = False
        # Set by a watchdog abort: a peer that stopped taking part never
        # agrees to the consensus shutdown, so close() does not wait for it;
        # the abort's error then fails what the core still held.
        self._abandoned = False
        self._abort_exc = None
        self._peers = peers
        self._ps_map = {0: 0}   # python process-set id -> native id
        self._log = get_logger()
        # Set by the coordinator: releases an entry's name before its
        # handle completes; its compression plane (wire codecs with error
        # feedback), None when off.
        self.entry_done_cb = None
        self.compression_plane = None
        self._metrics_on = telemetry.enabled()
        # Chaos 'backend_submit' point (HVDTPU_CHAOS), cached: the disabled
        # path costs one compare per submission.
        self._chaos_on = chaos.enabled()
        self._m_time = telemetry.histogram(
            "hvd_backend_collective_seconds",
            "Per-collective backend wall time (negotiation included)",
            labelnames=("backend", "kind"))
        self._m_bytes = telemetry.counter(
            "hvd_backend_collective_bytes_total",
            "Payload bytes through backend collectives",
            labelnames=("backend", "kind"))

    # -- process sets -----------------------------------------------------
    def add_process_set(self, ps):
        if ps.process_set_id == 0:
            return
        self._ps_map[ps.process_set_id] = self.core.add_process_set(ps.ranks)

    def remove_process_set(self, ps):
        native_id = self._ps_map.pop(ps.process_set_id, None)
        if native_id:
            self.core.remove_process_set(native_id)

    def _native_ps(self, ps):
        try:
            return self._ps_map[ps.process_set_id]
        except KeyError:
            raise HorovodInternalError(
                f"process set {ps.process_set_id} not registered with the "
                "native core") from None

    # -- submission (called from the coordinator cycle thread) ------------
    def submit_entry(self, entry):
        """Translate a TensorEntry into native enqueues; on a synchronous
        failure its handle fails at once."""
        try:
            if self._chaos_on:
                # A matching fail rule raises HorovodInternalError here,
                # which the except below routes to the entry's handle:
                # the path a native enqueue failure takes.
                try:
                    chaos.inject("backend_submit", name=entry.name,
                                 kind=entry.kind)
                except chaos.ChaosSignal as sig:
                    if sig.action == "stall":
                        # Swallowed below the coordinator: the op stays in
                        # this rank's in-flight view but never reaches the
                        # negotiation, a hang for the watchdog to time
                        # out (its abort reaches the entry through
                        # _fail_all).
                        self._log.warning(
                            "chaos: backend submission %r swallowed "
                            "(stall injection)", entry.name)
                        self._chaos_swallowed.append(entry)
                        return
                    raise
            pending = self._enqueue_entry(entry)
            if self._metrics_on:
                pending.t0 = time.perf_counter()
                pending.nbytes = telemetry.payload_nbytes(entry.tensors)
            # Trace plane: the instant this entry entered the native
            # negotiation; on the merged trace the gap between this and
            # the peers' marks is the negotiation wait (one global read
            # and a None check when the plane is off).
            tracing.trace_event("neg", entry.name or entry.kind,
                                o=getattr(entry, "corr", None))
            self._pending.append(pending)
        except Exception as exc:  # noqa: BLE001 - surfaced via the handle
            if self.entry_done_cb:
                self.entry_done_cb(entry, ok=False)
            entry.handle._fail(exc if isinstance(exc, HorovodInternalError)
                               else HorovodInternalError(str(exc)))

    def _red_op(self, entry, n):
        """Framework reduce op -> (native op, extra postscale)."""
        op = entry.op
        if op is None or op == reduce_ops.Average:
            return native.RED_SUM, 1.0 / n
        if op == reduce_ops.Adasum:
            # VHDD on the host plane (csrc/core/collectives.cc VhddAdasum;
            # reference adasum/adasum.h:194-343). No postscale: the
            # combination is the result.
            return native.RED_ADASUM, 1.0
        try:
            return _OP_TO_RED[op], 1.0
        except KeyError:
            raise HorovodInternalError(
                f"unknown reduce op {op!r}") from None

    def _enqueue_entry(self, entry):
        for t in entry.tensors:
            if t.device.type != "cpu":
                raise HorovodInternalError(
                    f"{entry.name!r}: the tcp-native plane carries CPU "
                    f"tensors only, got a tensor on {t.device}")
        kind = entry.kind
        ps = self._native_ps(entry.process_set)
        n = len(entry.process_set.ranks)
        pre = 1.0 if entry.prescale is None else float(entry.prescale)
        post = 1.0 if entry.postscale is None else float(entry.postscale)
        core = self.core
        tensors = entry.tensors

        if kind == "allreduce":
            if entry.codec is not None:
                from ..compression import codecs
                codec = codecs.CODECS[entry.codec[0]]
                if codec.wire:
                    return self._enqueue_quantized_allreduce(
                        entry, ps, n, pre, post, codec, entry.codec[1])
                # Cast codec (fp16/bf16): the ring reduces the narrow
                # dtype; the sweep casts back.
                return self._enqueue_cast_allreduce(entry, codec)
            red, post_extra = self._red_op(entry, n)
            if len(tensors) == 1:
                h = core.enqueue(ps, entry.name, native.REQ_ALLREDUCE,
                                 tensors[0], red_op=red, prescale=pre,
                                 postscale=post * post_extra)
                return _Pending(entry, [h], _unpack_in_place(tensors))
            # A grouped allreduce is one negotiated tensor: the group
            # fuses as a unit (reference: group_table.cc).
            if any(t.dtype != tensors[0].dtype for t in tensors):
                raise HorovodInternalError(
                    "grouped allreduce requires one dtype per group")
            if red == native.RED_ADASUM:
                # Adasum's coefficients are per tensor: one request each,
                # never a concatenated buffer.
                handles = [core.enqueue(ps, nm, native.REQ_ALLREDUCE, t,
                                        red_op=red, prescale=pre,
                                        postscale=post * post_extra)
                           for nm, t in zip(_sub_names(entry), tensors)]
                return _Pending(entry, handles, _unpack_in_place(tensors))
            flat = torch.cat([t.reshape(-1) for t in tensors])
            h = core.enqueue(ps, entry.name, native.REQ_ALLREDUCE, flat,
                             red_op=red, prescale=pre,
                             postscale=post * post_extra)
            return _Pending(entry, [h], _unpack_group(tensors))

        if kind in ("allgather", "broadcast", "reducescatter"):
            kw = {}
            if kind == "broadcast":
                req, unpack = native.REQ_BROADCAST, _unpack_in_place(tensors)
                kw["root_rank"] = entry.root_rank
            elif kind == "allgather":
                req, unpack = native.REQ_ALLGATHER, _unpack_new(tensors)
            else:
                red, post_extra = self._red_op(entry, n)
                req, unpack = native.REQ_REDUCESCATTER, _unpack_new(tensors)
                kw.update(red_op=red, postscale=post * post_extra)
            handles = [core.enqueue(ps, nm, req, t, **kw)
                       for nm, t in zip(_sub_names(entry), tensors)]
            return _Pending(entry, handles, unpack)

        if kind == "alltoall":
            t = tensors[0]
            h = core.enqueue(ps, entry.name, native.REQ_ALLTOALL, t,
                             splits=_splits(t.shape[0], entry.splits, n))
            return _Pending(entry, [h], _unpack_alltoall(t.dtype))

        if kind == "barrier":
            h = core.enqueue(ps, entry.name, native.REQ_BARRIER)
            return _Pending(entry, [h], lambda core, hs: None)

        if kind == "join":
            h = core.enqueue(ps, "__join__", native.REQ_JOIN)
            return _Pending(entry, [h], _unpack_join)

        raise HorovodInternalError(f"unknown op kind {kind}")

    def _enqueue_cast_allreduce(self, entry, codec):
        """Cast codec (fp16/bf16) on the host plane: the ring carries and
        reduces the narrow dtype, and the sweep casts the results back to
        the submitted dtypes."""
        orig = entry.tensors
        if self.compression_plane is not None:
            self.compression_plane.record(codec.name, [entry], orig, None)
        entry.tensors = [t.to(codec.cast_dtype) for t in orig]
        entry.codec = None   # the plain allreduce path from here
        pending = self._enqueue_entry(entry)
        inner = pending.unpack

        def unpack(core, handles):
            outs = inner(core, handles)
            for t, o in zip(orig, outs):
                t.copy_(o)
            return orig
        pending.unpack = unpack
        return pending

    def _enqueue_quantized_allreduce(self, entry, ps, n, pre, post, codec,
                                     block):
        """Wire-codec allreduce on the host plane: encode locally,
        allgather the (payload, scales) pair as two negotiated tensors,
        dequantize and sum in float32 at the sweep. Moves about (n-1)·B
        bytes per rank with B about a quarter of the input: a win over the
        float32 ring's 2·B·4 at the cohort sizes this plane serves.
        Error-feedback residuals go through the compression plane, stored
        when the payload is encoded: what this rank put on the wire is
        what its debt reflects."""
        from ..compression import codecs
        if entry.op not in (None, reduce_ops.Sum, reduce_ops.Average):
            raise HorovodInternalError(
                "quantized allreduce supports Sum/Average, got "
                f"{reduce_ops.op_name(entry.op)}")
        average = entry.op in (None, reduce_ops.Average)
        post_total = post * (1.0 / n if average else 1.0)
        tensors = entry.tensors
        flats = [t.reshape(-1).to(torch.float32) for t in tensors]
        flat = flats[0] if len(flats) == 1 else torch.cat(flats)
        if pre != 1.0:
            flat = flat * pre
        plane = self.compression_plane
        resid = plane.residuals_in([entry]) if plane is not None else None
        if resid:
            flat = flat + torch.cat([r.reshape(-1) for r in resid])
        total = flat.numel()
        padded = codecs.padded_len(total, 1, block)
        if padded != total:
            flat = torch.nn.functional.pad(flat, (0, padded - total))
        q, s = codec.encode(flat, block)
        if plane is not None and plane.error_feedback:
            err = (flat - codec.decode(q, s, block))[:total]
            errs, off = [], 0
            for t in tensors:
                errs.append(err[off:off + t.numel()].reshape(t.shape))
                off += t.numel()
            plane.store_residuals([entry], errs)
            plane.record(codec.name, [entry], tensors, errs)
        elif plane is not None:
            plane.record(codec.name, [entry], tensors, None)
        hq = self.core.enqueue(ps, f"{entry.name}.q", native.REQ_ALLGATHER,
                               q.contiguous())
        hs = self.core.enqueue(ps, f"{entry.name}.s", native.REQ_ALLGATHER,
                               s.contiguous())
        return _Pending(entry, [hq, hs],
                        _unpack_quantized(codec, block, n, padded, tensors,
                                          post_total))

    # -- the cycle --------------------------------------------------------
    def run_cycle(self):
        """One native negotiation cycle and completion sweep. Returns the
        number of entries completed."""
        rc = self.core.run_cycle()
        if rc == -2:
            self._transport_dead = True
            self._fail_all(self._abort_exc or HorovodInternalError(
                "native core transport failure (peer died?)"))
            return 0
        # A handle turns terminal only in a cycle that completed one natively
        # (rc) or executed a delegated response: other cycles skip the
        # sweep, and a delegated completion sweeps only its own entries.
        # Each poll is a ctypes call under the GIL, which the submitting
        # threads (autograd's hooks) wait for.
        touched = self._drain_delegated()
        if rc != 0:
            return self._sweep_completions()
        if touched:
            return self._sweep_completions(touched)
        return 0

    def _drain_delegated(self):
        """Executes delegated responses (nccl_global.py); returns the ids
        of the entries they completed."""
        return set()

    def _done_event(self):
        """What a completed handle's waiter orders its stream after: a
        (CUDA event, device) pair on the delegated plane."""
        return None

    def _sweep_completions(self, touched=None):
        """Complete the pending entries whose native handles are all
        terminal (of those whose ids are in ``touched``, when given). Each
        entry is processed in isolation: a failing one fails only its own
        handle."""
        done = 0
        still = []
        # One event for every entry this sweep completes: the work they
        # wait for was all issued before it.
        self._sweep_event = None
        for p in self._pending:
            if touched is not None and id(p.entry) not in touched:
                still.append(p)
                continue
            try:
                finished = self._sweep_one(p)
            except Exception as exc:  # noqa: BLE001 - isolate the entry
                self._log.error("completion sweep failed for %r: %s",
                                p.entry.name, exc)
                self._discard_pending(p, HorovodInternalError(
                    f"completion processing failed for {p.entry.name!r}: "
                    f"{exc}"))
                done += 1
                continue
            if finished:
                done += 1
            else:
                still.append(p)
        self._pending = still
        return done

    def _release(self, p):
        for h in p.handles:
            self.core.release(h)

    def _sweep_one(self, p):
        states = [self.core.poll(h) for h in p.handles]
        if any(s == 0 for s in states):
            # Never release in-flight handles: the negotiation of the
            # others must stay consistent.
            return False
        if any(s == 2 for s in states):
            errs = [self.core.error(h) for h, s in zip(p.handles, states)
                    if s == 2]
            self._release(p)
            if self.entry_done_cb:
                self.entry_done_cb(p.entry, ok=False)
            msg = "; ".join(errs)
            # "STALLED:" is the native layer's stable marker.
            exc = (StalledTensorError(msg)
                   if errs and all(e.startswith("STALLED:") for e in errs)
                   else HorovodInternalError(msg))
            p.entry.handle._fail(exc)
            return True
        try:
            result = p.unpack(self.core, p.handles)
            if self._metrics_on and p.t0:
                kind = p.entry.kind
                self._m_time.labels(backend=self.name, kind=kind).observe(
                    time.perf_counter() - p.t0)
                self._m_bytes.labels(backend=self.name, kind=kind).inc(
                    p.nbytes)
            if self.entry_done_cb:
                self.entry_done_cb(p.entry)
            if self._sweep_event is None:
                self._sweep_event = self._done_event()
            p.entry.handle._complete(result, self._sweep_event)
        except Exception as exc:  # noqa: BLE001
            p.entry.handle._fail(HorovodInternalError(str(exc)))
        finally:
            self._release(p)
        return True

    def _discard_pending(self, p, exc):
        for h in p.handles:
            try:
                self.core.release(h)
            except Exception:  # noqa: BLE001 - already failing
                pass
        if self.entry_done_cb:
            self.entry_done_cb(p.entry, ok=False)
        p.entry.handle._fail(exc)

    def _fail_all(self, exc):
        for p in self._pending:
            if self.entry_done_cb:
                self.entry_done_cb(p.entry, ok=False)
            p.entry.handle._fail(exc)
        self._pending = []
        for e in self._chaos_swallowed:
            if self.entry_done_cb:
                self.entry_done_cb(e, ok=False)
            e.handle._fail(exc)
        self._chaos_swallowed = []

    def pending_count(self):
        return len(self._pending)

    def bytes_processed(self):
        """Payload bytes this rank's collectives moved: the native core's
        count, updated on the cycle thread in the negotiation round that
        ran them (the autotuner's active-cycle clock)."""
        return self.core.bytes_processed()

    def broadcast(self, tensors, root_rank, ps):
        """Broadcast driven to completion on the calling thread: the
        autotuner's rank-0 decisions go out this way from the cycle thread,
        which cannot wait for a cycle it runs itself (the JAX package's
        synchronous backend verbs, backend/tcp_backend.py). Every rank
        calls it at the same negotiation round, so the generated names
        agree; the rounds it runs are negotiation rounds like any other."""
        from ..coordinator import TensorEntry
        self._sync_seq += 1
        entry = TensorEntry(f"hvd.sync.broadcast.{self._sync_seq}",
                            "broadcast", list(tensors), ps,
                            root_rank=root_rank)
        self.submit_entry(entry)
        while not entry.handle.poll():
            self.run_cycle()
        out = entry.handle.wait()
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def abort_inflight(self, exc):
        """Fail every pending negotiation with ``exc``, releasing the
        native handles so that a later consensus shutdown does not wait on
        entries whose waiters were failed."""
        for p in self._pending:
            for h in p.handles:
                try:
                    self.core.release(h)
                except Exception:  # noqa: BLE001 - aborting anyway
                    pass
        self._fail_all(exc)

    def watchdog_abort(self, exc):
        """The watchdog's coordinated abort: fail every pending negotiation
        with ``exc``; close() then skips the consensus shutdown, which the
        stuck peer would never join."""
        self.abort_inflight(exc)
        self._abandoned = True

    def unblock(self, exc):
        """Called from the watchdog's thread while the cycle thread is stuck
        in a native cycle: a frozen peer keeps its sockets open, so the core
        waits on it for ever. Shut the core's peer connections down, so that
        the cycle returns with a transport failure, which fails what the
        core held with ``exc``."""
        self._abort_exc = exc
        self._abandoned = True
        native.shutdown_peer_connections(self._peers, self.topology.rank)

    def close(self):
        try:
            if self._transport_dead or self._abandoned:
                # A dead (or stuck) peer can never agree to the consensus
                # shutdown.
                self._fail_all(HorovodInternalError(
                    "runtime shut down after transport failure"))
                return
            self.core.request_shutdown()
            # Drain through the full cycle, so that waiters on in-flight
            # entries resolve; peers must agree before the consensus
            # shutdown lands. Bounded in time, not in cycles: a peer with
            # nothing in flight cycles only every IDLE_CYCLE_S.
            deadline = time.monotonic() + SHUTDOWN_DRAIN_S
            while time.monotonic() < deadline:
                if self.core.shutdown_complete():
                    break
                self.run_cycle()
                if self._transport_dead:
                    break
            self._fail_all(HorovodInternalError(
                "runtime shut down with operations in flight"))
        finally:
            self.core.close()


def _splits(rows, splits, n):
    """Alltoall's rows per destination: ``splits`` (a CPU tensor), or equal
    parts."""
    if splits is None:
        if rows % n:
            raise HorovodInternalError(
                f"alltoall: dim 0 ({rows}) does not divide by the process "
                f"set size ({n}); pass splits")
        return [rows // n] * n
    return [int(s) for s in splits.tolist()]


# -- unpack helpers (native outputs -> framework results) ------------------

def _unpack_in_place(tensors):
    """Allreduce, broadcast: each output lands in its input tensor."""
    def unpack(core, handles):
        for t, h in zip(tensors, handles):
            t.copy_(core.output(h, t.dtype).reshape(t.shape))
        return tensors
    return unpack


def _unpack_group(tensors):
    def unpack(core, handles):
        flat = core.output(handles[0], tensors[0].dtype)
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].reshape(t.shape))
            off += n
        return tensors
    return unpack


def _unpack_new(tensors):
    """Allgather, reducescatter: new tensors in the core's output shape."""
    def unpack(core, handles):
        return [core.output(h, t.dtype) for t, h in zip(tensors, handles)]
    return unpack


def _unpack_quantized(codec, block, n, padded, tensors, post):
    """Completion of the host plane's quantized allreduce: the gathered
    tensors are every rank's payload and scales; dequantize each rank's,
    sum in float32, apply the post and averaging scale, and write each
    tensor back in its dtype."""
    def unpack(core, handles):
        qg = core.output(handles[0], codec.payload_dtype).reshape(n, padded)
        sg = core.output(handles[1], torch.float32).reshape(n, -1)
        red = codec.decode(qg, sg, block).sum(dim=0)
        if post != 1.0:
            red = red * post
        off = 0
        for t in tensors:
            t.copy_(red[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return tensors
    return unpack


def _unpack_alltoall(dtype):
    def unpack(core, handles):
        return core.output(handles[0], dtype), core.recv_splits(handles[0])
    return unpack


def _unpack_join(core, handles):
    out = core.output(handles[0], torch.int32).reshape(-1)
    return int(out[0]) if out.numel() else -1

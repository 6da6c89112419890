"""Native control plane, ``torch.distributed`` data plane (the port's
counterpart of ``horovod_tpu/backend/xla_global.py``; reference:
horovod/common/ops/nccl_operations.cc:80-119, the NCCL data plane executing
what the controller negotiated).

- The native core (``csrc/core/``) keeps the control plane: named-tensor
  negotiation, fusion, the response cache, stall checks and its timeline,
  exactly as on the tcp-native plane. Its data ops are delegated: a request
  enters the core with its shape and dtype only (the tensor may live on the
  GPU), and every agreed allreduce, allgather, broadcast and reducescatter
  response comes back to this backend to execute.
- For each response the local tensors come from this backend's handle
  table, never from the core. Fused tensors are copied into a persistent
  fusion buffer per dtype, one ``torch.distributed`` call runs on the
  response's process-set group (NCCL for CUDA tensors, gloo for CPU ones),
  and the results are copied back. The handle is then completed in the core
  with no data.
- Alltoall, barrier and join run on the native TCP plane, as the core
  decides. An alltoall of CUDA tensors is staged through pinned host
  memory: the copy to the host is issued on the backend's stream and the
  request enters the negotiation once it has landed; the result goes back
  to the card the same way. Adasum (VHDD in the core) is staged likewise,
  one request per tensor, through pinned buffers reused across steps.
- A wire codec (``int8``/``fp8``) runs the quantized pipeline
  (``_quantized_allreduce``). The compression plane stamps each entry
  with the codec its call asked for (``compression=Compression.int8``,
  ``DistributedOptimizer(compression=...)``); a fused response whose
  entries share one stamp is quantized as one buffer, and a response that
  mixes stamps is executed as one collective per stamp, in entry order
  (every rank holds the same stamps, so every rank splits alike). Error-
  feedback residuals are kept per native name and elastic version in the
  plane's store. Entries with no stamp fall under ``HVDTPU_COMPRESSION``'s
  catch-all wire rule: a float sum of at least the threshold is quantized,
  without error feedback. A stamp needs every rank's entry: a response
  with a joined rank's slot and a stamped entry raises.
- On CUDA every response records a timing event after its collective
  on the backend's stream. Its entries' handles complete at once (a
  waiter's stream waits on the card), but their trace ``fin`` is the time
  that event ran on the card (``TensorEntry.device_done``, read against
  the stream's ``tracing.DeviceClock`` once the coordinator's sweep finds
  it completed), so a sub→fin span holds NCCL's time.
- With the watchdog armed (``HVDTPU_COLLECTIVE_TIMEOUT``), a response
  handed to NCCL stays in view (``device_inflight``) until the card
  finished it, and a watchdog abort aborts this rank's communicators, so
  that a collective stuck on a frozen peer returns; the backend then
  refuses further work with the abort's error.

Every call runs on the coordinator's cycle thread, the only thread that
issues collectives after ``init``; on CUDA it runs on the backend's own
stream, after the submitting streams' events.
"""

import contextlib
import functools
import os
import time

import torch

from .. import native
from ..coordinator import wait_ready
from ..exceptions import HorovodInternalError
from ..utils import envparse
from ..utils.logging_util import get_logger
from . import scale_
from .tcp_backend import TcpBackend, _Pending, _splits, _sub_names

_DELEGATED = {"allreduce": native.REQ_ALLREDUCE,
              "allgather": native.REQ_ALLGATHER,
              "broadcast": native.REQ_BROADCAST,
              "reducescatter": native.REQ_REDUCESCATTER}
_KIND_OF = {v: k for k, v in _DELEGATED.items()}


def _identity(op, dtype):
    """The reduce op's identity, contributed for a name this rank has no
    entry for (a joined rank), as the native FillReduceIdentity does."""
    if op == native.RED_PROD:
        return 1
    if op not in (native.RED_MIN, native.RED_MAX):
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == native.RED_MIN else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == native.RED_MIN else info.min


def reducescatter_counts(rows, n):
    """Rows of dim 0 that each of ``n`` ranks receives: earlier ranks take
    the remainder (csrc/core/core.cc kReducescatter)."""
    q, r = divmod(rows, n)
    return [q + (1 if i < r else 0) for i in range(n)]


class _Staged:
    """An alltoall (or the tensors of an Adasum allreduce) of CUDA tensors
    on their way to the host."""

    __slots__ = ("host", "splits", "event")

    def __init__(self, host, splits, event):
        self.host = host
        self.splits = splits
        self.event = event


#: KV scope of the process group's store address (one key per elastic
#: version), brokered through the launcher's rendezvous store.
STORE_SCOPE = "torchdist"


def _process_group_store(topology):
    """The store the process group forms on, or None for ``env://``
    (``MASTER_ADDR`` and ``MASTER_PORT`` set, which win). Otherwise the
    address is brokered through the launcher's KV store once per elastic
    version: rank 0 binds a fresh ``TCPStore`` on an ephemeral port and
    publishes ``ip:port``, the others read it (the counterpart of the JAX
    package's ``init_jax_distributed``, backend/xla_global.py:74-100). A
    version that re-forms the group after a reset gets a fresh store."""
    import torch.distributed as dist

    from ..runner import http_client
    from ..runner import rendezvous as rdv
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return None
    cfg = rdv.rendezvous_config()
    if cfg is None:
        raise HorovodInternalError(
            "the delegated plane needs MASTER_ADDR/MASTER_PORT or the "
            "launcher's rendezvous to broker the process group's store")
    addr, port, token = cfg
    ver = envparse.get_env(envparse.ELASTIC_VERSION)
    key = f"store.{ver}" if ver is not None else "store"
    timeout_s = envparse.get_float(envparse.START_TIMEOUT, 120.0)
    if topology.rank == 0:
        ip = rdv._local_ip_towards(addr, port)
        store = dist.TCPStore(ip, 0, topology.size, is_master=True,
                              wait_for_workers=False)
        http_client.put_kv(addr, port, STORE_SCOPE, key,
                           f"{ip}:{store.port}", token=token)
        return store
    where = http_client.wait_for_kv(addr, port, STORE_SCOPE, key,
                                    token=token,
                                    deadline_s=timeout_s).decode()
    host, _, store_port = where.rpartition(":")
    return dist.TCPStore(host, int(store_port), topology.size,
                         is_master=False)


class NcclGlobalBackend(TcpBackend):
    """Delegated execution: native negotiation, ``torch.distributed``
    data plane. The process group forms on ``env://`` when
    ``MASTER_ADDR`` and ``MASTER_PORT`` are set, else on a store brokered
    through the launcher's KV store (``_process_group_store``)."""

    delegate_data_ops = True

    def __init__(self, topology, device):
        import torch.distributed as dist
        self._dist = dist
        self.device = device
        self.dist_backend = "nccl" if device.type == "cuda" else "gloo"
        self.name = f"{self.dist_backend}-global"
        if device.type == "cuda" and not dist.is_nccl_available():
            raise HorovodInternalError(
                "CUDA tensors need NCCL, which this build of torch lacks")
        if (envparse.get_bool(envparse.ELASTIC)
                or envparse.get_float(envparse.COLLECTIVE_TIMEOUT, 0.0) > 0):
            # An elastic worker, or one under the port's watchdog, aborts
            # and re-forms its communicators itself (``_abort_communicators``,
            # ``close``): torch's own NCCL watchdog (its timeout is 10
            # minutes by default, after the port's) must not tear the
            # process down on the error an aborted collective leaves
            # behind (the abort API's documented setting).
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        store = _process_group_store(topology)
        kw = ({"init_method": "env://"} if store is None
              else {"store": store})
        if device.type == "cuda":
            # Eager communicator: the group forms here, inside init() and
            # an elastic reset's retries, not at the first collective.
            kw["device_id"] = device
        dist.init_process_group(self.dist_backend, rank=topology.rank,
                                world_size=topology.size, **kw)
        # Set by the cycle thread once the native core reports a dead
        # peer or the watchdog aborts: the NCCL communicators were aborted,
        # so close() must not wait for them.
        self._aborted = False
        # Watchdog on (set by the coordinator): executed NCCL responses
        # stay in view until their event completes: (names, t, event).
        self.track_device = False
        self._device_work = []
        super().__init__(topology)
        self._red = {native.RED_SUM: dist.ReduceOp.SUM,
                     native.RED_MIN: dist.ReduceOp.MIN,
                     native.RED_MAX: dist.ReduceOp.MAX,
                     native.RED_PROD: dist.ReduceOp.PRODUCT}
        # native process-set id -> (group, ranks); None is the world.
        self._groups = {0: (None, list(range(topology.size)))}
        # native handle -> (entry, tensor, native name): the local side of
        # every delegated request in flight.
        self._handles = {}
        self._results = {}    # native handle -> allgather/reducescatter out
        self._fusion = {}     # dtype -> persistent fusion buffer
        self._staged = []     # alltoalls on their way to the host
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        # Wall time of the stream's events (the trace fins), anchored
        # here while the stream is idle.
        self.device_clock = None
        if self._stream is not None:
            from ..tracing.recorder import DeviceClock
            self.device_clock = DeviceClock(self._stream)
        self.runtime = None   # set by the coordinator (timeline)
        # Counters: responses executed, their payload bytes, and the bytes
        # copied into and out of fusion buffers.
        self.responses = 0
        self.response_bytes = 0
        self.fusion_copy_bytes = 0
        # The env policy's catch-all wire rule, for responses whose
        # entries carry no codec stamp (no error feedback: a fused
        # response's layout moves with what the core fused). Every rank
        # parses the same env.
        from ..compression import codecs
        from ..compression.policy import simple_wire_policy
        codec_name, self._q_block, self._q_threshold = simple_wire_policy()
        self._q_codec = (codecs.CODECS[codec_name] if codec_name is not None
                         else None)
        if self._q_codec is not None:
            get_logger().info(
                "%s: quantized allreduce on for unstamped responses (codec="
                "%s block=%d threshold=%d)", self.name, codec_name,
                self._q_block, self._q_threshold)
        # Quantized responses, their input bytes and what the codec puts
        # on the wire for them (payload and scales).
        self.quantized_responses = 0
        self.quantized_bytes = 0
        self.quantized_wire_bytes = 0
        # Pinned host buffers of the Adasum staging, reused across steps:
        # (numel, dtype) -> free buffers.
        self._pinned = {}

    # -- process sets -----------------------------------------------------
    def add_process_set(self, ps):
        super().add_process_set(ps)
        if ps.process_set_id != 0:
            # new_group is collective over the world: every rank calls it,
            # on the thread that registers the set.
            self._groups[self._ps_map[ps.process_set_id]] = (
                self._dist.new_group(ps.ranks), list(ps.ranks))

    def remove_process_set(self, ps):
        native_id = self._ps_map.get(ps.process_set_id)
        super().remove_process_set(ps)
        # The group is destroyed with the world at close: the cycle thread
        # may still hold work on it.
        self._groups.pop(native_id, None)

    # -- submission -------------------------------------------------------
    def _timeline(self):
        return None if self.runtime is None else self.runtime.timeline

    def _enqueue_entry(self, entry):
        from ..ops import reduce_ops
        if self._aborted and self.dist_backend == "nccl":
            raise self._abort_exc or HorovodInternalError(
                "this rank's NCCL communicators were aborted; shut the "
                "runtime down before the next collective")
        if entry.kind == "allreduce" and entry.op == reduce_ops.Adasum:
            # VHDD stays on the host plane (the core refuses a delegated
            # Adasum): CUDA tensors are staged through pinned memory.
            if entry.device.type == "cuda":
                return self._stage_adasum(entry)
            return super()._enqueue_entry(entry)
        req = _DELEGATED.get(entry.kind)
        if req is None:
            if entry.kind == "alltoall" and entry.device.type == "cuda":
                return self._stage_alltoall(entry)
            return super()._enqueue_entry(entry)   # barrier, join, CPU a2a
        for t in entry.tensors:
            if t.device != self.device:
                raise HorovodInternalError(
                    f"{entry.name!r}: tensor on {t.device}, but this rank "
                    f"runs on {self.device}")
        ps = self._native_ps(entry.process_set)
        n = len(entry.process_set.ranks)
        kw = {}
        if entry.kind in ("allreduce", "reducescatter"):
            red, post_extra = self._red_op(entry, n)
            post = 1.0 if entry.postscale is None else float(entry.postscale)
            kw.update(red_op=red, postscale=post * post_extra)
            if entry.kind == "allreduce":
                kw["prescale"] = (1.0 if entry.prescale is None
                                  else float(entry.prescale))
        elif entry.kind == "broadcast":
            kw["root_rank"] = entry.root_rank
        handles = []
        names = _sub_names(entry)
        for nm, t in zip(names, entry.tensors):
            h = self.core.enqueue(ps, nm, req, t, with_data=False, **kw)
            self._handles[h] = (entry, t, nm)
            handles.append(h)
        tl = self._timeline()
        if tl is not None:
            tl.begin(names, "NEGOTIATE_" + entry.kind.upper())
        if entry.kind in ("allreduce", "broadcast"):
            return _Pending(entry, handles, lambda core, hs: entry.tensors)
        return _Pending(entry, handles, lambda core, hs: [
            self._results.pop(h) for h in hs])

    def _stage_alltoall(self, entry):
        t = entry.tensors[0]
        splits = entry.splits
        with torch.cuda.stream(self._stream):
            wait_ready(self._stream, [entry])
            t.record_stream(self._stream)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            if splits is not None and splits.device.type == "cuda":
                splits.record_stream(self._stream)
                pinned = torch.empty(splits.shape, dtype=splits.dtype,
                                     pin_memory=True)
                splits = pinned.copy_(splits, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        p = _Pending(entry, [], _Staged(host, splits, event))
        self._staged.append(p)
        return p

    def _stage_adasum(self, entry):
        """Copy an Adasum entry's CUDA tensors into pinned host buffers on
        the backend's stream; ``_enqueue_staged`` enters them into the
        negotiation, one request per tensor, once they have landed."""
        with torch.cuda.stream(self._stream):
            wait_ready(self._stream, [entry])
            hosts = []
            for t in entry.tensors:
                t.record_stream(self._stream)
                host = self._take_pinned(t)
                host.copy_(t, non_blocking=True)
                hosts.append(host)
            event = torch.cuda.Event()
            event.record(self._stream)
        p = _Pending(entry, [], _Staged(hosts, None, event))
        self._staged.append(p)
        return p

    def _take_pinned(self, t):
        free = self._pinned.get((t.numel(), t.dtype))
        if free:
            return free.pop().view(t.shape)
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def _unpack_adasum_to_device(self, entry, hosts, core, handles):
        """Each result into its pinned buffer, then back to its tensor on
        the backend's stream. A buffer returns to the pool once its copy is
        issued: the next copy into it is issued on the same stream, so it
        runs after this one."""
        for h, host in zip(handles, hosts):
            core.output(h, host.dtype, out=host)
        with torch.cuda.stream(self._stream):
            for t, host in zip(entry.tensors, hosts):
                t.copy_(host, non_blocking=True)
                self._pinned.setdefault((host.numel(), host.dtype),
                                        []).append(host.reshape(-1))
        return entry.tensors

    def _enqueue_staged(self, p):
        """Enter a staged alltoall or Adasum into the negotiation once its
        bytes are on the host (an event query: the thread never waits);
        returns whether it did."""
        staged = p.unpack
        if not staged.event.query():
            return False
        entry = p.entry
        if isinstance(staged.host, list):   # Adasum, one request a tensor
            ps = self._native_ps(entry.process_set)
            pre = 1.0 if entry.prescale is None else float(entry.prescale)
            post = 1.0 if entry.postscale is None \
                else float(entry.postscale)
            p.handles = [self.core.enqueue(
                ps, nm, native.REQ_ALLREDUCE, host,
                red_op=native.RED_ADASUM, prescale=pre, postscale=post)
                for nm, host in zip(_sub_names(entry), staged.host)]
            p.unpack = functools.partial(self._unpack_adasum_to_device,
                                         entry, staged.host)
            return True
        h = self.core.enqueue(
            self._native_ps(entry.process_set), entry.name,
            native.REQ_ALLTOALL, staged.host,
            splits=_splits(staged.host.shape[0], staged.splits,
                           len(entry.process_set.ranks)))
        p.handles = [h]
        p.unpack = functools.partial(self._unpack_alltoall_to_device,
                                     entry.tensors[0].dtype)
        return True

    def _unpack_alltoall_to_device(self, dtype, core, handles):
        out = core.output(handles[0], dtype)
        with torch.cuda.stream(self._stream):
            dev = out.pin_memory().to(self.device, non_blocking=True)
        return dev, core.recv_splits(handles[0])

    # -- the cycle --------------------------------------------------------
    def run_cycle(self):
        if self._staged:
            self._staged = [p for p in self._staged
                            if not self._enqueue_staged(p)]
        done = super().run_cycle()
        if self._transport_dead and not self._aborted \
                and self.dist_backend == "nccl":
            self._abort_communicators()
        return done

    def _abort_communicators(self, why="native core lost a peer",
                             strict=False):
        """Abort every communicator of this rank's groups, so that a
        collective already in flight towards a dead or frozen peer returns
        instead of hanging the device and every host call that waits for
        it. Called when the native core reports a dead peer (best effort:
        the core already failed every handle) and on a watchdog abort
        (``strict``: a communicator that fails to abort raises, since the
        card may still be stuck)."""
        self._aborted = True
        self._device_work = []
        if not self._dist.is_initialized():
            return
        get_logger().warning("%s: aborting this rank's NCCL communicators",
                             why)
        groups = [g for g, _ in self._groups.values() if g is not None]
        failed = []
        for g in groups + [self._dist.group.WORLD]:
            try:
                g.abort()
            except Exception as exc:  # noqa: BLE001 - collected below
                get_logger().warning("aborting an NCCL communicator "
                                     "failed: %s", exc)
                failed.append(exc)
        if strict and failed:
            raise HorovodInternalError(
                f"{len(failed)} NCCL communicator(s) failed to abort: "
                f"{failed[0]}")

    def watchdog_abort(self, exc):
        """The watchdog's coordinated abort: fail every pending entry and,
        on NCCL, abort the communicators too, releasing the responses NCCL
        was already handed. A frozen peer keeps its sockets open, so the
        native core never reports it: this is the only way out."""
        super().watchdog_abort(exc)
        self._abort_exc = exc
        if self.dist_backend == "nccl" and not self._aborted:
            self._abort_communicators("watchdog abort", strict=True)

    def unblock(self, exc):
        """The watchdog's thread, the cycle thread stuck in a native cycle
        on a frozen peer: abort the communicators first (NCCL work already
        issued towards the peer returns, and so does any host call waiting
        for it), then shut the core's peer connections down."""
        self._abort_exc = exc
        if self.dist_backend == "nccl" and not self._aborted:
            self._abort_communicators("watchdog abort", strict=True)
        super().unblock(exc)

    def device_aborted(self):
        """True once this rank's communicators were aborted or the
        watchdog released its work: pending trace ``fin``s are then
        recorded failed without waiting for the card."""
        return self._aborted or self._abort_exc is not None

    def device_inflight(self, now):
        """``(native name, age)`` of every response handed to NCCL whose
        event has not completed (with ``track_device``); responses complete
        in order on the backend's stream."""
        work = self._device_work
        while work and work[0][2].query():
            work.pop(0)
        return [(nm, now - t) for names, t, _ in work for nm in names]

    def bytes_processed(self):
        """The core's count plus the bytes of the responses handed to
        ``torch.distributed``: a delegated response completes in the core
        without its result (the core counts 0 bytes for it), and the cycle
        thread adds the response's bytes in the round that negotiated it,
        so the count moves alike on every rank."""
        return self.core.bytes_processed() + self.response_bytes

    def _sweep_one(self, p):
        if isinstance(p.unpack, _Staged):
            return False
        return super()._sweep_one(p)

    def _done_event(self):
        if self._stream is None:
            return None
        done = torch.cuda.Event()
        done.record(self._stream)
        return done, self.device

    def _release(self, p):
        for h in p.handles:
            self.core.release(h)
            self._handles.pop(h, None)
            self._results.pop(h, None)

    def _fail_all(self, exc):
        super()._fail_all(exc)
        self._staged = []
        self._handles.clear()
        self._results.clear()

    def _drain_delegated(self):
        touched = set()
        while True:
            token = self.core.next_delegated()
            if token == 0:
                return touched
            # Each response is isolated: a failure fails its own handles,
            # never the cycle thread.
            d = None
            try:
                d = self.core.delegated(token)
                self._execute(d)
            except Exception as exc:  # noqa: BLE001 - fail the handles
                msg = (f"{self.dist_backend} data-plane execution failed: "
                       f"{type(exc).__name__}: {exc}")
                get_logger().error("%s", msg)
                for h in (d["handles"] if d else ()):
                    if h >= 0:
                        self._results.pop(h, None)
                        self.core.delegated_complete(h, error=msg)
            finally:
                self.core.delegated_finish(token)
            for h in (d["handles"] if d else ()):
                if h in self._handles:
                    touched.add(id(self._handles[h][0]))

    # -- delegated execution ----------------------------------------------
    def _execute(self, d):
        if d["ps_id"] not in self._groups:
            raise HorovodInternalError(
                f"native process set {d['ps_id']} has no process group")
        group, ranks = self._groups[d["ps_id"]]
        dtype = native.ENUM_TO_DTYPE[d["dtype"]]
        local = [self._handles.get(h) if h >= 0 else None
                 for h in d["handles"]]
        kind = _KIND_OF[d["type"]]
        names = [item[2] for item in local if item is not None]
        tl = self._timeline()
        if tl is not None:
            tl.end(names, "NEGOTIATE_" + kind.upper())
            tl.begin(names, kind.upper())
        with self._on_stream(local):
            run = getattr(self, "_delegated_" + kind)
            nbytes = run(d, group, ranks, dtype, local)
            if self._stream is not None:
                # The response's completion on the card: its entries'
                # trace fin and, under the watchdog, device_inflight.
                event = self.device_clock.event(self._stream)
                for item in local:
                    if item is not None:
                        item[0].device_done = (event, self.device_clock)
                if self.track_device:
                    self._device_work.append((names, time.monotonic(),
                                              event))
        for h in d["handles"]:
            if h >= 0:
                self.core.delegated_complete(h)
        if tl is not None:
            tl.end(names, kind.upper())
        self.responses += 1
        self.response_bytes += nbytes

    def _on_stream(self, local):
        """Run on the backend's stream, after every submitting stream's
        event; the tensors are marked as in use there."""
        if self._stream is None:
            return contextlib.nullcontext()
        items = [item for item in local if item is not None]
        wait_ready(self._stream, [item[0] for item in items])
        for item in items:
            item[1].record_stream(self._stream)
        return torch.cuda.stream(self._stream)

    def _fusion_buffer(self, dtype, numel):
        buf = self._fusion.get(dtype)
        if buf is None or buf.numel() < numel:
            buf = self._fusion[dtype] = torch.empty(
                numel, dtype=dtype, device=self.device)
        return buf[:numel]

    def _delegated_allreduce(self, d, group, ranks, dtype, local):
        sizes = [int(s) for s in d["sizes"]]
        stamps = [None if item is None else item[0].codec for item in local]
        if all(c is None for c in stamps):
            return self._allreduce_part(d, group, ranks, dtype, sizes, local,
                                        None)
        if any(item is None for item in local):
            raise HorovodInternalError(
                "a response with a per-call codec stamp holds a joined "
                "rank's slot: the joined rank cannot know the codec")
        # One collective per stamp, in entry order: every rank holds the
        # same stamps, so every rank splits alike.
        nbytes = 0
        for stamp in dict.fromkeys(stamps):
            idx = [i for i, c in enumerate(stamps) if c == stamp]
            nbytes += self._allreduce_part(
                d, group, ranks, dtype, [sizes[i] for i in idx],
                [local[i] for i in idx], stamp)
        return nbytes

    def _allreduce_part(self, d, group, ranks, dtype, sizes, local, stamp):
        """The allreduce of some entries of a response: fused into the
        fusion buffer (prescaled), reduced plainly, by the stamp's wire
        codec with error feedback, or by the catch-all rule, and copied
        back."""
        pre, op = d["prescale"], d["red_op"]
        esize = torch.empty((), dtype=dtype).element_size()
        fused = len(local) > 1 or local[0] is None or pre != 1.0
        if not fused:
            buf = local[0][1].reshape(-1)
        elif all(item is not None for item in local):
            # One kernel packs the bucket; the prescale covers it whole.
            buf = self._fusion_buffer(dtype, sum(sizes))
            torch.cat([item[1].reshape(-1) for item in local], out=buf)
            scale_([buf], pre)
        else:
            buf = self._fusion_buffer(dtype, sum(sizes))
            for item, seg in zip(local, buf.split(sizes)):
                if item is None:
                    # A joined rank's slot: the op's identity, unscaled
                    # (csrc/core/core.cc does the same).
                    seg.fill_(_identity(op, dtype))
                else:
                    seg.copy_(item[1].reshape(-1))
                    scale_([seg], pre)
        out = None
        if stamp is not None:
            from ..compression import codecs
            residual = self._residuals_in(local, sizes)
            out, new_res = self._quantized_allreduce(
                buf, group, len(ranks), d["postscale"],
                codecs.CODECS[stamp[0]], stamp[1], residual)
            self._store_residuals(local, sizes, new_res)
        elif (self._q_codec is not None and op == native.RED_SUM
              and dtype.is_floating_point
              and buf.numel() >= self._q_threshold):
            out, _ = self._quantized_allreduce(
                buf, group, len(ranks), d["postscale"], self._q_codec,
                self._q_block)
        else:
            self._dist.all_reduce(buf, op=self._red[op], group=group)
            scale_([buf], d["postscale"])
        if out is not None:
            if fused:
                buf = out
            else:
                buf.copy_(out)
        if fused:
            mine = [(item[1].reshape(-1), seg) for item, seg
                    in zip(local, buf.split(sizes)) if item is not None]
            if mine:   # a joined rank executes with no entry of its own
                torch._foreach_copy_([m for m, _ in mine],
                                     [s for _, s in mine])
            self.fusion_copy_bytes += 2 * sum(
                m.numel() for m, _ in mine) * esize
        return sum(sizes) * esize

    def _residuals_in(self, local, sizes):
        """The error-feedback residuals of ``local``'s tensors side by
        side (float32; zeros where none is stored, or its size moved), or
        None with error feedback off. Keyed by native name (a grouped
        entry's tensors may land in different responses)."""
        plane = self.compression_plane
        if plane is None or not plane.error_feedback:
            return None
        parts = []
        for item, size in zip(local, sizes):
            stored = plane.residuals.get(item[2])
            if (stored is None or stored[0].numel() != size
                    or stored[0].device != self.device):
                parts.append(torch.zeros(size, dtype=torch.float32,
                                         device=self.device))
            else:
                parts.append(stored[0].reshape(-1))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _store_residuals(self, local, sizes, residual):
        if residual is None:
            return
        for item, seg in zip(local, residual.split(sizes)):
            self.compression_plane.residuals.put(
                item[2], [seg.reshape(item[1].shape)])

    def _quantized_allreduce(self, buf, group, n, post, codec, block,
                             residual=None):
        """The quantized pipeline of one fused buffer, on the backend's
        stream (the JAX package's ``qallreduce``, xla_global.py:315-343):
        add the error-feedback ``residual`` (float32, one per element),
        pad to a multiple of n·block (blocks fall on the same elements at
        any such length), encode the n chunks, ``all_to_all_single`` the
        payload and the float32 scales, dequantize and sum in float32,
        postscale, re-encode, ``all_gather_into_tensor`` both, and decode
        into the buffer's dtype. Returns the reduced flat tensor and, with
        a residual, the new one: what this rank's encode lost."""
        from ..compression.codecs import padded_len
        total = buf.numel()
        padded = padded_len(total, n, block)
        flat = buf.to(torch.float32)
        if residual is not None:
            flat = flat + residual
        if padded != total:
            flat = torch.nn.functional.pad(flat, (0, padded - total))
        rows = flat.view(n, padded // n)
        q, s = codec.encode(rows, block)
        new_res = None
        if residual is not None:
            new_res = (rows - codec.decode(q, s, block)).reshape(-1)[:total]
        q_in, s_in = torch.empty_like(q), torch.empty_like(s)
        self._dist.all_to_all_single(q_in, q, group=group)
        self._dist.all_to_all_single(s_in, s, group=group)
        red = codec.decode(q_in, s_in, block).sum(dim=0)
        if post != 1.0:
            red = red * post
        q2, s2 = codec.encode(red, block)
        qg = q2.new_empty(n * q2.numel())
        sg = s2.new_empty(n * s2.numel())
        self._dist.all_gather_into_tensor(qg, q2, group=group)
        self._dist.all_gather_into_tensor(sg, s2, group=group)
        out = codec.decode(qg, sg, block, dtype=buf.dtype)[:total]
        self.quantized_responses += 1
        self.quantized_bytes += total * buf.element_size()
        self.quantized_wire_bytes += codec.wire_bytes(total, block,
                                                      buf.element_size())
        return out, new_res

    def _delegated_broadcast(self, d, group, ranks, dtype, local):
        count, root = int(d["sizes"][0]), int(d["sizes"][1])
        item = local[0]
        buf = (item[1].reshape(-1) if item is not None
               else torch.zeros(count, dtype=dtype, device=self.device))
        self._dist.broadcast(buf, src=ranks[root], group=group)
        return count * buf.element_size()

    def _delegated_allgather(self, d, group, ranks, dtype, local):
        n = len(ranks)
        rows = [int(r) for r in d["sizes"][:n]]
        row_elems = int(d["sizes"][n])
        me = ranks.index(self.topology.rank)
        item = local[0]
        if item is not None:
            src, tail = item[1].reshape(-1), tuple(item[1].shape[1:])
        else:
            src = torch.zeros(rows[me] * row_elems, dtype=dtype,
                              device=self.device)
            tail = None
        most = max(rows) * row_elems
        if src.numel() != most:   # ragged: pad every part to the largest
            padded = torch.zeros(most, dtype=dtype, device=self.device)
            padded[:src.numel()] = src
            src = padded
        parts = [torch.empty(most, dtype=dtype, device=self.device)
                 for _ in range(n)]
        self._dist.all_gather(parts, src, group=group)
        if item is not None:
            out = torch.cat([p[:r * row_elems] for p, r in zip(parts, rows)])
            self._results[d["handles"][0]] = out.reshape(
                (sum(rows),) + tail)
        return sum(rows) * row_elems * src.element_size()

    def _delegated_reducescatter(self, d, group, ranks, dtype, local):
        item = local[0]
        if item is None:
            # The controller rejects join + reducescatter; only a handle
            # released mid-negotiation lands here (core.cc errors alike).
            raise HorovodInternalError("reducescatter with no local entry")
        t = item[1]
        n, me = len(ranks), ranks.index(self.topology.rank)
        rows = t.shape[0] if t.dim() else 1
        row_elems = t.numel() // max(rows, 1)
        counts = reducescatter_counts(rows, n)
        chunk = counts[0] * row_elems
        src = t.reshape(-1)
        if d["prescale"] != 1.0:
            src = src.clone()
            scale_([src], d["prescale"])
        if counts[-1] != counts[0]:
            # Uneven: pad every rank's part to the first (largest) one,
            # so that the collective scatters equal chunks.
            padded = torch.zeros(n * chunk, dtype=dtype, device=self.device)
            start = 0
            for i, c in enumerate(counts):
                padded[i * chunk:i * chunk + c * row_elems] = \
                    src[start:start + c * row_elems]
                start += c * row_elems
            src = padded
        out = torch.empty(chunk, dtype=dtype, device=self.device)
        scatter = (getattr(self._dist, "reduce_scatter_single", None)
                   or self._dist.reduce_scatter_tensor)
        scatter(out, src, op=self._red[d["red_op"]], group=group)
        scale_([out], d["postscale"])
        self._results[d["handles"][0]] = out[:counts[me] * row_elems] \
            .reshape((counts[me],) + tuple(t.shape[1:]))
        return t.numel() * t.element_size()

    def close(self):
        """Stop the native core, then tear the process group down so that
        this process can form a new one (an elastic reset: ``shutdown()``
        then ``init()``). Work already issued on the backend's stream is
        ordered before the caller's stream; the host does not wait for
        it. After a dead peer the communicators were aborted: the group is
        dropped with the abort API instead of the destroy, which would
        wait for the dead peer."""
        try:
            super().close()
        finally:
            if self._dist.is_initialized():
                from torch.distributed import distributed_c10d as c10d
                abort = getattr(c10d, "_abort_process_group", None)
                if self._aborted and abort is not None:
                    abort()
                else:
                    if self._stream is not None:
                        torch.cuda.current_stream(self.device).wait_stream(
                            self._stream)
                    self._dist.destroy_process_group()

"""ctypes binding to the port's native core (port of
``horovod_tpu/native/__init__.py``; reference: horovod/common/basics.py:48
loads its C++ runtime the same way).

The core is the port's own copy of the repo's C++ runtime
(``horovod_tpu_torch/csrc/core/``): named-tensor negotiation with the
bitvector response cache, fusion, stall inspection, the chrome-trace
timeline, and the CPU ring collectives over TCP. ``_build.build_core``
compiles it with g++ into ``_build/`` on first use; a failed build raises.

Tensors cross the boundary as torch tensors: a CPU tensor's bytes are
copied into the core at enqueue; a delegated request
(``NativeCore(delegate_data_ops=True)``) passes only its shape and dtype,
and the caller executes the agreed response itself.
"""

import ctypes
import threading

import torch

_lib = None
_lib_lock = threading.Lock()

# Enum values must match csrc/core/common.h.
REQ_ALLREDUCE, REQ_ALLGATHER, REQ_BROADCAST, REQ_ALLTOALL = 0, 1, 2, 3
REQ_REDUCESCATTER, REQ_BARRIER, REQ_JOIN = 4, 5, 6
RED_SUM, RED_MIN, RED_MAX, RED_PROD, RED_ADASUM = 0, 1, 2, 3, 4

#: torch dtype -> wire enum (csrc/core/common.h DataType).
DTYPE_TO_ENUM = {
    torch.uint8: 0, torch.int8: 1, torch.int32: 2, torch.int64: 3,
    torch.float16: 4, torch.float32: 5, torch.float64: 6, torch.bool: 7,
    torch.bfloat16: 8,
}
ENUM_TO_DTYPE = {v: k for k, v in DTYPE_TO_ENUM.items()}


def load_library():
    """Load (building if needed) the native core library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from .. import _build
        path = str(_build.build_core())
        # Two handles on one library: calls through ``lib`` (a PyDLL) keep
        # the GIL, the blocking ones through ``blocking`` (a CDLL) release
        # it. A short call that releases the GIL must win it back from the
        # threads that took it meanwhile (the main thread, autograd's
        # hooks): on the cycle thread that costs more than the call.
        lib = ctypes.PyDLL(path)
        blocking = ctypes.CDLL(path)
        c_void_p, c_int, c_int64 = ctypes.c_void_p, ctypes.c_int, \
            ctypes.c_int64
        c_double, c_char_p = ctypes.c_double, ctypes.c_char_p
        p_i32, p_i64 = ctypes.POINTER(ctypes.c_int32), \
            ctypes.POINTER(ctypes.c_int64)
        p_f64 = ctypes.POINTER(ctypes.c_double)
        sigs = {
            "hvd_core_create": (c_void_p, [c_int, c_int, c_char_p, c_char_p,
                                           c_int64, c_int64, c_double,
                                           c_char_p, c_int, c_double]),
            "hvd_core_destroy": (None, [c_void_p]),
            "hvd_reserve_listen_port": (c_int, []),
            "hvd_core_add_process_set": (c_int, [
                c_void_p, ctypes.POINTER(c_int), c_int]),
            "hvd_core_remove_process_set": (c_int, [c_void_p, c_int]),
            "hvd_core_enqueue": (c_int64, [
                c_void_p, c_int, c_char_p, c_int, c_int, c_int, c_void_p,
                p_i64, c_int, c_int, c_double, c_double, p_i32, c_int]),
            "hvd_core_run_cycle": (c_int, [c_void_p]),
            "hvd_core_request_shutdown": (None, [c_void_p]),
            "hvd_core_shutdown_complete": (c_int, [c_void_p]),
            "hvd_core_poll": (c_int, [c_void_p, c_int64]),
            "hvd_core_handle_error": (c_char_p, [c_void_p, c_int64]),
            "hvd_core_output_ndim": (c_int, [c_void_p, c_int64]),
            "hvd_core_output_shape": (c_int, [c_void_p, c_int64, p_i64]),
            "hvd_core_output_nbytes": (c_int64, [c_void_p, c_int64]),
            "hvd_core_output_copy": (c_int, [c_void_p, c_int64, c_void_p,
                                             c_int64]),
            "hvd_core_recv_splits": (c_int, [c_void_p, c_int64, p_i32,
                                             c_int]),
            "hvd_core_release": (None, [c_void_p, c_int64]),
            "hvd_core_cycles": (ctypes.c_uint64, [c_void_p]),
            "hvd_core_bytes_processed": (ctypes.c_uint64, [c_void_p]),
            "hvd_core_set_topology": (None, [c_void_p, p_i32, c_int,
                                             c_int64]),
            "hvd_core_set_fusion_threshold": (None, [c_void_p, c_int64]),
            "hvd_core_next_delegated": (c_int64, [c_void_p]),
            "hvd_core_delegated_info": (c_int, [
                c_void_p, c_int64, p_i32, p_i32, p_i32, p_i32, p_f64, p_f64,
                p_i32, p_i32]),
            "hvd_core_delegated_meta": (c_int, [c_void_p, c_int64, p_i64,
                                                p_i64]),
            "hvd_core_delegated_complete": (c_int, [
                c_void_p, c_int64, c_void_p, c_int64, p_i64, ctypes.c_int32,
                c_char_p]),
            "hvd_core_delegated_finish": (None, [c_void_p, c_int64]),
        }
        for name, (restype, argtypes) in sigs.items():
            # run_cycle negotiates over the network and destroy and
            # request_shutdown may join threads: those release the GIL.
            src = blocking if name in (
                "hvd_core_run_cycle", "hvd_core_destroy",
                "hvd_core_create", "hvd_reserve_listen_port") else lib
            fn = getattr(src, name)
            fn.restype = restype
            fn.argtypes = argtypes
            setattr(lib, name, fn)
        _lib = lib
        return lib


def reserve_listen_port():
    """Bind and listen on an ephemeral TCP port inside the native core and
    keep it open; the next NativeCore of this process whose peers entry
    names the port adopts the socket. Closes the publish-then-rebind race
    of a rendezvous."""
    port = load_library().hvd_reserve_listen_port()
    if port <= 0:
        raise OSError("could not reserve a listen port")
    return port


def _tcp_ports_by_inode():
    """inode -> (local port, remote port) of this network namespace's
    established TCP sockets (/proc/net/tcp, tcp6)."""
    out = {}
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            if len(cols) < 10 or cols[3] != "01":   # 01: ESTABLISHED
                continue
            out[int(cols[9])] = (int(cols[1].rsplit(":", 1)[1], 16),
                                 int(cols[2].rsplit(":", 1)[1], 16))
    return out


def shutdown_peer_connections(peers, rank):
    """Shut down this process's TCP connections to the native core's peers
    (``peers``: the job's ``host:port`` list; a connection to a lower rank
    was dialled to its port, one from a higher rank was accepted on this
    rank's port), so that a core blocked receiving from a peer that stopped
    without closing its sockets (a frozen process) returns with a transport
    failure. Linux only (/proc). Returns how many it shut down."""
    import os
    import socket
    ports = [int(p.rsplit(":", 1)[1]) for p in peers.split(",")]
    mine = ports[rank]
    others = {p for i, p in enumerate(ports) if i != rank}
    by_inode = _tcp_ports_by_inode()
    done = 0
    for name in os.listdir("/proc/self/fd"):
        try:
            link = os.readlink(f"/proc/self/fd/{name}")
        except OSError:
            continue
        if not link.startswith("socket:["):
            continue
        ports_of = by_inode.get(int(link[8:-1]))
        if ports_of is None:
            continue
        local, remote = ports_of
        if remote in others or local == mine:
            dup = os.dup(int(name))
            with socket.socket(fileno=dup) as sock:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                    done += 1
                except OSError:
                    pass
    return done


class NativeError(RuntimeError):
    pass


_ENQUEUE_ERRORS = {
    -1: "duplicate tensor name in flight",
    -2: "invalid arguments (shape/dtype/byte count mismatch)",
    -3: "runtime shut down",
    -4: "this rank is not a member of the process set",
}


class NativeCore:
    """One native runtime context (one rank of an SPMD job).

    transport 'tcp' with peers "host:port,..." for multi-process jobs;
    'local' with a job-name string for in-process multi-rank tests.
    """

    def __init__(self, rank, size, transport="tcp", peers="",
                 fusion_threshold=0, cache_capacity=0, stall_warning_s=0.0,
                 timeline_path="", delegate_data_ops=False,
                 stall_shutdown_s=0.0):
        self._lib = load_library()
        self._ctx = self._lib.hvd_core_create(
            rank, size, transport.encode(), peers.encode(),
            int(fusion_threshold), int(cache_capacity),
            float(stall_warning_s), timeline_path.encode(),
            1 if delegate_data_ops else 0, float(stall_shutdown_s))
        if not self._ctx:
            raise NativeError(
                f"native core init failed (rank {rank}/{size}, transport "
                f"{transport}); see stderr for details")
        self.rank = rank
        self.size = size
        self.delegate_data_ops = delegate_data_ops

    # -- lifecycle --------------------------------------------------------
    def close(self):
        if self._ctx:
            self._lib.hvd_core_destroy(self._ctx)
            self._ctx = None

    def request_shutdown(self):
        self._lib.hvd_core_request_shutdown(self._ctx)

    def shutdown_complete(self):
        return bool(self._lib.hvd_core_shutdown_complete(self._ctx))

    # -- process sets -----------------------------------------------------
    def add_process_set(self, ranks):
        arr = (ctypes.c_int * len(ranks))(*ranks)
        ps = self._lib.hvd_core_add_process_set(self._ctx, arr, len(ranks))
        if ps < 0:
            raise NativeError("add_process_set failed")
        return ps

    def remove_process_set(self, ps_id):
        return self._lib.hvd_core_remove_process_set(self._ctx, ps_id) == 0

    # -- submission -------------------------------------------------------
    def enqueue(self, ps_id, name, req_type, tensor=None, red_op=RED_SUM,
                root_rank=-1, prescale=1.0, postscale=1.0, splits=None,
                with_data=True):
        """Enqueue one named request; returns its native handle.
        ``tensor`` gives the shape and dtype; its bytes are copied in only
        with ``with_data`` (then it must be a contiguous CPU tensor)."""
        data_ptr, shape_arr, ndim, dt = None, None, 0, 0
        if tensor is not None:
            dt = DTYPE_TO_ENUM.get(tensor.dtype)
            if dt is None:
                raise NativeError(
                    f"dtype {tensor.dtype} unsupported by the native core")
            shape = tuple(tensor.shape)
            shape_arr = (ctypes.c_int64 * max(1, len(shape)))(*shape)
            ndim = len(shape)
            if with_data:
                if tensor.device.type != "cpu" or not tensor.is_contiguous():
                    raise NativeError(
                        f"enqueue {name!r}: the native core copies only "
                        "contiguous CPU tensors")
                data_ptr = ctypes.c_void_p(tensor.data_ptr())
        splits_arr, nsplits = None, 0
        if splits is not None:
            splits = [int(s) for s in splits]
            splits_arr = (ctypes.c_int32 * max(1, len(splits)))(*splits)
            nsplits = len(splits)
        # The core copies the bytes before it returns: nothing to hold.
        h = self._lib.hvd_core_enqueue(
            self._ctx, ps_id, name.encode(), req_type, red_op, dt, data_ptr,
            shape_arr, ndim, root_rank, prescale, postscale, splits_arr,
            nsplits)
        if h < 0:
            raise NativeError(
                f"enqueue {name!r}: "
                f"{_ENQUEUE_ERRORS.get(h, f'error {h}')}")
        return h

    # -- cycle / completion ----------------------------------------------
    def run_cycle(self):
        """One negotiation and execution cycle (blocking; ctypes releases
        the GIL)."""
        return self._lib.hvd_core_run_cycle(self._ctx)

    def poll(self, handle):
        """0 in progress, 1 done, 2 failed."""
        return self._lib.hvd_core_poll(self._ctx, handle)

    def error(self, handle):
        e = self._lib.hvd_core_handle_error(self._ctx, handle)
        return e.decode() if e else ""

    def output(self, handle, dtype, out=None):
        """The completed handle's output, copied into a new CPU tensor, or
        into ``out`` (a contiguous CPU tensor of the output's size, such as
        a pinned staging buffer)."""
        ndim = self._lib.hvd_core_output_ndim(self._ctx, handle)
        if ndim < 0:
            raise NativeError(f"unknown handle {handle}")
        nbytes = self._lib.hvd_core_output_nbytes(self._ctx, handle)
        if out is not None:
            if out.numel() * out.element_size() != nbytes \
                    or not out.is_contiguous():
                raise NativeError(
                    f"output of handle {handle}: {nbytes} bytes do not fit "
                    f"the given tensor of {tuple(out.shape)}")
            if nbytes and self._lib.hvd_core_output_copy(
                    self._ctx, handle, ctypes.c_void_p(out.data_ptr()),
                    nbytes) != 0:
                raise NativeError("output copy failed")
            return out
        shape_arr = (ctypes.c_int64 * max(ndim, 1))()
        self._lib.hvd_core_output_shape(self._ctx, handle, shape_arr)
        shape = tuple(shape_arr[i] for i in range(ndim))
        out = torch.empty(shape, dtype=dtype)
        if out.numel() * out.element_size() != nbytes:
            # Shapeless payloads (join's int32) come back flat.
            out = torch.empty(nbytes // torch.empty((), dtype=dtype)
                              .element_size(), dtype=dtype)
        if nbytes > 0:
            rc = self._lib.hvd_core_output_copy(
                self._ctx, handle, ctypes.c_void_p(out.data_ptr()), nbytes)
            if rc != 0:
                raise NativeError("output copy failed")
        return out

    def recv_splits(self, handle):
        arr = (ctypes.c_int32 * self.size)()
        n = self._lib.hvd_core_recv_splits(self._ctx, handle, arr, self.size)
        if n < 0:
            raise NativeError("recv_splits failed")
        return torch.tensor([arr[i] for i in range(n)], dtype=torch.int32)

    def release(self, handle):
        self._lib.hvd_core_release(self._ctx, handle)

    def set_fusion_threshold(self, nbytes):
        """Apply an autotuned fusion threshold (every rank calls it with
        the same value at the same cycle boundary: the autotuner does, on
        the cycle thread, between two negotiation rounds)."""
        self._lib.hvd_core_set_fusion_threshold(self._ctx, int(nbytes))

    def set_topology(self, host_of, threshold):
        """Host map for hierarchical collectives: ``host_of[r]`` is the
        host index of global rank r; buffers of at least ``threshold``
        bytes take the two-level path (0 disables)."""
        arr = (ctypes.c_int32 * len(host_of))(*host_of)
        self._lib.hvd_core_set_topology(self._ctx, arr, len(host_of),
                                        int(threshold))

    # -- delegated execution ----------------------------------------------
    def next_delegated(self):
        """Token of the next agreed response for the caller to execute, or
        0 when none is pending."""
        return int(self._lib.hvd_core_next_delegated(self._ctx))

    def delegated(self, token):
        """A delegated response's descriptor as a dict: ``ps_id``, ``type``,
        ``dtype`` (wire enum), ``red_op``, ``prescale``, ``postscale``,
        ``handles`` (one per fused name, -1 where this rank has no entry)
        and ``sizes`` (allreduce: elements per name; allgather: rows per
        rank, then elements per row; broadcast: [count, root])."""
        i32 = [ctypes.c_int32() for _ in range(6)]
        pre, post = ctypes.c_double(), ctypes.c_double()
        ps_id, rtype, dtype, red_op, nt, ns = i32
        rc = self._lib.hvd_core_delegated_info(
            self._ctx, token, ctypes.byref(ps_id), ctypes.byref(rtype),
            ctypes.byref(dtype), ctypes.byref(red_op), ctypes.byref(pre),
            ctypes.byref(post), ctypes.byref(nt), ctypes.byref(ns))
        if rc != 0:
            raise NativeError(f"bad delegated token {token}")
        handles = (ctypes.c_int64 * max(1, nt.value))()
        sizes = (ctypes.c_int64 * max(1, ns.value))()
        self._lib.hvd_core_delegated_meta(self._ctx, token, handles, sizes)
        return {"token": token, "ps_id": ps_id.value, "type": rtype.value,
                "dtype": dtype.value, "red_op": red_op.value,
                "prescale": pre.value, "postscale": post.value,
                "handles": list(handles[:nt.value]),
                "sizes": list(sizes[:ns.value])}

    def delegated_complete(self, handle, error=""):
        """Mark a delegated handle done (the caller holds its result), or
        failed with ``error``."""
        self._lib.hvd_core_delegated_complete(
            self._ctx, handle, None, 0, None, 0, error.encode())

    def delegated_finish(self, token):
        self._lib.hvd_core_delegated_finish(self._ctx, token)

    # -- stats ------------------------------------------------------------
    def cycles(self):
        return self._lib.hvd_core_cycles(self._ctx)

    def bytes_processed(self):
        return self._lib.hvd_core_bytes_processed(self._ctx)

"""Eager named-tensor collectives on torch tensors (port of
``horovod_tpu/ops/collectives.py``; reference: horovod/torch/mpi_ops.py).

Each ``*_async`` call builds a ``TensorEntry`` and submits it to the
runtime's ``Coordinator``, which returns a handle at once;
``synchronize(handle)`` returns the result and ``poll(handle)`` says,
without blocking, whether it would. In a launcher job the native core
pairs the ranks' submissions by ``name``, in whatever order each rank made
them, and fuses them; a name is unique among a process set's in-flight
operations (``DuplicateNameError``). An unnamed call is named after its
call site in the user's program and a per-site counter, identical on every
rank that runs the same program. On CUDA tensors ``synchronize`` orders
the caller's stream after the transfer; the host waits only until the
collective has been issued.

The plain spellings return new tensors and leave their inputs alone; the
trailing-underscore spellings work in place, as in the reference's torch
binding. Results keep the input's dtype and device.
"""

import os
import threading

import torch

from .. import basics
from ..coordinator import Handle, TensorEntry
from ..process_sets import global_process_set
from ..utils import envparse
from ..utils.callsite import user_frame
from . import reduce_ops

_name_counter = [0]
_site_counters = {}
_name_lock = threading.Lock()
_legacy_names = None   # resolved lazily, so that tests can set the env first


def _auto_name(kind):
    """Deterministic per-call-site name: ``kind.auto.module:qualname:line#n``
    for the n-th call from that line (a process-global counter would
    diverge across ranks as soon as submission interleaving differs).
    HOROVOD_TPU_LEGACY_AUTO_NAMES=1 restores the global counter."""
    global _legacy_names
    if _legacy_names is None:
        _legacy_names = envparse.get_bool(envparse.LEGACY_AUTO_NAMES)
    if _legacy_names:
        with _name_lock:
            _name_counter[0] += 1
            return f"{kind}.noname.{_name_counter[0]}"
    filename, lineno, qualname = user_frame(skip=2)
    # basename: checkout prefixes legally differ across hosts of one job.
    module = os.path.basename(filename)
    if module.endswith(".py"):
        module = module[:-3]
    key = (kind, filename, lineno)
    with _name_lock:
        count = _site_counters.get(key, 0) + 1
        _site_counters[key] = count
    return f"{kind}.auto.{module}:{qualname}:{lineno}#{count}"


def reset_auto_name_counters():
    """Restart the per-site counters (init does, so that ranks that start
    again agree on names)."""
    global _legacy_names
    with _name_lock:
        _site_counters.clear()
        _name_counter[0] = 0
        _legacy_names = None


def _submit(entry):
    rt = basics.runtime()
    rt.check_alive()
    return rt.coordinator.submit(entry)


class _Derived:
    """A handle whose result is ``fn`` of other handles' results, computed
    once (the in-place write-back, unwrapping one tensor of a group,
    combining the allgathers of a sparse gradient)."""

    __slots__ = ("_handles", "_fn", "_done", "_result", "name")

    def __init__(self, handles, fn):
        self._handles = handles
        self._fn = fn
        self._done = False
        self._result = None
        self.name = handles[0].name

    def poll(self):
        return all(h.poll() for h in self._handles)

    def wait(self, timeout=None):
        if not self._done:
            self._result = self._fn(*[h.wait(timeout)
                                      for h in self._handles])
            self._done = True
        return self._result


def then(handle, fn):
    """The handle of ``fn(result of handle)``."""
    return _Derived([handle], fn)


def then_all(handles, fn):
    """The handle of ``fn(result of each handle, ...)``."""
    return _Derived(list(handles), fn)


def _check_set(process_set):
    basics.runtime().check_alive()
    if process_set.process_set_id is None:
        raise ValueError(f"{process_set} is not registered; call "
                         "add_process_set first")


def _dense(t):
    return t if t.is_contiguous() else t.contiguous()


def _in_place(tensors, handle):
    """The handle of an in-place operation on ``tensors``: dense copies
    were submitted where a tensor was not dense, and are written back."""
    def finish(results):
        for t, r in zip(tensors, results):
            if r is not t:
                t.copy_(r)
        return tensors
    return then(handle, finish)


def _empty_group_handle(kind):
    """A completed handle for an empty group (an empty bucket must never
    reach the coordinator); still checks that the runtime is alive."""
    basics.runtime().check_alive()
    h = Handle(_auto_name(f"{kind}.empty"))
    h._complete([])
    return h


def fusion_buckets(n, k):
    """Split n gradient/tensor slots into k contiguous near-even fusion
    buckets (the reference's num_groups split, reference:
    horovod/tensorflow/__init__.py:627+); k<=0 means one bucket. Shared
    by the TF and keras bindings so both sync planes split identically."""
    if not k or k <= 0 or n == 0:
        return [list(range(n))]
    k = min(int(k), n)
    size, extra = divmod(n, k)
    out, start = [], 0
    for j in range(k):
        end = start + size + (1 if j < extra else 0)
        out.append(list(range(start, end)))
        start = end
    return out


# --------------------------------------------------------------------------
# allreduce
# --------------------------------------------------------------------------
def _allreduce(kind, tensors, average, name, op, prescale_factor,
               postscale_factor, process_set, codec=None):
    op = reduce_ops.handle_average_backwards_compatibility(op, average)
    _check_set(process_set)
    if not tensors:
        return _empty_group_handle(kind)
    for t in tensors:
        if t.is_sparse:
            raise ValueError(
                "allreduce takes dense tensors; reduce a sparse gradient "
                "with sparse_allreduce, or densify it")
    entry = TensorEntry(name or _auto_name(kind), "allreduce",
                        [_dense(t) for t in tensors], process_set, op=op,
                        prescale=prescale_factor, postscale=postscale_factor,
                        codec=codec)
    return _in_place(tensors, _submit(entry))


def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             process_set=global_process_set, codec=None):
    """Reduce every tensor across the set in place: multiply by
    ``prescale_factor``, reduce with ``op`` (default Average), multiply by
    ``postscale_factor``. The group is one operation (reference:
    horovod/torch/mpi_ops.py:375). The handle resolves to the same
    tensors. ``codec`` names a wire codec (``"int8"``, ``"fp8"``) that
    runs the quantized pipeline; cast compressors run at the binding."""
    return _allreduce("grouped_allreduce", list(tensors), average, name, op,
                      prescale_factor, postscale_factor, process_set, codec)


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=global_process_set, codec=None):
    """Reduced copies of ``tensors``."""
    return _allreduce("grouped_allreduce", [t.clone() for t in tensors],
                      average, name, op, prescale_factor, postscale_factor,
                      process_set, codec)


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=global_process_set, codec=None):
    return then(_allreduce("allreduce", [tensor], average, name, op,
                           prescale_factor, postscale_factor, process_set,
                           codec), lambda r: r[0])


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=global_process_set, codec=None):
    """Reduced copy of ``tensor`` (reference: horovod/torch/mpi_ops.py:154)."""
    return then(_allreduce("allreduce", [tensor.clone()], average, name, op,
                           prescale_factor, postscale_factor, process_set,
                           codec), lambda r: r[0])


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       process_set=global_process_set, codec=None):
    return synchronize(grouped_allreduce_async_(
        tensors, average, name, op, prescale_factor, postscale_factor,
        process_set, codec))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=global_process_set, codec=None):
    return synchronize(grouped_allreduce_async(
        tensors, average, name, op, prescale_factor, postscale_factor,
        process_set, codec))


def allreduce_(tensor, average=None, name=None, op=None, prescale_factor=1.0,
               postscale_factor=1.0, process_set=global_process_set,
               codec=None):
    return synchronize(allreduce_async_(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set, codec))


def allreduce(tensor, average=None, name=None, op=None, prescale_factor=1.0,
              postscale_factor=1.0, process_set=global_process_set,
              codec=None):
    """Reduced copy of ``tensor`` (reference: horovod/torch/mpi_ops.py:211)."""
    return synchronize(allreduce_async(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set, codec))


# --------------------------------------------------------------------------
# allgather
# --------------------------------------------------------------------------
def grouped_allgather_async(tensors, name=None,
                            process_set=global_process_set):
    """Concatenation of every member's tensors along dim 0; the first
    dimension may differ between ranks."""
    _check_set(process_set)
    tensors = list(tensors)
    if not tensors:
        return _empty_group_handle("grouped_allgather")
    entry = TensorEntry(name or _auto_name("grouped_allgather"), "allgather",
                        [_dense(t) for t in tensors], process_set,
                        uneven=True)
    return _submit(entry)


def allgather_async(tensor, name=None, process_set=global_process_set):
    """Concatenation of every member's tensor along dim 0, which may differ
    between ranks (``uneven``: the consistency digest leaves it out)."""
    _check_set(process_set)
    entry = TensorEntry(name or _auto_name("allgather"), "allgather",
                        [_dense(tensor)], process_set, uneven=True)
    return then(_submit(entry), lambda r: r[0])


def grouped_allgather(tensors, name=None, process_set=global_process_set):
    return synchronize(grouped_allgather_async(tensors, name, process_set))


def allgather(tensor, name=None, process_set=global_process_set):
    return synchronize(allgather_async(tensor, name, process_set))


# --------------------------------------------------------------------------
# broadcast
# --------------------------------------------------------------------------
def broadcast_async_(tensor, root_rank, name=None,
                     process_set=global_process_set):
    """Overwrite ``tensor`` with ``root_rank``'s value, in place.
    ``root_rank`` is a global rank, a member of the set."""
    _check_set(process_set)
    if root_rank not in process_set.ranks:
        raise ValueError(f"root_rank {root_rank} is not a member of process "
                         f"set {process_set.ranks}")
    # Backends take the root's index within the set.
    entry = TensorEntry(name or _auto_name("broadcast"), "broadcast",
                        [_dense(tensor)], process_set,
                        root_rank=process_set.ranks.index(root_rank))
    return then(_in_place([tensor], _submit(entry)), lambda r: r[0])


def broadcast_async(tensor, root_rank, name=None,
                    process_set=global_process_set):
    """Copy of ``root_rank``'s ``tensor``."""
    return broadcast_async_(tensor.clone(), root_rank, name, process_set)


def broadcast_(tensor, root_rank, name=None, process_set=global_process_set):
    return synchronize(broadcast_async_(tensor, root_rank, name,
                                        process_set))


def broadcast(tensor, root_rank, name=None, process_set=global_process_set):
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


# --------------------------------------------------------------------------
# alltoall
# --------------------------------------------------------------------------
def alltoall_async(tensor, splits=None, name=None,
                   process_set=global_process_set):
    """Send rows ``splits[i]`` of dim 0 to the set's i-th member (equal
    parts without ``splits``). The handle resolves to ``(received,
    received_splits)``, the splits as int32 (reference:
    horovod/torch/mpi_ops.py:824)."""
    _check_set(process_set)
    if splits is not None:
        splits = torch.as_tensor(splits, dtype=torch.int32)
        if splits.shape != (len(process_set.ranks),):
            raise ValueError(f"alltoall: splits needs one count per member "
                             f"({len(process_set.ranks)}), got shape "
                             f"{tuple(splits.shape)}")
    entry = TensorEntry(name or _auto_name("alltoall"), "alltoall",
                        [_dense(tensor)], process_set, splits=splits)
    return _submit(entry)


def alltoall(tensor, splits=None, name=None, process_set=global_process_set):
    """The received tensor, or ``(received, received_splits)`` when
    ``splits`` was given (reference: horovod/torch/mpi_ops.py:880)."""
    out, recv_splits = synchronize(alltoall_async(tensor, splits, name,
                                                  process_set))
    return out if splits is None else (out, recv_splits)


# --------------------------------------------------------------------------
# reducescatter
# --------------------------------------------------------------------------
def _reducescatter(kind, tensors, op, name, process_set):
    _check_set(process_set)
    if not tensors:
        return _empty_group_handle(kind)
    entry = TensorEntry(name or _auto_name(kind), "reducescatter",
                        [_dense(t) for t in tensors], process_set, op=op)
    return _submit(entry)


def grouped_reducescatter_async(tensors, op=reduce_ops.Average, name=None,
                                process_set=global_process_set):
    """Reduce each tensor across the set and keep this rank's part of dim 0;
    where dim 0 does not divide by the set size, earlier ranks take the
    remainder."""
    return _reducescatter("grouped_reducescatter", list(tensors), op, name,
                          process_set)


def reducescatter_async(tensor, op=reduce_ops.Average, name=None,
                        process_set=global_process_set):
    return then(_reducescatter("reducescatter", [tensor], op, name,
                               process_set), lambda r: r[0])


def grouped_reducescatter(tensors, op=reduce_ops.Average, name=None,
                          process_set=global_process_set):
    return synchronize(grouped_reducescatter_async(tensors, op, name,
                                                   process_set))


def reducescatter(tensor, op=reduce_ops.Average, name=None,
                  process_set=global_process_set):
    return synchronize(reducescatter_async(tensor, op, name, process_set))


# --------------------------------------------------------------------------
# barrier / join / handles
# --------------------------------------------------------------------------
def barrier(process_set=global_process_set):
    """Block until every rank of the set arrives (reference:
    horovod/torch/mpi_ops.py:976)."""
    _check_set(process_set)
    synchronize(_submit(TensorEntry(_auto_name("barrier"), "barrier", [],
                                    process_set)))


def join(device=-1):
    """Signal that this rank has no more work; returns the last rank to
    join (reference: horovod/torch/mpi_ops.py:954, EnqueueJoin). In a
    launcher job the native core pads this rank into its peers'
    collectives with the reduction's identity until every rank has joined;
    in a single-process job it is a barrier."""
    rt = basics.runtime()
    if rt.mode != basics.MODE_SPMD:
        barrier()
        return rt.topology.size - 1
    return synchronize(_submit(TensorEntry(
        _auto_name("join"), "join", [], global_process_set)))


def poll(handle):
    """True when ``synchronize(handle)`` would not block the host
    (reference: horovod/torch/mpi_ops.py:914)."""
    return handle.poll()


def synchronize(handle):
    """The result of an async collective (reference:
    horovod/torch/mpi_ops.py:930)."""
    return handle.wait()

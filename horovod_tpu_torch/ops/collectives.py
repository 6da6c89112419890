"""Eager collectives on torch tensors (port of
``horovod_tpu/ops/collectives.py``).

Each ``*_async`` call launches its collective on the runtime's backend at
once and returns a handle (a ``backend.Work``); ``synchronize(handle)``
returns the result and ``poll(handle)`` says, without blocking, whether
it would find the transfer done. On CUDA tensors ``synchronize`` orders
the caller's stream after the transfer and does not make the host wait.
The blocking spellings are ``synchronize`` of the async ones. Every rank of
a process set must make the same calls on it in the same order: named
negotiation and fusion come with the Coordinator in a later slice, so
``name`` is accepted for API compatibility and not used yet.

The plain spellings return new tensors and leave their inputs alone; the
trailing-underscore spellings work in place, as in the reference's torch
binding. Results keep the input's dtype and device.
"""

import torch

from .. import basics
from ..backend import Work
from ..process_sets import global_process_set
from . import reduce_ops


def _backend(process_set):
    backend = basics.runtime().backend
    if process_set.process_set_id is None:
        raise ValueError(f"{process_set} is not registered; call "
                         "add_process_set first")
    return backend


def _dense(t):
    return t if t.is_contiguous() else t.contiguous()


def _in_place(tensors, launch):
    """Launch ``launch(dense tensors)`` (a backend call that works in
    place) and copy the result back into tensors that were not dense."""
    dense = [_dense(t) for t in tensors]
    work = launch(dense)

    def finish():
        work.wait()
        for t, d in zip(tensors, dense):
            if d is not t:
                t.copy_(d)
        return tensors
    return Work([work], finish)


# --------------------------------------------------------------------------
# allreduce
# --------------------------------------------------------------------------
def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             process_set=global_process_set):
    """Reduce every tensor across the set in place: multiply by
    ``prescale_factor``, reduce with ``op`` (default Average), multiply by
    ``postscale_factor``. The handle resolves to the same tensors."""
    op = reduce_ops.handle_average_backwards_compatibility(op, average)
    backend = _backend(process_set)
    return _in_place(list(tensors), lambda ts: backend.allreduce_async(
        ts, op, prescale_factor, postscale_factor, process_set))


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=global_process_set):
    """Reduced copies of ``tensors`` (reference: horovod/torch/mpi_ops.py
    grouped_allreduce_async)."""
    return grouped_allreduce_async_([t.clone() for t in tensors], average,
                                    name, op, prescale_factor,
                                    postscale_factor, process_set)


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=global_process_set):
    work = grouped_allreduce_async_([tensor], average, name, op,
                                    prescale_factor, postscale_factor,
                                    process_set)
    return Work([work], lambda: work.wait()[0])


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=global_process_set):
    """Reduced copy of ``tensor`` (reference: horovod/torch/mpi_ops.py:154)."""
    return allreduce_async_(tensor.clone(), average, name, op,
                            prescale_factor, postscale_factor, process_set)


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       process_set=global_process_set):
    return synchronize(grouped_allreduce_async_(
        tensors, average, name, op, prescale_factor, postscale_factor,
        process_set))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=global_process_set):
    return synchronize(grouped_allreduce_async(
        tensors, average, name, op, prescale_factor, postscale_factor,
        process_set))


def allreduce_(tensor, average=None, name=None, op=None, prescale_factor=1.0,
               postscale_factor=1.0, process_set=global_process_set):
    return synchronize(allreduce_async_(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set))


def allreduce(tensor, average=None, name=None, op=None, prescale_factor=1.0,
              postscale_factor=1.0, process_set=global_process_set):
    """Reduced copy of ``tensor`` (reference: horovod/torch/mpi_ops.py:211)."""
    return synchronize(allreduce_async(
        tensor, average, name, op, prescale_factor, postscale_factor,
        process_set))


# --------------------------------------------------------------------------
# allgather
# --------------------------------------------------------------------------
def grouped_allgather_async(tensors, name=None,
                            process_set=global_process_set):
    """Concatenation of every member's tensors along dim 0; the first
    dimension may differ between ranks."""
    return _backend(process_set).allgather_async(
        [_dense(t) for t in tensors], process_set)


def allgather_async(tensor, name=None, process_set=global_process_set):
    work = grouped_allgather_async([tensor], name, process_set)
    return Work([work], lambda: work.wait()[0])


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
    backend = _backend(process_set)
    if root_rank not in process_set.ranks:
        raise ValueError(f"root_rank {root_rank} is not a member of process "
                         f"set {process_set.ranks}")
    work = _in_place([tensor], lambda ts: backend.broadcast_async(
        ts, root_rank, process_set))
    return Work([work], lambda: work.wait()[0])


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
    backend = _backend(process_set)
    if splits is not None:
        splits = torch.as_tensor(splits, dtype=torch.int32)
        if splits.shape != (len(process_set.ranks),):
            raise ValueError(f"alltoall: splits needs one count per member "
                             f"({len(process_set.ranks)}), got shape "
                             f"{tuple(splits.shape)}")
    return backend.alltoall_async(_dense(tensor), splits, process_set)


def alltoall(tensor, splits=None, name=None, process_set=global_process_set):
    """The received tensor, or ``(received, received_splits)`` when
    ``splits`` was given (reference: horovod/torch/mpi_ops.py:880)."""
    out, recv_splits = synchronize(alltoall_async(tensor, splits, name,
                                                  process_set))
    return out if splits is None else (out, recv_splits)


# --------------------------------------------------------------------------
# reducescatter
# --------------------------------------------------------------------------
def grouped_reducescatter_async(tensors, op=reduce_ops.Average, name=None,
                                process_set=global_process_set):
    """Reduce each tensor across the set and keep this rank's part of dim 0;
    where dim 0 does not divide by the set size, earlier ranks take the
    remainder."""
    return _backend(process_set).reducescatter_async(
        [_dense(t) for t in tensors], op, process_set)


def reducescatter_async(tensor, op=reduce_ops.Average, name=None,
                        process_set=global_process_set):
    work = grouped_reducescatter_async([tensor], op, name, process_set)
    return Work([work], lambda: work.wait()[0])


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
    """Block until every rank of the set arrives."""
    _backend(process_set).barrier(process_set)


def join(device=-1):
    """Signal that this rank has no more work; returns the last rank to
    join. Without the JAX package's native core this is a barrier that
    returns ``size - 1`` (reference: horovod/torch/mpi_ops.py:954)."""
    barrier()
    return basics.size() - 1


def poll(handle):
    """True when ``synchronize(handle)`` would find the transfer done; never
    blocks (reference: horovod/torch/mpi_ops.py:914)."""
    return handle.poll()


def synchronize(handle):
    """The result of an async collective (reference:
    horovod/torch/mpi_ops.py:930)."""
    return handle.wait()

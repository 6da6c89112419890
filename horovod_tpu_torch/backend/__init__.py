"""Data-plane backends behind the coordinator (port of
``horovod_tpu/backend/__init__.py``; reference: horovod/common/ops/
operation_manager.cc:42-80).

- ``LoopbackBackend``: a single-process job. The coordinator's Python
  plane fuses and hands it each bucket; collectives over one rank are the
  scaling alone.
- ``TcpBackend`` (``tcp_backend.py``): a launcher job on CPU tensors. The
  native core negotiates, fuses and moves the bytes over its TCP ring.
- ``NcclGlobalBackend`` (``nccl_global.py``): the native core negotiates
  and fuses, and ``torch.distributed`` executes the agreed responses: NCCL
  for CUDA tensors, gloo for CPU ones.

The Python plane's calls take lists of tensors, so that one call carries a
whole fusion bucket. Allreduce and broadcast work in place on the tensors
they are given; ``ops/collectives.py`` copies first where its API returns
new tensors.
"""

from abc import ABC, abstractmethod

import torch


def scale_(tensors, factor):
    """Multiply each tensor by ``factor`` in place (integer tensors through
    float64, truncated back, as the native core's ScaleBuffer does)."""
    if factor is None or factor == 1.0:
        return
    for t in tensors:
        if t.is_floating_point():
            t.mul_(factor)
        else:
            t.copy_(t.double().mul_(factor))


class Backend(ABC):
    """Interface the coordinator's Python plane executes. ``ps`` is a
    registered ``ProcessSet``."""

    name = "abstract"

    @abstractmethod
    def allreduce(self, tensors, op, ps, prescale=None, postscale=None):
        """Reduce each tensor across the set, in place; returns them."""

    @abstractmethod
    def allgather(self, tensors, ps):
        """Concatenate each tensor across the set along dim 0 (first dims
        may differ between ranks); returns new tensors."""

    @abstractmethod
    def broadcast(self, tensors, root_rank, ps):
        """Overwrite each tensor with the value of the set's
        ``root_rank``-th member, in place; returns them."""

    @abstractmethod
    def alltoall(self, tensor, splits, ps):
        """Send rows ``splits[i]`` of dim 0 to the set's i-th rank (equal
        parts when ``splits`` is None); returns ``(received, received
        splits as int32)``."""

    @abstractmethod
    def reducescatter(self, tensors, op, ps):
        """Reduce each tensor across the set and keep this rank's part of
        dim 0 (earlier ranks take the remainder); returns new tensors."""

    @abstractmethod
    def barrier(self, ps):
        """Block until every rank of the set arrives."""

    def add_process_set(self, ps):
        pass

    def remove_process_set(self, ps):
        pass

    def close(self):
        pass


class LoopbackBackend(Backend):
    """Single-process backend: collectives are identities after scaling."""

    name = "loopback"

    def allreduce(self, tensors, op, ps, prescale=None, postscale=None):
        scale_(tensors, prescale)
        scale_(tensors, postscale)
        return tensors

    def allgather(self, tensors, ps):
        return [t.clone() for t in tensors]

    def broadcast(self, tensors, root_rank, ps):
        return tensors

    def alltoall(self, tensor, splits, ps):
        if splits is None:
            splits = torch.tensor([tensor.shape[0]], dtype=torch.int32)
        return tensor.clone(), splits.to(torch.int32)

    def reducescatter(self, tensors, op, ps):
        return [t.clone() for t in tensors]

    def barrier(self, ps):
        pass


def make_spmd_backend(topology, device):
    """The data plane of a launcher job (reference: operations.cc:144-253
    CreateOperationManager): CUDA tensors always take the NCCL-delegated
    plane; CPU tensors take the native TCP ring, or the delegated plane
    over gloo when ``HVDTPU_CPU_OPERATIONS`` is nccl, xla or xla-global
    (the JAX package's spellings)."""
    from ..utils import envparse
    cpu_ops = envparse.get_str(envparse.CPU_OPERATIONS, "").lower()
    if device.type == "cuda" or cpu_ops in ("nccl", "xla", "xla-global"):
        from .nccl_global import NcclGlobalBackend
        return NcclGlobalBackend(topology, device)
    from .tcp_backend import TcpBackend
    return TcpBackend(topology)

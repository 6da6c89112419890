"""Data-plane backends behind the coordinator (port of
``horovod_tpu/backend/__init__.py``; reference: horovod/common/ops/
operation_manager.cc:42-80).

- ``LoopbackBackend``: a single-process job. The coordinator's Python
  plane fuses and hands it each bucket; collectives over one rank are the
  scaling alone (Adasum over one rank included), and a wire-compressed
  bucket runs both legs of the quantized pipeline.
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

    def allreduce_quantized(self, tensors, op, ps, codec, block,
                            prescale=None, postscale=None, residuals=None):
        """The quantized pipeline at one rank (the JAX package's
        ``XlaSingleBackend.allreduce_quantized`` with one device): the
        bucket's float32 values, prescaled and with their residuals added,
        are quantized and dequantized for the reduce-scatter leg, scaled,
        and quantized and dequantized again for the allgather leg. Returns
        ``(outs, new_residuals)``; ``new_residuals[i]`` is tensor i's
        input minus its first leg's reconstruction (None without
        ``residuals``)."""
        from ..compression.codecs import padded_len
        from ..ops import reduce_ops
        if op not in (reduce_ops.Sum, reduce_ops.Average):
            raise ValueError("quantized allreduce supports Sum/Average, got "
                             f"{reduce_ops.op_name(op)}")
        flats = []
        for i, t in enumerate(tensors):
            f = t.reshape(-1).to(torch.float32)
            if prescale is not None and prescale != 1.0:
                f = f * prescale
            if residuals is not None:
                f = f + residuals[i].reshape(-1)
            flats.append(f)
        flat = torch.cat(flats) if len(flats) > 1 else flats[0]
        total = flat.numel()
        padded = padded_len(total, 1, block)
        if padded != total:
            flat = torch.nn.functional.pad(flat, (0, padded - total))
        q, s = codec.encode(flat, block)
        red = codec.decode(q, s, block)
        err = flat - red
        if postscale is not None and postscale != 1.0:
            red = red * postscale
        q2, s2 = codec.encode(red, block)
        out = codec.decode(q2, s2, block)
        outs, errs, off = [], [], 0
        for t in tensors:
            n = t.numel()
            outs.append(out[off:off + n].reshape(t.shape).to(t.dtype))
            errs.append(err[off:off + n].reshape(t.shape))
            off += n
        return outs, (errs if residuals is not None else None)

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

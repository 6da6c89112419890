"""Eager-collective data-plane backends (port of
``horovod_tpu/backend/__init__.py``).

- ``LoopbackBackend``: world size 1; collectives are identities after
  scaling, complete when they return.
- ``TorchDistBackend``: N processes over ``torch.distributed`` — NCCL for
  CUDA tensors, gloo for CPU tensors — in place of the JAX package's
  ``make_spmd_backend`` (TCP or XLA-global planes). Each process set gets
  its own ``dist.new_group``.

Every collective is launched by its ``*_async`` method, which returns a
:class:`Work` at once; ``Work.wait()`` returns the result. On CUDA tensors
NCCL runs on its own stream and ``wait()`` makes the caller's stream wait
for it: the host does not block. Allreduce and broadcast work in place on
the tensors they are given; ``ops/collectives.py`` copies first where its
API returns new tensors.
"""

from abc import ABC, abstractmethod

import torch

from ..ops import reduce_ops


class Work:
    """A launched collective. ``poll()`` says whether ``wait()`` would find
    the transfers done, without blocking; ``wait()`` orders the caller
    after them, runs ``finish`` (the scaling and unpacking that follow the
    transfer) once, and returns its result."""

    __slots__ = ("_works", "_finish", "_done", "_result")

    def __init__(self, works=(), finish=None, result=None):
        self._works = list(works)
        self._finish = finish
        self._done = not self._works and finish is None
        self._result = result

    @classmethod
    def completed(cls, result):
        return cls(result=result)

    def poll(self):
        return self._done or all(w.is_completed() for w in self._works)

    is_completed = poll   # the torch.distributed Work spelling, for nesting

    def wait(self):
        if not self._done:
            for w in self._works:
                w.wait()
            if self._finish is not None:
                self._result = self._finish()
            self._done = True
            self._works = []
        return self._result


def _scale(tensors, factor):
    if factor is not None and factor != 1.0:
        for t in tensors:
            t.mul_(factor)


def _reducescatter_counts(rows, n):
    """Rows of dim 0 that each of ``n`` ranks receives: earlier ranks take
    the remainder (reference: ops/collectives.py reducescatter)."""
    q, r = divmod(rows, n)
    return [q + (1 if i < r else 0) for i in range(n)]


class Backend(ABC):
    """Interface of the data plane. Grouped entry points take lists of
    tensors so that one call can carry a whole fusion bucket; ``ps`` is a
    registered ``ProcessSet``."""

    name = "abstract"

    @abstractmethod
    def allreduce_async(self, tensors, op, prescale, postscale, ps):
        """Reduce each tensor across the set, in place; result: the
        tensors."""

    @abstractmethod
    def allgather_async(self, tensors, ps):
        """Concatenate each tensor across the set along dim 0 (first dims
        may differ between ranks); result: new tensors."""

    @abstractmethod
    def broadcast_async(self, tensors, root_rank, ps):
        """Overwrite each tensor with global rank ``root_rank``'s value, in
        place; result: the tensors."""

    @abstractmethod
    def alltoall_async(self, tensor, splits, ps):
        """Send rows ``splits[i]`` of dim 0 to the set's i-th rank (equal
        parts when ``splits`` is None); result: ``(received, received
        splits as int32)``."""

    @abstractmethod
    def reducescatter_async(self, tensors, op, ps):
        """Reduce each tensor across the set and keep this rank's part of
        dim 0 (earlier ranks take the remainder); result: new tensors."""

    @abstractmethod
    def barrier(self, ps):
        """Block until every rank of the set arrives."""

    def alltoall(self, tensor, splits, ps):
        return self.alltoall_async(tensor, splits, ps).wait()

    def reducescatter(self, tensors, op, ps):
        return self.reducescatter_async(tensors, op, ps).wait()

    def add_process_set(self, ps):
        pass

    def remove_process_set(self, ps):
        pass

    def close(self):
        pass


class LoopbackBackend(Backend):
    """World-size-1 backend: collectives are identities (after scaling)."""

    name = "loopback"

    def allreduce_async(self, tensors, op, prescale, postscale, ps):
        _scale(tensors, prescale)
        _scale(tensors, postscale)
        return Work.completed(tensors)

    def allgather_async(self, tensors, ps):
        return Work.completed([t.clone() for t in tensors])

    def broadcast_async(self, tensors, root_rank, ps):
        return Work.completed(tensors)

    def alltoall_async(self, tensor, splits, ps):
        if splits is None:
            splits = torch.tensor([tensor.shape[0]], dtype=torch.int32)
        return Work.completed((tensor.clone(), splits.to(torch.int32)))

    def reducescatter_async(self, tensors, op, ps):
        return Work.completed([t.clone() for t in tensors])

    def barrier(self, ps):
        pass


class TorchDistBackend(Backend):
    """Multi-process backend over ``torch.distributed``. The process group
    rendezvous reads ``MASTER_ADDR``/``MASTER_PORT`` (``env://``)."""

    def __init__(self, topology, device):
        import torch.distributed as dist
        self._dist = dist
        self.device = device
        self.rank = topology.rank
        self.name = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(self.name, init_method="env://",
                                rank=topology.rank,
                                world_size=topology.size)
        self._groups = {}   # process_set_id -> group (None: the world)

    _OPS = {reduce_ops.Sum: "SUM", reduce_ops.Average: "SUM",
            reduce_ops.Min: "MIN", reduce_ops.Max: "MAX",
            reduce_ops.Product: "PRODUCT"}

    def add_process_set(self, ps):
        # new_group is collective over the world: every rank calls it.
        self._groups[ps.process_set_id] = (
            None if ps.process_set_id == 0
            else self._dist.new_group(ps.ranks))

    def remove_process_set(self, ps):
        group = self._groups.pop(ps.process_set_id, None)
        if group is not None and self.rank in ps.ranks:
            self._dist.destroy_process_group(group)

    def _group(self, ps):
        if self.rank not in ps.ranks:
            raise RuntimeError(
                f"rank {self.rank} is not a member of the process set "
                f"{ps.ranks}")
        return self._groups[ps.process_set_id]

    def _red(self, op):
        if op not in self._OPS:
            raise NotImplementedError(
                f"allreduce op {reduce_ops.op_name(op)} is not ported yet "
                "(Adasum: ROADMAP queue A, item 10)")
        return getattr(self._dist.ReduceOp, self._OPS[op])

    def allreduce_async(self, tensors, op, prescale, postscale, ps):
        red, group, n = self._red(op), self._group(ps), len(ps.ranks)
        _scale(tensors, prescale)
        works = [self._dist.all_reduce(t, op=red, group=group, async_op=True)
                 for t in tensors]

        def finish():
            if op == reduce_ops.Average:
                for t in tensors:
                    t.div_(n)
            _scale(tensors, postscale)
            return tensors
        return Work(works, finish)

    def _exchange_rows(self, rows, group, n, device):
        """Every member's ``rows`` (a host wait: the sizes of what follows
        are needed on the host)."""
        mine = torch.tensor([rows], dtype=torch.int64, device=device)
        every = [torch.empty_like(mine) for _ in range(n)]
        self._dist.all_gather(every, mine, group=group)
        return [int(r) for r in torch.cat(every).tolist()]

    def allgather_async(self, tensors, ps):
        group, n = self._group(ps), len(ps.ranks)
        works, pieces = [], []
        for t in tensors:
            t = t.contiguous()
            counts = self._exchange_rows(t.shape[0], group, n, t.device)
            padded = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
            padded[:t.shape[0]] = t
            parts = [torch.empty_like(padded) for _ in range(n)]
            works.append(self._dist.all_gather(parts, padded, group=group,
                                               async_op=True))
            pieces.append((parts, counts))

        def finish():
            return [torch.cat([p[:c] for p, c in zip(parts, counts)])
                    for parts, counts in pieces]
        return Work(works, finish)

    def broadcast_async(self, tensors, root_rank, ps):
        group = self._group(ps)
        works = [self._dist.broadcast(t, src=root_rank, group=group,
                                      async_op=True) for t in tensors]
        return Work(works, lambda: tensors)

    def alltoall_async(self, tensor, splits, ps):
        group, n = self._group(ps), len(ps.ranks)
        tensor = tensor.contiguous()
        if splits is None:
            if tensor.shape[0] % n:
                raise ValueError(
                    f"alltoall: dim 0 ({tensor.shape[0]}) does not divide "
                    f"by the process set size ({n}); pass splits")
            send = [tensor.shape[0] // n] * n
        else:
            send = [int(s) for s in splits.tolist()]
        # all_to_all_single needs the received sizes up front: exchange
        # the split counts first (one small alltoall).
        send_t = torch.tensor(send, dtype=torch.int64, device=tensor.device)
        recv_t = torch.empty_like(send_t)
        self._dist.all_to_all_single(recv_t, send_t, group=group)
        recv = [int(r) for r in recv_t.tolist()]
        out = tensor.new_empty((sum(recv),) + tuple(tensor.shape[1:]))
        work = self._dist.all_to_all_single(out, tensor, recv, send,
                                            group=group, async_op=True)
        return Work([work], lambda: (out, recv_t.to(torch.int32)))

    def reducescatter_async(self, tensors, op, ps):
        red, group, n = self._red(op), self._group(ps), len(ps.ranks)
        me = ps.ranks.index(self.rank)
        # reduce_scatter_single is the newer name of reduce_scatter_tensor.
        scatter = getattr(self._dist, "reduce_scatter_single", None) \
            or self._dist.reduce_scatter_tensor
        works, outs = [], []
        for t in tensors:
            counts = _reducescatter_counts(t.shape[0], n)
            chunk = counts[0]
            if counts[-1] == chunk:
                padded = t.contiguous()
            else:
                # Uneven: pad every rank's part to the first (largest) one,
                # so that the collective scatters equal chunks.
                padded = t.new_zeros((n * chunk,) + tuple(t.shape[1:]))
                start = 0
                for i, c in enumerate(counts):
                    padded[i * chunk:i * chunk + c] = t[start:start + c]
                    start += c
            out = t.new_empty((chunk,) + tuple(t.shape[1:]))
            works.append(scatter(out, padded, op=red, group=group,
                                 async_op=True))
            outs.append(out[:counts[me]])

        def finish():
            if op == reduce_ops.Average:
                for o in outs:
                    o.div_(n)
            return outs
        return Work(works, finish)

    def barrier(self, ps):
        group = self._group(ps)
        if self.device.type == "cuda":
            self._dist.barrier(group=group, device_ids=[self.device.index])
        else:
            self._dist.barrier(group=group)

    def close(self):
        if self._dist.is_initialized():
            self._dist.destroy_process_group()

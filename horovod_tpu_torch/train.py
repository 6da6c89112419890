"""Distributed training: the optimizer wrapper and the train step (port of
``horovod_tpu/jax/__init__.py``).

The reference's execution model (horovod/torch/optimizer.py): each process
runs forward and backward on its shard of the batch, the gradients are
averaged across ranks, and every rank applies the same update. The JAX
package's per-process step (``_make_hostplane_train_step``) is the model
for :func:`make_train_step`.

:class:`DistributedOptimizer` here is the counterpart of
``horovod_tpu.jax.DistributedOptimizer``: it reduces after backward. The
reference torch API's grad-hook wrapper, which reduces while backward runs,
is ``horovod_tpu_torch.torch.DistributedOptimizer``; the train step takes
either.
"""

from . import basics
from .ops import reduce_ops
from .ops.collectives import allreduce, grouped_allreduce_, synchronize
from .ops.compression import Compression
from .process_sets import global_process_set
from .utils import envparse


class DistributedOptimizer:
    """Wraps a ``torch.optim.Optimizer`` so that gradients are reduced
    across ranks before every update (reference:
    horovod/torch/optimizer.py _DistributedOptimizer).

    Args:
      optimizer: the inner ``torch.optim.Optimizer``.
      op: Average (default), Sum or Adasum (each gradient its own
        combination: never fused with another).
      backward_passes_per_step: local gradient accumulation. ``.grad``
        accumulates over this many backward passes; the k-th ``step()``
        averages the sum over k, reduces it and updates.
      prescale_factor, postscale_factor: multiply gradients before / after
        the reduction.
      compression: ``Compression.fp16``/``bf16`` cast the gradients around
        the reduction; ``Compression.int8``/``fp8`` run it as the data
        plane's quantized pipeline (``horovod_tpu_torch/compression/``).
        A wire codec with Adasum raises.
      process_set: the ranks that reduce together (default all).

    In a launcher job the dense gradients are reduced after backward by one
    grouped allreduce named ``grad`` through the coordinator, whose native
    core fuses them into buckets under ``HVDTPU_FUSION_THRESHOLD``; sparse
    gradients (``nn.Embedding(sparse=True)``) go through
    ``ops.sparse.sparse_allreduce_async`` first, named ``grad.sp<i>``, and
    keep their layout. In a single-process job the reduction is the
    identity for every option (the JAX package's ``_reduce`` and
    ``_reduce_quantized``, ``horovod_tpu/jax/__init__.py:262-430``).
    """

    def __init__(self, optimizer, op=reduce_ops.Average,
                 backward_passes_per_step=1, prescale_factor=None,
                 postscale_factor=None, compression=None,
                 process_set=global_process_set):
        if op not in (reduce_ops.Average, reduce_ops.Sum,
                      reduce_ops.Adasum):
            raise ValueError(
                f"DistributedOptimizer op must be Average, Sum or Adasum, "
                f"got {reduce_ops.op_name(op)}")
        if compression is Compression.none:
            compression = None
        self._wire_codec = getattr(compression, "wire_codec", None)
        if compression is not None and self._wire_codec is None and \
                not hasattr(compression, "compress"):
            raise ValueError(
                f"compression must be a Compression member, got "
                f"{compression!r}")
        if self._wire_codec is not None and op == reduce_ops.Adasum:
            raise ValueError(
                f"compression={self._wire_codec!r} supports Average/Sum "
                "gradient reductions only (Adasum's scale-invariant "
                "combination needs exact per-rank gradients)")
        if envparse.get_bool(envparse.ZERO):
            raise NotImplementedError(
                "HVDTPU_ZERO: the ZeRO-1 sharded update is not ported yet "
                "(ROADMAP queue A, item 10)")
        self.process_set = process_set
        self.inner = optimizer
        self.op = op
        self.compression = compression
        self.k = int(backward_passes_per_step)
        if self.k < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.prescale = prescale_factor
        self.postscale = postscale_factor
        self._passes = 0

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def _params(self):
        return [p for group in self.inner.param_groups
                for p in group["params"] if p.grad is not None]

    def synchronize(self):
        """Reduce every ``.grad`` across ranks (in place for dense ones)."""
        params = self._params()
        if self.k > 1:
            for p in params:
                p.grad.div_(self.k)
        if basics.runtime().mode != basics.MODE_SPMD:
            return
        sparse = [p for p in params if p.grad.is_sparse]
        # Every sparse gradient is submitted before the dense reduction
        # waits, so that its gathers overlap it.
        handles = [(p, self._submit_sparse(i, p))
                   for i, p in enumerate(sparse)]
        dense = [p.grad for p in params if not p.grad.is_sparse]
        if dense:
            self._reduce_dense(dense)
        for p, h in handles:
            out = synchronize(h)
            if self.postscale is not None:
                out = out * self.postscale
            p.grad = out.to_sparse(p.grad.sparse_dim()).coalesce()

    def _submit_sparse(self, i, p):
        from .ops import sparse as sparse_ops
        grad = p.grad
        if self.prescale is not None:
            grad = grad * self.prescale
        return sparse_ops.sparse_allreduce_async(
            grad, op=self.op, name=f"grad.sp{i}",
            process_set=self.process_set)

    def _reduce_dense(self, grads):
        kw = dict(op=self.op, name="grad",
                  prescale_factor=self.prescale or 1.0,
                  postscale_factor=self.postscale or 1.0,
                  process_set=self.process_set)
        if self.compression is None or self._wire_codec is not None:
            grouped_allreduce_(grads, codec=self._wire_codec, **kw)
            return
        pairs = [self.compression.compress(g) for g in grads]
        narrow = [n if n is not g else n.clone()
                  for (n, _), g in zip(pairs, grads)]
        grouped_allreduce_(narrow, **kw)
        for g, n, (_, ctx) in zip(grads, narrow, pairs):
            g.copy_(self.compression.decompress(n, ctx))

    def step(self):
        """Count one backward pass; on every k-th, reduce the accumulated
        gradients and apply the inner update. Returns True when it
        updated."""
        self._passes += 1
        if self._passes % self.k:
            return False
        self.synchronize()
        self.inner.step()
        return True


def make_train_step(loss_fn, dist_opt, has_aux=False):
    """The per-process data-parallel step (port of
    ``_make_hostplane_train_step``).

    ``loss_fn(model, batch) -> scalar loss`` runs on this rank's shard of
    the batch. The returned ``step(model, batch) -> loss`` runs forward and
    backward, lets ``dist_opt`` reduce the gradients and update (clearing
    them after each update), and returns the loss averaged across ranks,
    detached. ``dist_opt`` is this module's :class:`DistributedOptimizer`
    or an optimizer wrapped by ``horovod_tpu_torch.torch.
    DistributedOptimizer`` (stepped every ``backward_passes_per_step``
    calls).

    With ``has_aux=True`` the model carries state besides its parameters
    in floating-point buffers (BatchNorm running statistics, flax's
    ``batch_stats``): after the update they are averaged across ranks in
    one grouped allreduce, as the JAX step averages its aux state
    (``jax/__init__.py:688-695``). Integer buffers (``num_batches_tracked``)
    stay as they are.
    """
    hooked = getattr(dist_opt, "_hvd_wrapped", False)
    passes = [0]

    def update():
        if not hooked:
            return dist_opt.step()
        passes[0] += 1
        if passes[0] % dist_opt._hvd_backward_passes:
            return False
        dist_opt.step()
        return True

    def step(model, batch):
        loss = loss_fn(model, batch)
        loss.backward()
        if update():
            dist_opt.zero_grad()
        if has_aux:
            aux = [b for b in model.buffers() if b.is_floating_point()]
            if aux:
                grouped_allreduce_(aux, op=reduce_ops.Average, name="aux")
        return allreduce(loss.detach(), op=reduce_ops.Average, name="loss")
    return step

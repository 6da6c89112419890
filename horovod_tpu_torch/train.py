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
from .ops.collectives import allreduce, grouped_allreduce_
from .process_sets import global_process_set
from .utils import envparse


class DistributedOptimizer:
    """Wraps a ``torch.optim.Optimizer`` so that gradients are reduced
    across ranks before every update (reference:
    horovod/torch/optimizer.py _DistributedOptimizer).

    Args:
      optimizer: the inner ``torch.optim.Optimizer``.
      op: Average (default) or Sum.
      backward_passes_per_step: local gradient accumulation. ``.grad``
        accumulates over this many backward passes; the k-th ``step()``
        averages the sum over k, reduces it and updates.
      prescale_factor, postscale_factor: multiply gradients before / after
        the reduction.
      compression: wire codecs are not ported yet; anything but None
        raises.
      process_set: the ranks that reduce together (default all).

    In a launcher job the gradients are reduced after backward by one
    grouped allreduce named ``grad`` through the coordinator, whose native
    core fuses them into buckets under ``HVDTPU_FUSION_THRESHOLD``; in a
    single-process job the reduction is the identity (the JAX package's
    ``_reduce``, ``horovod_tpu/jax/__init__.py:291-304``).
    """

    def __init__(self, optimizer, op=reduce_ops.Average,
                 backward_passes_per_step=1, prescale_factor=None,
                 postscale_factor=None, compression=None,
                 process_set=global_process_set):
        if op not in (reduce_ops.Average, reduce_ops.Sum):
            raise NotImplementedError(
                f"DistributedOptimizer op={reduce_ops.op_name(op)} is not "
                "ported yet (Adasum: ROADMAP queue A, item 10)")
        if compression is not None:
            raise NotImplementedError(
                "DistributedOptimizer compression is not ported yet "
                "(ROADMAP queue A, item 9)")
        if envparse.get_bool(envparse.ZERO):
            raise NotImplementedError(
                "HVDTPU_ZERO: the ZeRO-1 sharded update is not ported yet "
                "(ROADMAP queue A, item 10)")
        self.process_set = process_set
        self.inner = optimizer
        self.op = op
        self.k = int(backward_passes_per_step)
        if self.k < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.prescale = prescale_factor
        self.postscale = postscale_factor
        self._passes = 0

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def _grads(self):
        grads = [p.grad for group in self.inner.param_groups
                 for p in group["params"] if p.grad is not None]
        if any(g.is_sparse for g in grads):
            raise NotImplementedError(
                "sparse gradients are not ported yet (ROADMAP queue A, "
                "item 10)")
        return grads

    def synchronize(self):
        """Reduce every ``.grad`` across ranks, in place."""
        grads = self._grads()
        if self.k > 1:
            for g in grads:
                g.div_(self.k)
        if basics.runtime().mode == basics.MODE_SPMD:
            grouped_allreduce_(grads, op=self.op, name="grad",
                               prescale_factor=self.prescale or 1.0,
                               postscale_factor=self.postscale or 1.0,
                               process_set=self.process_set)

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

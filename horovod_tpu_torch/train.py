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

      zero: the ZeRO-1 sharded weight update (``ops/zero.py``): the
        gradients reduce-scatter instead of allreduce, each rank steps
        only its 1/n slice of a sharded optimizer state, and the updated
        slices allgather back into the parameters. None reads
        ``HVDTPU_ZERO``. Average/Sum only; Adasum, a process set other than
        the global one and ``backward_passes_per_step > 1`` raise here.
        ``state_dict()`` is then the world-size-independent state (a
        collective) and ``shard_state_dict()`` this rank's shard.

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
                 process_set=global_process_set, zero=None):
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
        # ZeRO-1 (HVDTPU_ZERO; ops/zero.py). The incompatible combinations
        # are refused here, as the JAX package refuses them at construction.
        self.zero = envparse.get_bool(envparse.ZERO) if zero is None \
            else bool(zero)
        self._zero_rt = None
        if self.zero:
            if op == reduce_ops.Adasum:
                raise ValueError(
                    "zero=True (HVDTPU_ZERO) is incompatible with "
                    "op=Adasum: Adasum's per-tensor scale-invariant "
                    "combination does not reduce-scatter")
            if process_set is not global_process_set:
                raise ValueError(
                    "zero=True (HVDTPU_ZERO) requires the global "
                    "process set: the shard plan partitions state over "
                    "the whole replica axis, and a sub-cohort would "
                    "compute a different (wrong) plan")
            if self.k != 1:
                raise ValueError(
                    "zero=True (HVDTPU_ZERO) does not compose with "
                    "backward_passes_per_step > 1 (accumulate micro-"
                    "batch gradients before the step instead)")
            from .autotune import overlay
            from .ops import zero as zero_ops
            # The autotuner's tuned value wins over the environment's
            # (autotune/overlay.py); a later change re-plans at the next
            # step (_zero_overlay_stale).
            self._zero_overlay_gen = overlay.generation()
            self._zero_overlay_pin = False
            self._zero_rt = self._make_zero_rt(overlay.resolve_int(
                envparse.ZERO_BUCKET_BYTES,
                zero_ops.DEFAULT_ZERO_BUCKET_BYTES))

    def _make_zero_rt(self, bucket_bytes):
        from .ops import zero as zero_ops
        codec, block = self._zero_codec()
        return zero_ops.ZeroRuntime(
            self.inner, op=self.op, bucket_bytes=bucket_bytes,
            codec=codec, block=block, prescale=self.prescale,
            postscale=self.postscale)

    def _zero_overlay_stale(self):
        """True when the autotuner's overlay moved
        ``HVDTPU_ZERO_BUCKET_BYTES`` under this optimizer (a zero-arm
        candidate mid-sweep, or a warm-started config landing after
        construction): the caller re-plans the shards. One int compare
        per step until the overlay moves."""
        from .autotune import overlay
        if self._zero_overlay_pin:
            return False
        gen = overlay.generation()
        if gen == self._zero_overlay_gen:
            return False
        self._zero_overlay_gen = gen
        v = overlay.get_int(envparse.ZERO_BUCKET_BYTES)
        if v is None or int(v) == self._zero_rt.bucket_bytes:
            return False
        return int(v)

    def _zero_replan(self):
        """Re-bucket the shards onto the overlay's new bucket bytes: the
        state moves through its world-size-independent form
        (``full_state_dict``), the route an elastic reshard takes."""
        v = self._zero_overlay_stale()
        if not v:
            return
        old = self._zero_rt
        new = self._make_zero_rt(v)
        if old.inner is not None:
            new.load_full_state_dict(old.full_state_dict())
        self._zero_rt = new

    # -- ZeRO-1 mode -------------------------------------------------------
    def _zero_codec(self):
        """The codec the ZeRO legs carry: the wire codec with the
        compression plane's block, or the cast compressors by their codec
        names (the legs ride the narrow dtype)."""
        if self._wire_codec is not None:
            from .compression import codecs
            return self._wire_codec, envparse.get_int(
                envparse.COMPRESSION_BLOCK, codecs.DEFAULT_BLOCK)
        if self.compression is Compression.fp16:
            return "fp16", 0
        if self.compression is Compression.bf16:
            return "bf16", 0
        return None, 0

    def init(self):
        """Build the sharded state now (ZeRO mode; the first ``step`` does
        otherwise). Nothing to do in the replicated mode."""
        if self.zero:
            self._zero_rt.init_state()

    def update(self):
        """ZeRO mode's ``update``: reduce-scatter, step this rank's shard
        and return the gathered updates, one tensor per parameter of the
        wrapped optimizer, without applying them (``p.add_(u)`` does; the
        train step applies them inside the shard instead)."""
        if not self.zero:
            raise RuntimeError(
                "update() is the ZeRO mode's; call step() otherwise")
        if self._zero_rt.inner is None:
            raise RuntimeError(
                "ZeRO mode: call init() (or run through make_train_step) "
                "before update — the sharded state and shard plan are "
                "built there")
        self._zero_replan()
        return self._zero_rt.update()

    def state_dict(self):
        """The wrapped optimizer's state; in ZeRO mode the world-size-
        independent state (``ZeroRuntime.full_state_dict``: a collective,
        every rank calls it, and rank 0's copy holds the moments), which
        ``checkpoint.save_step`` writes and ``load_state_dict`` places at
        any world size."""
        if self.zero:
            return self._zero_rt.full_state_dict()
        return self.inner.state_dict()

    def shard_state_dict(self):
        """ZeRO mode: this rank's shard of the state, keyed by the plan and
        the rank (no collective; an elastic commit takes it)."""
        if not self.zero:
            raise RuntimeError("shard_state_dict() is the ZeRO mode's")
        return self._zero_rt.state_dict()

    def load_state_dict(self, state):
        """Either form of ``state_dict()``: in ZeRO mode a
        ``shard_state_dict`` of the same plan and rank, or a
        world-size-independent state (``{"zero": ...}``)."""
        if self.zero:
            if "zero" in state:
                self._zero_rt.load_full_state_dict(state)
            else:
                self._zero_rt.load_state_dict(state)
        else:
            self.inner.load_state_dict(state)

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
        if self.zero:
            self._zero_replan()
            self._zero_rt.apply()
            return True
        self.synchronize()
        self.inner.step()
        return True


def make_train_step(loss_fn, dist_opt, has_aux=False):
    """The per-process data-parallel step (port of
    ``_make_hostplane_train_step``).

    ``loss_fn(model, batch) -> scalar loss`` runs on this rank's shard of
    the batch. The returned ``step(model, batch) -> loss`` runs forward and
    backward, lets ``dist_opt`` reduce the gradients and update (clearing
    them after each update, and after a failed backward or update), and
    returns the loss averaged across ranks, detached. ``dist_opt`` is this module's :class:`DistributedOptimizer`
    or an optimizer wrapped by ``horovod_tpu_torch.torch.
    DistributedOptimizer`` (stepped every ``backward_passes_per_step``
    calls).

    Under ``dist_opt``'s ZeRO mode (``zero=True`` or ``HVDTPU_ZERO=1``)
    its ``step()`` is the sharded update (``ops/zero.py``): reduce-scatter,
    a step of this rank's shard, allgather into the parameters.

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
        try:
            loss.backward()
            updated = update()
        except BaseException:
            # A failed reduction (a dead peer, an abort) leaves no
            # gradients behind: the elastic restore runs the step again
            # from the last commit, and its backward must not accumulate
            # into the failed attempt's gradients (the JAX step is a
            # function of its inputs). The accumulation window restarts.
            dist_opt.zero_grad()
            passes[0] = 0
            if not hooked:
                dist_opt._passes = 0
            raise
        if updated:
            dist_opt.zero_grad()
        if has_aux:
            aux = [b for b in model.buffers() if b.is_floating_point()]
            if aux:
                grouped_allreduce_(aux, op=reduce_ops.Average, name="aux")
        return allreduce(loss.detach(), op=reduce_ops.Average, name="loss")
    return step


def make_zero_train_step(loss_fn, dist_opt):
    """The legacy explicit entry of the ZeRO-1 step (port of the JAX
    package's ``make_zero_train_step``, kept for its ``(step, init_state)``
    shape): one bucket per dtype, so that each moment is one flat sharded
    vector per dtype, and plain averaged gradients only. New code sets
    ``zero=True`` (or ``HVDTPU_ZERO=1``) and uses :func:`make_train_step`,
    which also buckets the legs and composes with Sum, compression and the
    scale factors.

    Returns ``(step, init_state)``: ``step(model, batch) -> loss`` as
    :func:`make_train_step`'s, and ``init_state()``, which builds the
    sharded state and returns this rank's shard of it (a state_dict).
    ``dist_opt`` itself is left as it is."""
    import copy
    from .ops import zero as zero_ops
    if not isinstance(dist_opt, DistributedOptimizer):
        raise TypeError("make_zero_train_step takes a "
                        "train.DistributedOptimizer")
    unsupported = []
    if dist_opt.op != reduce_ops.Average:
        unsupported.append(f"op={dist_opt.op!r}")
    if dist_opt.k != 1:
        unsupported.append(f"backward_passes_per_step={dist_opt.k}")
    if dist_opt.compression is not None:
        unsupported.append("compression")
    if dist_opt.prescale is not None or dist_opt.postscale is not None:
        unsupported.append("prescale/postscale")
    if unsupported:
        raise ValueError(
            "make_zero_train_step supports plain averaged gradients "
            "only; unsupported DistributedOptimizer settings: "
            + ", ".join(unsupported)
            + " (use make_train_step for these)")
    zopt = copy.copy(dist_opt)
    zopt.zero = True
    zopt._passes = 0
    zopt._zero_rt = zero_ops.ZeroRuntime(dist_opt.inner,
                                         bucket_bytes=1 << 62)
    # Pinned against the autotune overlay: a zero-arm retune would break
    # the one-vector-per-dtype state this entry promises.
    zopt._zero_overlay_pin = True

    def init_state():
        zopt.init()
        return zopt.shard_state_dict()

    return make_train_step(loss_fn, zopt), init_state

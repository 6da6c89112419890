"""Shared Keras-binding implementation on the port's runtime (port of
``horovod_tpu/_keras/__init__.py``; reference:
horovod/_keras/__init__.py:207). Keras 3 is multi-backend; the wrapper
synchronizes gradients through the plane that matches the backend:

- **torch backend**: the gradients are torch tensors already. They go
  straight into the port's grouped allreduce on their device (the card on
  a CUDA runtime), with no numpy round trip. A gradient on another device
  than the runtime's raises: nothing is copied across quietly.
- **tensorflow backend**: symbolic grads route through the TF binding's
  py_function bridge (``horovod_tpu_torch.tensorflow``).
- **jax backend**: refused when the optimizer is wrapped. The port runs
  torch, and it never pulls jax in.

Local gradient aggregation (``backward_passes_per_step``) delegates to
Keras 3's native ``gradient_accumulation_steps`` engine, which is
cond-based and therefore graph-safe on every backend (the reference's
graph-state design: horovod/tensorflow/gradient_aggregation.py:16).
"""

from .. import basics
from ..ops import collectives as _c
from ..ops import reduce_ops
from ..process_sets import global_process_set
from ..utils.logging_util import get_logger


def spmd_active():
    return basics.runtime().mode == basics.MODE_SPMD and basics.size() > 1


def rank():
    return basics.rank()


def size():
    return basics.size()


# One bucket-split algorithm for every frontend's sync plane.
_buckets = _c.fusion_buckets

# One-time note for the explicit IndexedSlices densification (the
# sparse plane routes them instead when HVDTPU_SPARSE is set).
_warned_sparse = [False]


def _reduce_torch_grads(grads, op, prescale, postscale, name,
                        compression=None, num_groups=0):
    """Grouped allreduce over a list of torch tensors on the runtime's
    device (None passthrough)."""
    from ..tensorflow import _grouped
    dense_idx = [i for i, g in enumerate(grads) if g is not None]
    if not dense_idx:
        return list(grads)
    device = basics.device()
    for i in dense_idx:
        if grads[i].device != device:
            raise ValueError(
                f"keras DistributedOptimizer: gradient {i} is on "
                f"{grads[i].device}, the runtime computes on {device}; "
                "build the model after hvd.init() (keras's torch backend "
                "places tensors on the current CUDA device, which init() "
                "sets), nothing is copied across devices")
    result = list(grads)
    for b, bucket in enumerate(_buckets(len(dense_idx), num_groups)):
        outs = _grouped([grads[dense_idx[j]] for j in bucket], op,
                        f"{name}.g{b}", compression, prescale, postscale,
                        global_process_set)
        for j, o in zip(bucket, outs):
            result[dense_idx[j]] = o
    return result


def create_distributed_optimizer(keras, optimizer, name=None,
                                 op=reduce_ops.Average,
                                 gradient_predivide_factor=1.0,
                                 backward_passes_per_step=1,
                                 average_aggregated_gradients=True,
                                 compression=None, num_groups=0):
    """Dynamic subclass of the optimizer whose apply() averages gradients
    across ranks first (reference: horovod/_keras/__init__.py:36
    create_distributed_optimizer).

    ``backward_passes_per_step > 1`` enables local gradient aggregation via
    Keras's native ``gradient_accumulation_steps`` (cond-based, graph-safe):
    the parameter update runs every k-th ``apply``. Rank-sync happens per
    micro-batch — for the linear Sum/Average reductions this is
    mathematically identical to the reference's aggregate-then-reduce
    (reference: horovod/tensorflow/gradient_aggregation.py:16).
    ``average_aggregated_gradients=False`` applies the micro-batch *sum*
    (implemented by prescaling each micro-batch gradient by k so Keras's
    built-in /k division cancels).

    ``compression`` (Compression.fp16/bf16, or a wire codec) shrinks the
    bytes each sync moves. ``num_groups > 0`` splits the gradient list into
    that many contiguous buckets, one grouped collective each (the
    reference's num_groups split); 0 (default) fuses each apply into a
    single grouped collective.
    """
    backend = keras.backend.backend()
    if backend == "jax":
        raise RuntimeError(
            "horovod_tpu_torch.keras: the jax keras backend is not "
            "supported on the port, which runs torch; set "
            "KERAS_BACKEND=torch (gradients sync on the runtime's device) "
            "or KERAS_BACKEND=tensorflow")
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    # average_aggregated_gradients only has meaning for k > 1; normalize
    # it out of the settings tuple at k == 1 so the re-wrap guard does
    # not reject an equivalent wrap over a no-effect default difference
    # (horovod_tpu_torch.keras defaults True, the tensorflow.keras
    # namespace mirrors the reference's False).
    requested = (op, gradient_predivide_factor, k,
                 average_aggregated_gradients if k > 1 else None,
                 compression, num_groups)
    if getattr(optimizer, "_hvd_wrapped", False):
        # Idempotent when the settings match: the wrapper is named after
        # the wrapped class (for serialization), so users cannot tell an
        # already-wrapped optimizer apart — e.g. after hvd.load_model —
        # and re-wrapping would sync every gradient twice. A re-wrap with
        # DIFFERENT settings cannot be honored: fail loudly.
        if getattr(optimizer, "_hvd_settings", None) != requested:
            raise ValueError(
                "optimizer is already wrapped by DistributedOptimizer "
                "(e.g. by hvd.load_model) with different settings "
                f"({optimizer._hvd_settings} vs requested {requested}); "
                "rebuild the optimizer from its config and wrap once.")
        return optimizer
    if k > 1:
        if op == reduce_ops.Adasum:
            raise ValueError(
                "backward_passes_per_step > 1 with Adasum is unsupported: "
                "Adasum is nonlinear, so per-micro-batch reduction is not "
                "equivalent to aggregate-then-Adasum. Aggregate in the "
                "training loop instead.")
        if getattr(optimizer, "built", False):
            raise ValueError(
                "backward_passes_per_step > 1 requires wrapping the "
                "optimizer before it is built (accumulator slots are "
                "created at build time).")
        current = getattr(optimizer, "gradient_accumulation_steps", None)
        if current not in (None, k):
            raise ValueError(
                f"optimizer already has gradient_accumulation_steps="
                f"{current}, conflicting with backward_passes_per_step={k}")
        optimizer.gradient_accumulation_steps = k
    cls = type(optimizer)
    log = get_logger()
    prescale = (1.0 / gradient_predivide_factor
                if gradient_predivide_factor != 1.0 else 1.0)
    postscale = (gradient_predivide_factor
                 if gradient_predivide_factor != 1.0 else 1.0)

    def _sync_tf(grads):
        # Symbolic under tf.function: route through the TF binding's
        # py_function bridge. None grads (unused variables) pass through.
        from .. import tensorflow as hvd_tf
        from ..ops import sparse as sparse_ops
        tf_mod = hvd_tf._tf()
        result = list(grads)
        grads = list(grads)
        routed = set()
        for i, g in enumerate(grads):
            if not isinstance(g, tf_mod.IndexedSlices):
                continue
            # Explicit sparse handling: with the sparse plane on,
            # embedding grads ride it; otherwise densify HERE, visibly,
            # with a one-time note.
            if sparse_ops.enabled():
                result[i] = hvd_tf._sparse_allreduce_tf(
                    g, op, f"keras_grads.sp{i}", hvd_tf.global_process_set)
                routed.add(i)
            else:
                if not _warned_sparse[0]:
                    _warned_sparse[0] = True
                    log.info("keras DistributedOptimizer: IndexedSlices "
                             "gradients densify before the sync; set "
                             "HVDTPU_SPARSE for the sparse gather plane")
                grads[i] = tf_mod.convert_to_tensor(g)
        dense_idx = [i for i, g in enumerate(grads)
                     if g is not None and i not in routed]
        if not dense_idx:
            return result
        for b, bucket in enumerate(_buckets(len(dense_idx), num_groups)):
            outs = hvd_tf.grouped_allreduce(
                [grads[dense_idx[j]] for j in bucket], op=op,
                name=f"keras_grads.g{b}", compression=compression,
                prescale_factor=prescale, postscale_factor=postscale)
            for j, o in zip(bucket, outs):
                result[dense_idx[j]] = o
        return result

    def _sync(grads):
        if not spmd_active():
            return grads
        if backend == "tensorflow":
            return _sync_tf(grads)
        if backend == "torch":
            return _reduce_torch_grads(grads, op, prescale, postscale,
                                       "keras_grads", compression=compression,
                                       num_groups=num_groups)
        raise RuntimeError(
            f"keras DistributedOptimizer: the {backend!r} keras backend has "
            "no gradient sync on the port (torch or tensorflow)")

    unaveraged = k > 1 and not average_aggregated_gradients

    def _prepare(grads):
        grads = _sync(list(grads))
        if unaveraged:
            # Keras's accumulation engine applies (sum g_i)/k; the
            # reference's average_aggregated_gradients=False applies the
            # raw sum — prescale each micro-batch gradient by k so the
            # division cancels.
            grads = [None if g is None else g * k for g in grads]
        return grads

    class _Distributed(cls):
        _hvd_wrapped = True

        # Only apply() is overridden: keras-3 BaseOptimizer routes every
        # entry point (apply_gradients, stateless_apply, the trainers)
        # through self.apply, so preparing there too would sync/prescale
        # each gradient twice.
        def apply(self, grads, trainable_variables=None, **kwargs):
            grads = _prepare(grads)
            return cls.apply(self, grads, trainable_variables, **kwargs)

    # Serialization round-trip: keras saves the optimizer under its class
    # name. Naming the wrapper after the wrapped class makes saved configs
    # say e.g. "SGD", which stock keras can deserialize — load_model()
    # then re-wraps (the reference's _keras/__init__.py load-model trick).
    _Distributed.__name__ = cls.__name__
    _Distributed.__qualname__ = cls.__qualname__
    _Distributed.__module__ = cls.__module__
    optimizer.__class__ = _Distributed
    optimizer._hvd_settings = requested  # re-wrap guard compares these
    if spmd_active():
        log.info("keras DistributedOptimizer (%s backend) wrapping %s "
                 "over %d ranks", backend, cls.__name__, size())
    return optimizer

"""Keras binding on the port's runtime (port of
``horovod_tpu/keras/__init__.py``; reference: horovod/keras/__init__.py:201
+ horovod/tensorflow/keras/__init__.py). Works with Keras 3's model.fit:
gradients sync across the launcher's ranks inside ``optimizer.apply``.
With ``KERAS_BACKEND=torch`` the model computes on the runtime's device
(the card) and its gradients reach the port's allreduce as torch tensors
there; with ``KERAS_BACKEND=tensorflow`` they go through the TF binding.

    import horovod_tpu_torch.keras as hvd
    hvd.init()                       # before the model: sets the device
    opt = hvd.DistributedOptimizer(keras.optimizers.SGD(0.01 * hvd.size()))
    model.compile(optimizer=opt, ...)
    model.fit(..., callbacks=[
        hvd.callbacks.BroadcastGlobalVariablesCallback(0)])

Keras is imported at the first use, never at import.
"""

import warnings

import numpy as np
import torch

from .. import basics
from ..ops import reduce_ops
from ..ops import collectives as _c
from ..ops.compression import Compression  # noqa: F401
from ..process_sets import global_process_set
from .._keras import (create_distributed_optimizer, rank, size,  # noqa: F401
                      spmd_active)

Average = reduce_ops.Average
Sum = reduce_ops.Sum
Adasum = reduce_ops.Adasum

from . import elastic  # noqa: E402,F401  (hvd.elastic.KerasState)

init = basics.init
shutdown = basics.shutdown
is_initialized = basics.is_initialized
local_rank = basics.local_rank
local_size = basics.local_size
cross_rank = basics.cross_rank
cross_size = basics.cross_size
metrics_snapshot = basics.metrics_snapshot

__all__ = ["init", "shutdown", "rank", "size", "local_rank", "local_size",
           "DistributedOptimizer", "broadcast_global_variables",
           "allreduce", "allgather", "broadcast", "load_model",
           "set_data_parallel", "callbacks"]


def set_data_parallel(devices=None, auto_shard_dataset=True):
    """The JAX package's ``keras.distribution.DataParallel`` over a jax
    device mesh, which compiles model.fit into one XLA program. The port
    has no such mesh: it raises."""
    raise NotImplementedError(
        "set_data_parallel compiles keras model.fit onto a jax device mesh "
        "(the JAX package's path); on the port, run one process per GPU "
        "under `python -m horovod_tpu_torch.runner.launch` and wrap the "
        "optimizer in DistributedOptimizer, whose per-process sync "
        "allreduces the gradients on each rank's device")


def DistributedOptimizer(optimizer, name=None, device_dense="",
                         device_sparse="", compression=None,
                         sparse_as_dense=False, gradient_predivide_factor=1.0,
                         op=Average, backward_passes_per_step=1,
                         average_aggregated_gradients=True):
    """Reference: horovod/keras/__init__.py:36 DistributedOptimizer.
    ``compression`` (Compression.fp16/bf16, or a wire codec) shrinks the
    bytes each sync moves; ``device_dense``/``device_sparse``/
    ``sparse_as_dense`` are the reference's placement and densification
    knobs (the sync runs on the runtime's device, its gradients dense)."""
    import keras
    return create_distributed_optimizer(
        keras, optimizer, name=name, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        backward_passes_per_step=backward_passes_per_step,
        average_aggregated_gradients=average_aggregated_gradients,
        compression=compression)


def broadcast_global_variables(root_rank=0, model=None):
    """Broadcast a model's weights from root_rank (reference:
    horovod/keras/__init__.py broadcast_global_variables).

    Keras 3 has no global-variables registry, so the model must be
    passed explicitly; a silent no-op here would let ranks keep
    divergent initial weights."""
    if model is None:
        raise ValueError(
            "broadcast_global_variables needs the model: pass "
            "model=<keras model>, use callbacks."
            "BroadcastGlobalVariablesCallback(root_rank) in model.fit, or "
            "broadcast the arrays directly with "
            "horovod_tpu_torch.tensorflow.broadcast_arrays.")
    if not spmd_active():
        return
    from ..tensorflow import broadcast_arrays
    model.set_weights(broadcast_arrays(model.get_weights(),
                                       root_rank=root_rank))


def _on_device(value):
    """``value`` as a torch tensor on the runtime's device: a torch tensor
    must already be there; anything else (numpy, a TF tensor) goes through
    numpy."""
    if isinstance(value, torch.Tensor):
        if value.device != basics.device():
            raise ValueError(
                f"a tensor on {value.device}; the runtime computes on "
                f"{basics.device()}")
        return value
    import keras
    from ..tensorflow import _to_torch
    return _to_torch(np.asarray(keras.ops.convert_to_numpy(value)))


def _like(out, value):
    if isinstance(value, torch.Tensor):
        return out
    import keras
    from ..tensorflow import _to_numpy
    return keras.ops.convert_to_tensor(_to_numpy(out))


def allreduce(value, name=None, average=True,
              prescale_factor=1.0, postscale_factor=1.0, op=None,
              compression=None):
    from ..tensorflow import _grouped
    if op is None:
        op = Average if average else Sum
    if not spmd_active():
        return value
    out = _grouped([_on_device(value)], op, name, compression,
                   prescale_factor, postscale_factor,
                   global_process_set)[0]
    return _like(out, value)


def allgather(value, name=None):
    if not spmd_active():
        return value
    return _like(_c.allgather(_on_device(value), name=name), value)


def broadcast(value, root_rank, name=None):
    if not spmd_active():
        return value
    return _like(_c.broadcast(_on_device(value), root_rank, name=name),
                 value)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None, compile=True, **kwargs):  # noqa: A002
    """Load a model and wrap its optimizer (reference:
    horovod/keras/__init__.py:167 load_model, with its positional order:
    ``filepath, custom_optimizers, custom_objects, compression``).
    ``custom_optimizers`` extends the deserializable classes;
    ``compression`` is applied to the re-wrapped optimizer so a model
    trained with wire compression keeps it after reload. A dict passed as
    the second argument (``keras.models.load_model``'s custom_objects)
    warns."""
    import keras
    if isinstance(custom_optimizers, dict):
        warnings.warn(
            "load_model's second argument is custom_optimizers (a list of "
            "optimizer classes), as in horovod; a dict there looks like "
            "custom_objects — pass custom_objects=... by keyword",
            UserWarning, stacklevel=2)
        custom_objects = dict(custom_optimizers, **(custom_objects or {}))
        custom_optimizers = None
    if custom_optimizers:
        custom_objects = dict(custom_objects or {})
        custom_objects.update({cls.__name__: cls
                               for cls in custom_optimizers})
    model = keras.models.load_model(filepath,
                                    custom_objects=custom_objects,
                                    compile=compile, **kwargs)
    if compile and getattr(model, "optimizer", None) is not None:
        model.optimizer = DistributedOptimizer(model.optimizer,
                                               compression=compression)
    return model


class _Callbacks:
    """Lazy namespace: hvd.callbacks.BroadcastGlobalVariablesCallback etc.
    (reference: horovod/_keras/callbacks.py). Created classes are cached
    on the instance so repeated access returns the SAME class
    (isinstance/identity checks must hold)."""

    def __getattr__(self, item):
        from .._keras.callbacks import make_callbacks
        from .._keras.elastic import make_elastic_callbacks
        (bgv, ma, warmup, sched) = make_callbacks()
        (commit, upd_batch, upd_epoch) = make_elastic_callbacks()
        mapping = {
            "BroadcastGlobalVariablesCallback": bgv,
            "MetricAverageCallback": ma,
            "LearningRateWarmupCallback": warmup,
            "LearningRateScheduleCallback": sched,
            "CommitStateCallback": commit,
            "UpdateBatchStateCallback": upd_batch,
            "UpdateEpochStateCallback": upd_epoch,
        }
        if item not in mapping:
            raise AttributeError(item)
        self.__dict__.update(mapping)
        return mapping[item]


callbacks = _Callbacks()

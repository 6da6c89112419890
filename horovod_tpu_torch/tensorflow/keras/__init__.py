"""``horovod_tpu_torch.tensorflow.keras`` — drop-in surface of the
reference's ``horovod.tensorflow.keras`` on the port's runtime (port of
``horovod_tpu/tensorflow/keras/__init__.py``; reference:
horovod/tensorflow/keras/__init__.py:49 DistributedOptimizer, :141-216
collective wrappers/load_model).

``tf.keras`` *is* Keras 3 (TF >= 2.16 re-exports it), so the
implementation is the shared multi-backend binding (.._keras): gradients
sync on the runtime's device for the torch backend and through the TF
binding for the tensorflow backend. This module exists so reference
scripts written against ``import horovod.tensorflow.keras as hvd`` keep
working verbatim.
"""

from ... import basics
from ...ops import reduce_ops
from ...ops.compression import Compression  # noqa: F401
from ...process_sets import (ProcessSet, global_process_set,  # noqa: F401
                             add_process_set, remove_process_set)
from ..._keras import create_distributed_optimizer, rank, size, spmd_active
from .. import (start_timeline, stop_timeline)  # noqa: F401
from ...keras import (set_data_parallel, load_model,  # noqa: F401
                      allreduce, allgather, broadcast,
                      broadcast_global_variables)
from . import callbacks  # noqa: F401
from . import elastic  # noqa: F401

Average = reduce_ops.Average
Sum = reduce_ops.Sum
Adasum = reduce_ops.Adasum

init = basics.init
shutdown = basics.shutdown
is_initialized = basics.is_initialized
local_rank = basics.local_rank
local_size = basics.local_size
cross_rank = basics.cross_rank
cross_size = basics.cross_size
mpi_enabled = basics.mpi_enabled
gloo_enabled = basics.gloo_enabled
nccl_built = basics.nccl_built

__all__ = ["init", "shutdown", "rank", "size", "local_rank", "local_size",
           "cross_rank", "cross_size", "DistributedOptimizer",
           "broadcast_global_variables", "allreduce", "allgather",
           "broadcast", "load_model", "set_data_parallel", "callbacks",
           "elastic", "Compression", "Average", "Sum", "Adasum"]


def DistributedOptimizer(optimizer, name=None,
                         device_dense="", device_sparse="",
                         compression=None,
                         sparse_as_dense=False,
                         gradient_predivide_factor=1.0,
                         op=Average,
                         backward_passes_per_step=1,
                         average_aggregated_gradients=False,
                         num_groups=0,
                         groups=None,
                         process_set=global_process_set):
    """Reference: horovod/tensorflow/keras/__init__.py:49 (full kwarg
    surface, including the reference's num_groups→groups deprecation).

    ``compression`` shrinks the bytes each sync moves.
    ``device_dense``/``device_sparse`` are TF device placement in the
    reference; the sync runs on the runtime's device. ``sparse_as_dense``
    likewise (the sync plane always densifies). ``num_groups`` (or an
    integer ``groups``) splits each sync into that many fusion buckets
    — one grouped collective per bucket; the list-of-variable-lists
    ``groups`` spelling needs the variable identities at sync time,
    which the keras-3 apply path does not expose — use
    horovod_tpu_torch.tensorflow.DistributedOptimizer for that spelling.
    """
    import warnings
    import keras
    if op not in (Average, Sum, Adasum):
        raise ValueError("op currently only supports Average, Sum, Adasum")
    if num_groups != 0:
        warnings.warn("Parameter `num_groups` has been replaced by "
                      "`groups` (reference deprecation).",
                      DeprecationWarning)
        if groups is None:
            groups = num_groups
    if groups is not None and not (isinstance(groups, list) or groups > 0):
        raise ValueError("groups should be a non-negative integer or a "
                         "list of lists of variables.")
    if isinstance(groups, list):
        raise NotImplementedError(
            "the list-of-variable-lists `groups` spelling is not "
            "supported on the keras-3 apply path (variable identities "
            "are not visible at sync time); pass an integer bucket "
            "count, or use horovod_tpu_torch.tensorflow.DistributedOptimizer "
            "which supports explicit variable groups.")
    if process_set is not global_process_set:
        raise NotImplementedError(
            "keras DistributedOptimizer syncs over the global process "
            "set; build per-set training loops with "
            "horovod_tpu_torch.tensorflow.DistributedOptimizer instead.")
    return create_distributed_optimizer(
        keras, optimizer, name=name, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        backward_passes_per_step=backward_passes_per_step,
        average_aggregated_gradients=average_aggregated_gradients,
        compression=compression, num_groups=int(groups or 0))

"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Same API shape as the JAX package, written in PyTorch for NVIDIA Hopper:
``init()`` picks ``cuda:<local_rank>``; eager and async collectives on any
process set go through the ``Coordinator``, which in a launcher job has
the native core (``csrc/core/``) negotiate and fuse named tensors and NCCL
or the native TCP ring execute them; ``DistributedOptimizer`` wraps a
``torch.optim.Optimizer``; the attention kernels are hand-written CUDA
(``ops/flash_attention.py``, ``csrc/``). Horovod's
PyTorch API is ``horovod_tpu_torch.torch``. The package imports neither JAX
nor anything of ``horovod_tpu``.
"""

from .basics import (cross_rank, cross_size, device, init, is_initialized,
                     local_rank, local_size, metrics_snapshot, rank,
                     shutdown, size)
from . import elastic  # noqa: F401  (hvd.elastic.run / State / ObjectState)
from .exceptions import (CheckpointCorruptError, CollectiveAbortError,
                         CollectiveMismatchError, DuplicateNameError,
                         HorovodInternalError, HostsUpdatedInterrupt,
                         NotInitializedError, StalledTensorError)
from .functions import (allgather_object, broadcast_object,
                        broadcast_optimizer_state, broadcast_parameters,
                        broadcast_variables)
from .ops.collectives import (
    allgather, allgather_async, allreduce, allreduce_, allreduce_async,
    allreduce_async_, alltoall, alltoall_async, barrier, broadcast,
    broadcast_, broadcast_async, broadcast_async_, grouped_allgather,
    grouped_allgather_async, grouped_allreduce, grouped_allreduce_,
    grouped_allreduce_async, grouped_allreduce_async_, grouped_reducescatter,
    grouped_reducescatter_async, join, poll, reducescatter,
    reducescatter_async, synchronize)
from .ops.compression import Compression
from .ops.reduce_ops import Adasum, Average, Max, Min, Product, Sum
from .ops.sparse import (SparseGradient, sparse_allreduce,
                         sparse_allreduce_async)
from .process_sets import (ProcessSet, add_process_set, global_process_set,
                           process_set_by_id, remove_process_set)
from .train import (DistributedOptimizer, make_train_step,
                    make_zero_train_step)
from .version import __version__


def __getattr__(name):
    # horovod_tpu_torch.run(func, num_proc=N): the reference's programmatic
    # launcher (horovod/runner/__init__.py:92 ``horovod.run``). Lazy, so
    # that importing the package never imports the runner.
    if name == "run":
        from .runner import run
        return run
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

"""``horovod_tpu_torch.torch``: the ``horovod_tpu.torch`` namespace that user
scripts import as ``hvd`` (``examples/pytorch_bert_benchmark.py``).

This slice carries the runtime calls and the bridge entry point. The
reference torch API of handles, async ops and the grad-hook
``DistributedOptimizer`` is not ported yet (ROADMAP queue A, item 7).
"""

from ..basics import init, local_rank, rank, shutdown, size
from ..functions import broadcast_optimizer_state, broadcast_parameters
from .compile import tpu_compile

__all__ = ["init", "shutdown", "rank", "size", "local_rank",
           "broadcast_parameters", "broadcast_optimizer_state",
           "tpu_compile"]

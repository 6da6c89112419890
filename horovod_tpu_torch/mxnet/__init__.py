"""MXNet binding on the port's runtime (port of
``horovod_tpu/mxnet/__init__.py``; reference: horovod/mxnet/__init__.py:42
``DistributedOptimizer``, ``broadcast_parameters``).

MXNet is archived upstream and installed neither here nor on the GPU
machines; every entry point that touches an NDArray imports mxnet at the
use and raises ``ImportError`` without it. The surface mirrors the
reference, so that a legacy script fails with guidance rather than an
AttributeError, and runs where a user installs mxnet: an NDArray goes to
numpy, to a torch tensor on the runtime's device (the card in a GPU job),
through the port's collectives, and back.
"""

import numpy as np
import torch

from .. import basics
from ..ops import collectives as _c
from ..ops import reduce_ops

Average = reduce_ops.Average
Sum = reduce_ops.Sum

init = basics.init
shutdown = basics.shutdown
is_initialized = basics.is_initialized
local_rank = basics.local_rank
local_size = basics.local_size
rank = basics.rank
size = basics.size


def _mxnet():
    try:
        import mxnet
        return mxnet
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.mxnet requires mxnet, which is not installed "
            "(MXNet is archived upstream); `pip install mxnet` to use this "
            "legacy binding, or port the script to "
            "horovod_tpu_torch.torch") from e


def _on_device(array):
    return torch.from_numpy(np.ascontiguousarray(array)).to(basics.device())


def _allreduce_np(array, op, name):
    out = _c.allreduce(_on_device(array), op=op, name=name)
    return out.cpu().numpy()


def allreduce(tensor, average=True, name=None, priority=0):
    """Reference: horovod/mxnet/mpi_ops.py allreduce."""
    mx = _mxnet()
    out = _allreduce_np(tensor.asnumpy(), Average if average else Sum, name)
    return mx.nd.array(out, ctx=tensor.context, dtype=tensor.dtype)


def broadcast_parameters(params, root_rank=0):
    """Reference: horovod/mxnet/__init__.py:226 broadcast_parameters.
    Accepts NDArray dicts and gluon ParameterDicts (``Block.collect_params()``
    values are Parameter objects read through ``.data()`` and written
    through ``.set_data()``, reference :255)."""
    mx = _mxnet()
    from ..functions import broadcast_parameters as broadcast
    items = sorted(params.items()) if hasattr(params, "items") \
        else sorted(params)

    def read(v):
        return v.data().asnumpy() if hasattr(v, "set_data") else v.asnumpy()

    tensors = {name: _on_device(read(v)) for name, v in items}
    broadcast(tensors, root_rank=root_rank)
    for name, v in items:
        out = tensors[name].cpu().numpy()
        if hasattr(v, "set_data"):
            v.set_data(mx.nd.array(out, dtype=out.dtype))
        else:
            v[:] = out


def DistributedOptimizer(optimizer):
    """Wrap an mxnet optimizer so that ``update()`` averages the gradient
    across ranks first (reference: horovod/mxnet/__init__.py:42)."""
    mx = _mxnet()

    class _Distributed(mx.optimizer.Optimizer):
        """Two-way proxy: reads and writes go to the inner optimizer (the
        gluon Trainer sets rescale_grad and lr on it every step)."""

        def __init__(self, opt):
            self.__dict__["_opt"] = opt

        def __getattr__(self, item):
            return getattr(self.__dict__["_opt"], item)

        def __setattr__(self, key, value):
            setattr(self.__dict__["_opt"], key, value)

        def _reduce(self, index, grad):
            grad[:] = _allreduce_np(grad.asnumpy(), Average, f"grad.{index}")

        def update(self, index, weight, grad, state):
            self._reduce(index, grad)
            return self._opt.update(index, weight, grad, state)

        def update_multi_precision(self, index, weight, grad, state):
            # The gluon Trainer calls this, not update() (reference:
            # horovod/mxnet/__init__.py:92).
            self._reduce(index, grad)
            return self._opt.update_multi_precision(index, weight, grad,
                                                    state)

    return _Distributed(optimizer)

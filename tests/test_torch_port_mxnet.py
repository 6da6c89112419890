"""The MXNet binding on the port (``horovod_tpu_torch/mxnet/``): the gate of
tests/test_cluster.py (mxnet is installed neither here nor on the GPU
machines), the JAX package's public surface, and the binding's paths
through an in-process fake of the small part of mxnet it touches (NDArray's
``asnumpy``/``context``/``dtype``/slice assignment, ``nd.array``, gluon's
``Parameter.data``/``set_data``, ``optimizer.Optimizer``) on a one-rank
CPU runtime, where every reduction is the identity.
"""

import sys
import types

import numpy as np
import pytest

import horovod_tpu.mxnet as jmx
import horovod_tpu_torch as hvd
import horovod_tpu_torch.mxnet as tmx


class _ND:
    def __init__(self, a, ctx="cpu(0)", dtype=None):
        self.a = np.array(a, dtype=dtype)
        self.context, self.dtype = ctx, self.a.dtype

    def asnumpy(self):
        return self.a.copy()

    def __setitem__(self, idx, value):
        self.a[idx] = np.asarray(value)


class _Param:
    def __init__(self, a):
        self.nd = _ND(a)

    def data(self):
        return self.nd

    def set_data(self, nd):
        self.nd = nd


class _SGD:
    def __init__(self):
        self.lr, self.rescale_grad, self.seen = 0.1, 1.0, []

    def update(self, index, weight, grad, state):
        self.seen.append(("update", index, grad.asnumpy().tolist()))

    def update_multi_precision(self, index, weight, grad, state):
        self.seen.append(("mp", index, grad.asnumpy().tolist()))


@pytest.fixture
def fake_mxnet(monkeypatch):
    mx = types.ModuleType("mxnet")
    mx.nd = types.SimpleNamespace(
        array=lambda a, ctx="cpu(0)", dtype=None: _ND(a, ctx, dtype))
    mx.optimizer = types.SimpleNamespace(Optimizer=object)
    monkeypatch.setitem(sys.modules, "mxnet", mx)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield mx
    hvd.shutdown()


def test_mxnet_adapter_gates_without_mxnet():
    try:
        import mxnet  # noqa: F401
        pytest.skip("mxnet installed; gate not applicable")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="mxnet"):
        tmx.allreduce(None)
    with pytest.raises(ImportError, match="mxnet"):
        tmx.DistributedOptimizer(None)


def test_the_jax_bindings_public_surface_exists():
    public = {n for n in dir(jmx) if not n.startswith("_")
              and not isinstance(getattr(jmx, n), types.ModuleType)}
    assert public <= set(dir(tmx))


def test_allreduce_and_broadcast_on_a_one_rank_runtime(fake_mxnet):
    x = _ND(np.arange(6, dtype=np.float32).reshape(2, 3), ctx="gpu(0)")
    for average in (True, False):
        out = tmx.allreduce(x, average=average, name=f"ar.{average}")
        assert out.context == "gpu(0)" and out.dtype == np.float32
        np.testing.assert_array_equal(out.asnumpy(), x.asnumpy())
    params = {"w": _ND(np.ones(3, np.float64)),
              "b": _Param(np.full(2, 7, np.int64))}
    tmx.broadcast_parameters(params, root_rank=0)
    np.testing.assert_array_equal(params["w"].asnumpy(), np.ones(3))
    assert params["b"].data().dtype == np.int64
    np.testing.assert_array_equal(params["b"].data().asnumpy(), [7, 7])


def test_distributed_optimizer_reduces_then_updates(fake_mxnet):
    inner = _SGD()
    opt = tmx.DistributedOptimizer(inner)
    opt.lr = 0.5                      # writes reach the inner optimizer
    assert inner.lr == 0.5 and opt.rescale_grad == 1.0
    g = _ND(np.array([1.0, -2.0], np.float32))
    opt.update(3, None, g, None)
    opt.update_multi_precision(4, None, g, None)
    assert inner.seen == [("update", 3, [1.0, -2.0]),
                          ("mp", 4, [1.0, -2.0])]

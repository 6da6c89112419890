"""The port's Adasum (``horovod_tpu_torch/ops/adasum.py``) against the JAX
package's, on the CPU.

Inputs come from a numpy seed. Tolerances: the float32 tree equals the JAX
package's float32 tree and the float64 VHDD oracle within 1e-5 relative
(float32 dot products over a few thousand elements); the copied numpy
oracles equal the JAX package's exactly. Odd rank counts raise with the
JAX package's message. At size 1, ``op=Adasum`` through the binding and
the optimizers is the identity (VHDD over one rank returns its input).
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
import horovod_tpu_torch.torch as pt
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu_torch import train
from horovod_tpu_torch.ops import adasum


def _stack(n, shape, seed):
    rng = np.random.RandomState(seed)
    # Correlated ranks, so that the coefficients are far from 1.
    base = rng.randn(*shape)
    return np.stack([base + 0.5 * rng.randn(*shape) * (r + 1)
                     for r in range(n)]).astype(np.float32)


@pytest.mark.parametrize("shape", [(1,), (7, 9), (3, 5, 64)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_tree_equals_the_jax_package_and_the_vhdd_oracle(n, shape):
    import jax.numpy as jnp
    x = _stack(n, shape, seed=n + len(shape))
    got = adasum.adasum_tree(torch.from_numpy(x))
    assert got.shape == shape and got.dtype == torch.float32
    want = np.asarray(jadasum.adasum_tree(jnp.asarray(x)))
    oracle = jadasum.adasum_vhdd_np(list(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-6)


def test_zero_norm_side_takes_coefficient_one():
    import jax.numpy as jnp
    a = np.zeros(6, np.float32)
    b = np.arange(6, dtype=np.float32)
    for x, y in ((a, b), (b, a), (a, a)):
        got = adasum.adasum_pair(torch.from_numpy(x), torch.from_numpy(y))
        want = jadasum.adasum_pair(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            adasum.adasum_pair_np(x, y), jadasum.adasum_pair_np(x, y))


def test_bf16_inputs_keep_their_dtype_as_in_the_jax_package():
    import jax.numpy as jnp
    x = _stack(2, (64,), seed=3)
    got = adasum.adasum_tree(torch.from_numpy(x).to(torch.bfloat16))
    want = jadasum.adasum_tree(jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_numpy_oracles_are_the_jax_package_copies(n):
    x = _stack(n, (33,), seed=11)
    np.testing.assert_array_equal(adasum.adasum_vhdd_np(x),
                                  jadasum.adasum_vhdd_np(x))


@pytest.mark.parametrize("n", [3, 5, 6, 12])
def test_sizes_that_are_no_power_of_two_raise_as_in_the_jax_package(n):
    import jax.numpy as jnp
    x = _stack(n, (4,), seed=1)
    with pytest.raises(ValueError) as want:
        jadasum.adasum_tree(jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        adasum.adasum_tree(torch.from_numpy(x))
    assert str(got.value) == str(want.value)


def test_adasum_at_size_one_is_the_identity():
    thvd.shutdown()
    thvd.init(device="cpu")
    try:
        xs = [torch.from_numpy(_stack(1, (5, 3), seed=s)[0]) for s in (1, 2)]
        assert torch.equal(pt.allreduce(xs[0], op=pt.Adasum, name="a"), xs[0])
        got = pt.grouped_allreduce(xs, op=pt.Adasum, name="g")
        assert all(torch.equal(g, x) for g, x in zip(got, xs))
        for wrap in (lambda o: train.DistributedOptimizer(o, op=pt.Adasum),
                     lambda o: pt.DistributedOptimizer(o, op=pt.Adasum)):
            p = torch.nn.Parameter(torch.ones(4))
            opt = wrap(torch.optim.SGD([p], lr=0.5))
            (p * torch.arange(4.0)).sum().backward()
            opt.step()
            assert torch.equal(p.detach(), 1 - 0.5 * torch.arange(4.0))
    finally:
        thvd.shutdown()

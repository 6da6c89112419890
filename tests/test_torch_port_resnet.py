"""The port's ResNet, MLP and MnistCNN against the JAX package's flax models,
and the port's ``make_train_step(has_aux=True)`` against JAX
``make_train_step(..., has_aux=True)``, from the same flax weights (carried
across by the converters) on the same numpy inputs made from a seed, on
the CPU in float32.

Tolerances: logits and batch statistics within 1e-4 of their largest
magnitude (the two packages sum the same fp32 terms in another order,
~1e-6 relative per layer through up to 50 layers); after 3 SGD steps at lr
0.1, losses 1e-5 and parameters and statistics 1e-4 of their largest
magnitude.

At initialisation the last BatchNorm of each block has scale 0, so the
block's main branch reaches the logits only through the batch statistics
(which are compared). A second test draws the BatchNorm scales and biases
at random: there flax's own float32 rounding over ResNet-50's depth is
~5e-4 of the largest logit, measured against a float64 run of the port,
so the port is held to be at least as close to that float64 run as flax
is, and within 2e-3 of flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu import models as jmodels
from horovod_tpu.models import resnet as jresnet
from horovod_tpu_torch.models import mlp as tmlp
from horovod_tpu_torch.models import resnet as tresnet

TOL = 1e-4


@pytest.fixture
def port():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _images(n=4, hw=32, c=3, seed=0):
    return np.random.RandomState(seed).uniform(
        size=(n, hw, hw, c)).astype(np.float32)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


def _random_bn(variables, seed=1):
    """Draw every BatchNorm scale and bias at random."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            return 1.0 + 0.2 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        if name == "bias" and leaf.ndim == 1 and any(
                "BatchNorm" in p.key or p.key in ("bn_init", "norm_proj")
                for p in path):
            return 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        return np.asarray(leaf)
    params = jax.tree_util.tree_map_with_path(draw, variables["params"])
    return {**jax.device_get(variables), "params": params}


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-12)
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} * {scale}"


def _stats_after(variables, updates):
    return tresnet.params_from_flax(jax.device_get(
        {"params": variables["params"], **updates}))


def _check_stats(model, want):
    sd = model.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            _assert_close(sd[k].numpy(), v.numpy(), TOL, k)


@pytest.mark.parametrize("arch,kw", [
    ("ResNet18", {}),
    ("ResNet50", dict(num_filters=8)),
])
@pytest.mark.parametrize("stem", ["conv", "space_to_depth"])
def test_train_forward_and_batch_stats_match_flax(arch, kw, stem):
    x = _images()
    jm = getattr(jmodels, arch)(num_classes=10, dtype=jnp.float32,
                                stem=stem, **kw)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    want, updates = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    model = getattr(tresnet, arch)(num_classes=10, dtype=torch.float32,
                                   stem=stem, **kw)
    model.load_state_dict(tresnet.params_from_flax(variables))
    got = model(_nchw(x))
    _assert_close(got.detach().numpy(), want, TOL, "logits")
    _check_stats(model, _stats_after(variables, updates))
    # Eval mode normalises with the running statistics, as flax does.
    want_eval = jm.apply({"params": variables["params"], **updates},
                         jnp.asarray(x), train=False)
    model.eval()
    _assert_close(model(_nchw(x)).detach().numpy(), want_eval, TOL,
                  "eval logits")


@pytest.mark.parametrize("arch,kw", [
    ("ResNet18", {}),
    ("ResNet50", dict(num_filters=8)),
])
def test_random_batchnorm_logits_match_flax(arch, kw):
    x = _images(n=16)
    jm = getattr(jmodels, arch)(num_classes=10, dtype=jnp.float32, **kw)
    variables = _random_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want, _ = jm.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    got = {}
    for dtype in (torch.float32, torch.float64):
        model = getattr(tresnet, arch)(num_classes=10, dtype=dtype, **kw)
        model.load_state_dict(tresnet.params_from_flax(variables))
        with torch.no_grad():
            got[dtype] = model.to(dtype)(_nchw(x).to(dtype)).numpy()
    exact, want = got[torch.float64], np.asarray(want, np.float64)
    scale = np.abs(exact).max()
    port_err = np.abs(got[torch.float32] - exact).max() / scale
    flax_err = np.abs(want - exact).max() / scale
    assert port_err <= max(flax_err, TOL), (port_err, flax_err)
    _assert_close(got[torch.float32], want, 2e-3, "logits")


def test_same_padding_is_asymmetric_on_stride_two():
    # flax "SAME": a 3x3 stride-2 window over an even size pads (0, 1).
    assert tresnet.same_pads((32, 31), (3, 3), (2, 2)) == ((0, 1), (1, 1))
    assert tresnet.same_pads((8, 8), (1, 1), (2, 2)) == ((0, 0), (0, 0))
    assert tresnet.same_pads((8, 8), (3, 3), (1, 1)) == ((1, 1), (1, 1))


def test_stem_weights_to_space_to_depth_matches_the_jax_package():
    w7 = np.random.RandomState(0).standard_normal((7, 7, 3, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tresnet.stem_weights_to_space_to_depth(w7),
        jresnet.stem_weights_to_space_to_depth(w7))


def test_space_to_depth_stem_equals_the_conv_stem():
    x = _images(n=2)
    model = tresnet.ResNet18(num_classes=10, dtype=torch.float32,
                             num_filters=8,
                             generator=torch.Generator().manual_seed(0))
    s2d = tresnet.ResNet18(num_classes=10, dtype=torch.float32,
                           num_filters=8, stem="space_to_depth")
    sd = model.state_dict()
    w7 = sd["conv_init.weight"].permute(2, 3, 1, 0).numpy()   # HWIO
    w4 = tresnet.stem_weights_to_space_to_depth(w7)
    sd["conv_init.weight"] = torch.tensor(w4).permute(3, 2, 0, 1)
    s2d.load_state_dict(sd)
    with torch.no_grad():
        _assert_close(s2d(_nchw(x)).numpy(), model(_nchw(x)).numpy(), TOL,
                      "space-to-depth stem")


def _flax_loss(jm):
    def loss_fn(p, aux, batch):
        bx, by = batch
        logits, updates = jm.apply({"params": p, **aux}, bx,
                                   mutable=list(aux.keys()))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, by).mean(), updates
    return loss_fn


def _port_loss(model, batch):
    x, y = batch
    return torch.nn.functional.cross_entropy(model(x), y)


def test_three_sgd_steps_match_jax_make_train_step_with_aux(hvd, port):
    # 8 images, one per device of the 8-device mesh. The flax model gets
    # axis_name, so that its statistics span the global batch, as the
    # port's size-1 step computes them.
    import horovod_tpu.jax as hvd_jax
    x = _images(n=8)
    y = np.random.RandomState(1).randint(0, 10, size=8)
    jm = jmodels.ResNet18(num_classes=10, dtype=jnp.float32, num_filters=8,
                          axis_name=hvd_jax.HVD_AXIS)
    init = jmodels.ResNet18(num_classes=10, dtype=jnp.float32,
                            num_filters=8)
    variables = jax.device_get(init.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    model = tresnet.ResNet18(num_classes=10, dtype=torch.float32,
                             num_filters=8)
    model.load_state_dict(tresnet.params_from_flax(variables))

    jopt = hvd_jax.DistributedOptimizer(optax.sgd(0.1))
    jstep = hvd_jax.make_train_step(_flax_loss(jm), jopt, has_aux=True)
    params = variables["params"]
    aux = {"batch_stats": variables["batch_stats"]}
    state = jopt.init(params)
    step = port.make_train_step(_port_loss, port.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1)), has_aux=True)
    batch = (_nchw(x), torch.as_tensor(y))
    for _ in range(3):
        params, aux, state, jl = jstep(params, aux, state,
                                       (jnp.asarray(x), jnp.asarray(y)))
        loss = step(model, batch)
        np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5,
                                   rtol=1e-5)
    want = tresnet.params_from_flax(jax.device_get({"params": params,
                                                    **aux}))
    sd = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            _assert_close(sd[k].numpy(), v.numpy(), TOL, k)
    assert all(int(v) == 3 for k, v in sd.items()
               if k.endswith("num_batches_tracked"))


def _unremat(sd):
    """flax's nn.remat names a block ``Checkpoint<Block>_<i>``; the port's
    block keeps its name."""
    return {k.replace("CheckpointBasicBlock_", "BasicBlock_"): v
            for k, v in sd.items()}


@pytest.mark.parametrize("sync", [False, True], ids=["local", "process_set"])
@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_train_steps_match_flax_and_move_statistics_once(
        hvd, port, remat, sync):
    # flax nn.remat keeps the forward's batch_stats and drops the
    # recompute's; the port's remat blocks must move the running
    # statistics once per step too, with a process set as without (there
    # the recompute reuses the forward's sums). 3 SGD steps against JAX
    # make_train_step with the same remat; then the train-mode logits and
    # the statistics, within TOL of their largest magnitude.
    import horovod_tpu.jax as hvd_jax
    x = _images(n=8)
    y = np.random.RandomState(1).randint(0, 10, size=8)
    jm = jmodels.ResNet18(num_classes=10, dtype=jnp.float32, num_filters=8,
                          axis_name=hvd_jax.HVD_AXIS, remat=remat)
    variables = jax.device_get(jmodels.ResNet18(
        num_classes=10, dtype=jnp.float32, num_filters=8,
        remat=remat).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    model = tresnet.ResNet18(
        num_classes=10, dtype=torch.float32, num_filters=8, remat=remat,
        process_set=port.global_process_set if sync else None)
    model.load_state_dict(_unremat(tresnet.params_from_flax(variables)))
    jopt = hvd_jax.DistributedOptimizer(optax.sgd(0.1))
    jstep = hvd_jax.make_train_step(_flax_loss(jm), jopt, has_aux=True)
    params = variables["params"]
    aux = {"batch_stats": variables["batch_stats"]}
    state = jopt.init(params)
    step = port.make_train_step(_port_loss, port.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1)), has_aux=True)
    batch = (_nchw(x), torch.as_tensor(y))
    for _ in range(3):
        params, aux, state, jl = jstep(params, aux, state,
                                       (jnp.asarray(x), jnp.asarray(y)))
        loss = step(model, batch)
        np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5,
                                   rtol=1e-5)
    want = _unremat(tresnet.params_from_flax(jax.device_get(
        {"params": params, **aux})))
    sd = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            _assert_close(sd[k].numpy(), v.numpy(), TOL, k)
    assert all(int(v) == 3 for k, v in sd.items()
               if k.endswith("num_batches_tracked"))
    jlogits, _ = jmodels.ResNet18(
        num_classes=10, dtype=jnp.float32, num_filters=8,
        remat=remat).apply({"params": params, **aux}, jnp.asarray(x),
                           train=True, mutable=["batch_stats"])
    with torch.no_grad():
        _assert_close(model(_nchw(x)).numpy(), jlogits, TOL, "logits")


def test_mnist_cnn_forward_matches_flax():
    x = _images(n=4, hw=28, c=1)
    jm = jmodels.MnistCNN()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = tmlp.MnistCNN()
    model.load_state_dict(tmlp.mnist_cnn_params_from_flax(
        jax.device_get(variables)))
    with torch.no_grad():
        got = model(_nchw(x))
    _assert_close(got.numpy(), jm.apply(variables, jnp.asarray(x)), TOL,
                  "MnistCNN logits")


def test_mlp_forward_matches_flax():
    x = _images(n=4, hw=28, c=1)
    jm = jmodels.MLP()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = tmlp.MLP(in_features=28 * 28)
    model.load_state_dict(tmlp.mlp_params_from_flax(
        jax.device_get(variables)))
    with torch.no_grad():
        got = model(_nchw(x))
    _assert_close(got.numpy(), jm.apply(variables, jnp.asarray(x)), TOL,
                  "MLP logits")


def test_batchnorm_keeps_flax_biased_running_variance():
    bn = tresnet.BatchNorm(3)
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    bn(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))

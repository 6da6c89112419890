"""Port training step against the JAX package's: 3 AdamW steps of the port
(size 1, loopback, CPU) against 3 steps of JAX ``make_train_step`` with
``DistributedOptimizer(optax.adamw(1e-4))`` on the 8-device CPU mesh, from
the same flax weights on the same batch. Also: the reduction through the
coordinator is bit-identical to the per-tensor one (the contract of
tests/test_overlap.py) and is one grouped submission, the identity in a
single-process job, and local accumulation equals one step on the whole
batch.

Tolerances: losses 1e-5 and parameters 2e-6. fp32 throughout; the
gradients differ only by summation order (~1e-6 relative, see
test_torch_port_transformer.py), and Adam divides by sqrt(v), so an update
differs by ~lr * 1e-5 -- far below 2e-6 after 3 steps at lr 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.models import TransformerConfig as JConfig
from horovod_tpu.models import TransformerLM as JLM
from horovod_tpu_torch import basics, train
from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                      params_from_flax)

SMALL = dict(vocab_size=128, hidden=64, layers=2, heads=4, max_len=16,
             causal=True, use_rope=True)
BATCH = 8   # one sample per device of the 8-device mesh
STEPS = 3


@pytest.fixture
def port():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, SMALL["vocab_size"], size=(BATCH, SMALL["max_len"]))
    y = rng.randint(0, SMALL["vocab_size"], size=(BATCH, SMALL["max_len"]))
    return x, y


def _flax_params(jmodel, x):
    return jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))


def _loss_fn(model, batch):
    x, y = batch
    logits = model(x)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1))


def _port_model(params, cfg):
    model = TransformerLM(cfg)
    model.load_state_dict(params_from_flax(jax.device_get(params), cfg))
    return model


def _adamw(model):
    # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4.
    return torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def test_three_steps_match_jax_make_train_step(hvd, port):
    import horovod_tpu.jax as hvd_jax
    jmodel = JLM(JConfig(**SMALL, dtype=jnp.float32))
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    x, y = _data()
    params = _flax_params(jmodel, x)
    model = _port_model(params, cfg)

    def jloss(p, batch):
        bx, by = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            jmodel.apply(p, bx), by).mean()

    jopt = hvd_jax.DistributedOptimizer(optax.adamw(1e-4))
    jstep = hvd_jax.make_train_step(jloss, jopt)
    jstate = jopt.init(params)
    step = port.make_train_step(_loss_fn, port.DistributedOptimizer(
        _adamw(model)))
    batch = (torch.as_tensor(x), torch.as_tensor(y))
    for _ in range(STEPS):
        params, jstate, jl = jstep(params, jstate,
                                   (jnp.asarray(x), jnp.asarray(y)))
        loss = step(model, batch)
        np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5,
                                   rtol=1e-5)
    want = params_from_flax(jax.device_get(params), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-6, rtol=2e-6, err_msg=name)


def _as_launcher_job(monkeypatch):
    # The loopback backend behind a runtime that says "spmd": the
    # optimizer then reduces through the coordinator as in a launcher job,
    # while the reduction over one rank stays the scaling alone.
    monkeypatch.setattr(basics.runtime(), "mode", basics.MODE_SPMD)


def test_bucketed_reduction_is_bit_identical(port, monkeypatch):
    # DistributedOptimizer reduces every gradient in one grouped submission
    # that the coordinator fuses; a hand-written loop reduces each gradient
    # on its own. Both must agree bit for bit.
    _as_launcher_job(monkeypatch)
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    x, y = _data()
    batch = (torch.as_tensor(x), torch.as_tensor(y))
    scales = dict(prescale_factor=0.5, postscale_factor=3.0)
    runs = {}
    for fused in (False, True):
        model = TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
        opt = _adamw(model)
        if fused:
            step = thvd.make_train_step(
                _loss_fn, thvd.DistributedOptimizer(opt, **scales))
            losses = [step(model, batch).item() for _ in range(STEPS)]
        else:
            losses = []
            for _ in range(STEPS):
                loss = _loss_fn(model, batch)
                loss.backward()
                for p in model.parameters():
                    thvd.allreduce_(p.grad, op=thvd.Average, **scales)
                opt.step()
                opt.zero_grad()
                losses.append(loss.item())
        runs[fused] = (losses, [p.detach().clone()
                                for p in model.parameters()])
    assert runs[False][0] == runs[True][0]
    for a, b in zip(runs[False][1], runs[True][1]):
        assert torch.equal(a, b)


def test_size_one_reduction_scales_without_packing(port, monkeypatch):
    # The optimizer packs nothing itself: in a launcher job it submits the
    # gradients as one grouped allreduce named "grad" (the coordinator
    # fuses), which applies the scales; in a single-process job the
    # reduction is the identity (the JAX package's _reduce).
    coord = basics.runtime().coordinator
    params = [torch.nn.Parameter(torch.zeros(2, 3)),
              torch.nn.Parameter(torch.zeros(4))]
    want = [torch.arange(6.0).reshape(2, 3), torch.ones(4)]
    for mode, factor in ((basics.MODE_SINGLE, 1.0),
                         (basics.MODE_SPMD, 1.5)):
        monkeypatch.setattr(basics.runtime(), "mode", mode)
        for p, g in zip(params, want):
            p.grad = g.clone()
        opt = train.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1), prescale_factor=0.5,
            postscale_factor=3.0)
        before = coord.submitted
        opt.synchronize()
        assert coord.submitted - before == (mode == basics.MODE_SPMD)
        for p, g in zip(params, want):
            assert torch.equal(p.grad, factor * g)


def test_local_accumulation_equals_one_step_on_the_whole_batch(port):
    # SGD: the update is linear in the gradient, so summation order is the
    # only difference (Adam would magnify it on near-zero gradients).
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    x, y = (torch.as_tensor(a) for a in _data())
    models = {}
    for k, batches in ((1, [(x, y)]), (2, [(x[:4], y[:4]), (x[4:], y[4:])])):
        model = TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.5),
            backward_passes_per_step=k)
        step = thvd.make_train_step(_loss_fn, opt)
        for batch in batches:
            step(model, batch)
        models[k] = model
    for a, b in zip(models[1].parameters(), models[2].parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kwargs,env", [
    ({}, {"HVDTPU_ZERO": "1"}),
])
def test_unported_optimizer_modes_raise(kwargs, env, monkeypatch):
    # HVDTPU_ZERO raised NotImplementedError until ZeRO-1 was ported; the
    # knob now selects the sharded update (tests/test_torch_port_zero.py),
    # as zero=True does, and zero=False overrides it.
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = train.DistributedOptimizer(torch.optim.SGD([p], lr=0.1), **kwargs)
    assert opt.zero and opt._zero_rt is not None
    assert not train.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                          zero=False).zero
    monkeypatch.delenv("HVDTPU_ZERO")
    assert not train.DistributedOptimizer(torch.optim.SGD([p], lr=0.1)).zero


@pytest.mark.parametrize("kwargs,error", [
    ({"op": thvd.Adasum, "compression": thvd.Compression.int8},
     "Average/Sum"),
    ({"compression": "int8"}, "Compression member"),
    ({"op": thvd.Max}, "Average, Sum or Adasum"),
])
def test_optimizer_rejects_what_the_jax_package_rejects(kwargs, error):
    # Adasum and compression are ported (they raised NotImplementedError
    # before); a wire codec with Adasum, a codec name instead of a
    # Compression member, and a non-gradient op raise ValueError.
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match=error):
        train.DistributedOptimizer(torch.optim.SGD([p], lr=0.1), **kwargs)

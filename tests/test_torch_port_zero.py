"""The port's ZeRO-1 sharded weight update (``horovod_tpu_torch/ops/zero.py``,
``train.DistributedOptimizer(zero=True)``) against the JAX package's
(``horovod_tpu/ops/zero.py``, ``tests/test_zero.py``), on the CPU.

Single process: ``plan_zero`` and ``ZeroPlan.signature()`` equal the JAX
package's for the same leaves, world sizes, budgets and blocks; the JAX
package's rejections hold (Adasum, a non-global set, k > 1, a sparse
gradient, an update before init), and so do the torch forms of the
elementwise-state contract (``Adafactor``'s factored state, groups with
different hyperparameters); at n = 1 the sharded update is bit-identical
to the replicated one for SGD with momentum, Adam and AdamW; the row
shards of an embedding equal the JAX package's ``rowsharded_update``.

Launcher jobs at 2 and 3 ranks on the tcp-native plane and the delegated
plane over gloo (worker: tests/torch_port_zero_worker.py), one wave, all
jobs at once. Tolerances:

- against the replicated update of the same plane: bit-identical at 2
  ranks; at 3 ranks within 1e-6 (rtol and atol: a plane may sum the
  reduce-scatter in another order than its fused allreduce, as the tcp
  ring does when the buckets differ from the fused layout);
- against the JAX package's ZeRO step on a CPU mesh of as many devices,
  from the same numpy parameters and batches: SGD with momentum 1e-6,
  Adam 1e-5 (torch and optax arrange Adam's arithmetic differently);
  each rank's moments equal its window of the JAX ``unshard_moments``;
- the int8/fp8 legs alone, fed the same numpy rows and updates over two
  steps with error feedback (the JAX side's second step starts from the
  port's residuals): the JAX package's ``_wire_reduce_scatter`` and
  ``_wire_all_gather`` within 1e-6 of the rows' largest magnitude (at
  least 1e-6 absolute): the same bytes on the wire, float32 sums in
  another order, and XLA's fused arithmetic rounding the residuals by a
  few ulps of the rows;
- two int8/fp8 train steps against the JAX package's: within 1e-6 except
  where a rounding of the quantized legs fell the other way (torch's
  gradients and its in-place update differ from JAX's in the last bit),
  and there within two quantization steps of the update's block;
- fp16 legs: within 1e-3 (fp16's step at these magnitudes); the loss
  after a compressed step within 1e-3 relative, the first within 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
import torch_port_launch
from horovod_tpu_torch import train
from horovod_tpu_torch.ops import bucketing as tbucketing
from horovod_tpu_torch.ops import sparse as tsparse
from horovod_tpu_torch.ops import zero as tzero
from test_torch_port_spmd import PLANES, _finish, _ok, _read, _start
from torch_port_zero_worker import (CODEC_STEPS, LEG_N, STEPS, jax_batch,
                                    jax_params, leg_inputs)

SIZES = (2, 3)


@pytest.fixture
def port():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _leaves():
    """The JAX package's test leaves (37, 13x5 and 5 elements) as numpy, in
    its flatten order."""
    return list(jax_params().values())


def _model_params():
    return [torch.tensor(v, requires_grad=True) for v in _leaves()]


def _loss(params, batch):
    a, b, w = params
    x, y = batch
    return ((x @ w + b - y) ** 2).mean() + (a ** 2).mean()


def _batch():
    x, y = jax_batch(1)
    return torch.tensor(x), torch.tensor(y)


# ==========================================================================
# The plan
# ==========================================================================

@pytest.mark.parametrize("budget,block", [(16 << 20, 1), (256, 1),
                                          (16 << 20, 256)])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plan_equals_the_jax_package(n, budget, block):
    import jax.numpy as jnp
    from horovod_tpu.ops import zero as jzero
    leaves = _leaves()
    want = jzero.plan_zero([jnp.asarray(v) for v in leaves], n, budget,
                           block=block)
    got = tzero.plan_zero([torch.from_numpy(v) for v in leaves], n, budget,
                          block=block)
    assert got.signature() == want.signature()
    assert json.dumps(got.signature()) == json.dumps(want.signature())
    for gb, wb in zip(got.buckets, want.buckets):
        assert gb.indices == wb.indices and gb.nbytes == wb.nbytes
    assert [(s.size, s.padded, s.shard_len) for s in got.shards] == \
        [(s.size, s.padded, s.shard_len) for s in want.shards]
    assert got.leaf_shapes == want.leaf_shapes
    assert got.leaf_dtypes == want.leaf_dtypes


def test_bucket_planner_keeps_the_jax_rules():
    import jax.numpy as jnp
    from horovod_tpu.ops import bucketing as jbucketing
    rng = np.random.RandomState(3)
    shapes = [(rng.randint(1, 40),) for _ in range(12)] + [(300,), ()]
    dtypes = [np.float32, np.float16] * 7
    leaves = [np.zeros(s, d) for s, d in zip(shapes, dtypes)]
    for budget in (1, 64, 200, 1 << 20):
        want = jbucketing.plan_buckets([jnp.asarray(v) for v in leaves],
                                       budget)
        got = tbucketing.plan_buckets([torch.from_numpy(v) for v in leaves],
                                      budget)
        assert [(b.indices, str(b.dtype), b.nbytes) for b in want] == \
            [(b.indices, tzero.dtype_name(b.dtype), b.nbytes) for b in got]
    t = [torch.from_numpy(v) for v in leaves]
    for b in tbucketing.plan_buckets(t, 64):
        out = [None] * len(t)
        tbucketing._unpack(tbucketing._pack(t, b), t, b, out)
        for i in b.indices:
            assert out[i].shape == t[i].shape


# ==========================================================================
# Rejections
# ==========================================================================

def _sgd(params=None):
    return torch.optim.SGD(params or [torch.nn.Parameter(torch.zeros(3))],
                           lr=0.1)


def _reject_adasum():
    train.DistributedOptimizer(_sgd(), op=thvd.Adasum, zero=True)


def _reject_process_set():
    ps = thvd.ProcessSet([0])
    train.DistributedOptimizer(_sgd(), process_set=ps, zero=True)


def _reject_k():
    train.DistributedOptimizer(_sgd(), backward_passes_per_step=2,
                               zero=True)


def _reject_sparse():
    emb = torch.nn.Embedding(10, 4, sparse=True)
    emb(torch.tensor([1, 2])).sum().backward()
    train.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.1),
                               zero=True).step()


def _reject_update_before_init():
    train.DistributedOptimizer(_sgd(), zero=True).update()


def _reject_adafactor():
    params = _model_params()
    opt = train.DistributedOptimizer(torch.optim.Adafactor(params),
                                      zero=True)
    train.make_train_step(_loss, opt)(params, _batch())


def _reject_groups():
    a, b, w = _model_params()
    train.DistributedOptimizer(torch.optim.SGD(
        [{"params": [a, b]}, {"params": [w], "lr": 0.5}], lr=0.1),
        zero=True)


@pytest.mark.parametrize("call,error,phrase", [
    (_reject_adasum, ValueError, "incompatible with op=Adasum"),
    (_reject_process_set, ValueError, "requires the global process set"),
    (_reject_k, ValueError, "backward_passes_per_step > 1"),
    (_reject_sparse, ValueError, "plan_row_shards"),
    (_reject_update_before_init, RuntimeError, "before update"),
    (_reject_adafactor, ValueError, "requires elementwise optimizer state"),
    (_reject_groups, ValueError, "groups differ in lr"),
])
def test_zero_rejects_what_the_jax_package_rejects(port, call, error,
                                                   phrase):
    with pytest.raises(error, match=phrase):
        call()


def test_zero_off_does_zero_new_work(port, monkeypatch):
    monkeypatch.delenv("HVDTPU_ZERO", raising=False)

    def boom(*a, **k):
        raise AssertionError("zero plane engaged with the knob off")

    monkeypatch.setattr(tzero, "ZeroRuntime", boom)
    monkeypatch.setattr(tzero, "plan_zero", boom)
    params = _model_params()
    opt = train.DistributedOptimizer(torch.optim.Adam(params, lr=1e-2))
    assert not opt.zero and opt._zero_rt is None
    loss = train.make_train_step(_loss, opt)(params, _batch())
    assert np.isfinite(loss.item())


# ==========================================================================
# One process: bit-identical to the replicated update
# ==========================================================================

OPTIMIZERS = {
    "sgd": lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
    "adam": lambda p: torch.optim.Adam(p, lr=1e-2),
    "adamw": lambda p: torch.optim.AdamW(p, lr=1e-2, weight_decay=0.1),
}


def _run(make_opt, zero, steps=3, **kw):
    params = _model_params()
    opt = train.DistributedOptimizer(make_opt(params), zero=zero, **kw)
    step = train.make_train_step(_loss, opt)
    losses = [step(params, _batch()).item() for _ in range(steps)]
    return losses, [p.detach().clone() for p in params], opt


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_single_process_zero_is_bit_identical(port, name):
    lr, pr, ropt = _run(OPTIMIZERS[name], False)
    lz, pz, zopt = _run(OPTIMIZERS[name], True)
    assert lr == lz
    for a, b in zip(pr, pz):
        assert torch.equal(a, b)
    rt = zopt._zero_rt
    assert rt.n == 1 and len(rt.plan.buckets) == 1
    # At n = 1 the moments are the replicated ones, padding aside.
    replicated = sum(v.numel() * v.element_size()
                     for st in ropt.inner.state.values()
                     for v in st.values() if torch.is_tensor(v))
    assert rt.state_bytes() == replicated - (
        len(pr) - 1) * (4 if name != "sgd" else 0)
    # The wrapped optimizer never steps: it has no state of its own.
    assert not zopt.inner.state


def test_bucket_budget_knob_and_update(port, monkeypatch):
    monkeypatch.setenv("HVDTPU_ZERO_BUCKET_BYTES", "256")
    lr, pr, _ = _run(OPTIMIZERS["adam"], False)
    lz, pz, zopt = _run(OPTIMIZERS["adam"], True)
    assert len(zopt._zero_rt.plan.buckets) == 2
    assert lr == lz and all(torch.equal(a, b) for a, b in zip(pr, pz))
    # update(): the gathered updates, the parameters left alone.
    params = _model_params()
    opt = train.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                      zero=True)
    opt.init()
    _loss(params, _batch()).backward()
    before = [p.detach().clone() for p in params]
    updates = opt.update()
    for p, b, u in zip(params, before, updates):
        assert torch.equal(p.detach(), b)
        torch.testing.assert_close(u, -0.1 * p.grad, rtol=1e-6, atol=1e-7)


def test_has_aux_step_averages_buffers_after_the_sharded_update(port):
    # make_train_step(has_aux=True) under ZeRO: the BatchNorm running
    # statistics still go through the aux allreduce after the update, and
    # the whole step equals the replicated one.
    runs = {}
    x = torch.tensor(jax_batch(4)[0])
    for zero in (False, True):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(13, 6),
                                    torch.nn.BatchNorm1d(6),
                                    torch.nn.Linear(6, 2))
        opt = train.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            zero=zero)
        step = train.make_train_step(
            lambda m, b: m(b).square().mean(), opt, has_aux=True)
        losses = [step(model, x).item() for _ in range(3)]
        runs[zero] = (losses, [t.detach().clone() for t in
                               model.state_dict().values()])
    assert runs[False][0] == runs[True][0]
    for a, b in zip(runs[False][1], runs[True][1]):
        assert torch.equal(a, b)


def test_lr_scheduler_reaches_the_inner_optimizer(port):
    runs = {}
    for zero in (False, True):
        params = _model_params()
        opt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
        step = train.make_train_step(_loss, train.DistributedOptimizer(
            opt, zero=zero))
        for _ in range(3):
            step(params, _batch())
            sched.step()
        runs[zero] = [p.detach().clone() for p in params]
    assert all(torch.equal(a, b) for a, b in zip(runs[False], runs[True]))


def test_state_dict_round_trip_and_gauge(port, monkeypatch):
    from horovod_tpu_torch.telemetry import core as telemetry
    monkeypatch.setattr(telemetry, "_ENABLED", True)
    monkeypatch.setattr(telemetry, "_FAMILIES", {})
    _, _, zopt = _run(OPTIMIZERS["adam"], True, steps=2)
    assert telemetry.gauge("hvd_zero_state_bytes").value == \
        zopt._zero_rt.state_bytes() > 0
    saved = zopt.shard_state_dict()
    assert saved["plan"] == zopt._zero_rt.plan.signature()
    assert saved["rank"] == 0
    # Losses continue the same from a fresh optimizer given the state.
    params = _model_params()
    fresh = train.DistributedOptimizer(torch.optim.Adam(params, lr=1e-2),
                                       zero=True)
    fresh.load_state_dict(saved)
    got = fresh._zero_rt.inner.state_dict()["state"]
    want = zopt._zero_rt.inner.state_dict()["state"]
    for k in want:
        for name in want[k]:
            assert torch.equal(got[k][name], want[k][name])
    with pytest.raises(ValueError, match="another shard plan or rank"):
        fresh.load_state_dict(dict(saved, rank=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_make_zero_train_step_one_bucket_per_dtype(port, dtype):
    params = [torch.nn.Parameter(torch.ones(5, 3)),
              torch.nn.Parameter(torch.ones(7, dtype=dtype)),
              torch.nn.Parameter(torch.ones(4))]

    def loss_fn(ps, batch):
        return sum((p.float() * batch).sum() for p in ps)

    dist_opt = train.DistributedOptimizer(torch.optim.SGD(params, lr=0.1))
    step, init_state = train.make_zero_train_step(loss_fn, dist_opt)
    state = init_state()
    buckets = state["plan"]["buckets"]
    assert len(buckets) == (1 if dtype == torch.float32 else 2)
    assert not dist_opt.zero
    step(params, torch.tensor(2.0))
    torch.testing.assert_close(params[0].detach(), torch.full((5, 3), 0.8))
    for kw, phrase in (({"op": thvd.Sum}, "op="),
                       ({"backward_passes_per_step": 2},
                        "backward_passes_per_step=2"),
                       ({"compression": thvd.Compression.fp16},
                        "compression"),
                       ({"prescale_factor": 2.0}, "prescale/postscale")):
        bad = train.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                         **kw)
        with pytest.raises(ValueError, match=phrase):
            train.make_zero_train_step(loss_fn, bad)


# ==========================================================================
# Embedding rows sharded by range
# ==========================================================================

@pytest.mark.parametrize("nrows,world", [(10, 3), (7, 7), (5, 8), (30522, 4)])
def test_row_shards_equal_the_jax_package(nrows, world):
    from horovod_tpu.ops import sparse as jsparse
    assert tsparse.plan_row_shards(nrows, world) == \
        jsparse.plan_row_shards(nrows, world)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_rowsharded_update_equals_the_jax_package(rank):
    import jax.numpy as jnp
    import optax
    from horovod_tpu.ops import sparse as jsparse
    rows, width, world = 20, 4, 3
    lo, hi = jsparse.plan_row_shards(rows, world)[rank]
    rng = np.random.RandomState(rank)
    # Two ranks' slices gathered: row 5 and row 12 touched by both.
    idx = np.array([5, 12, 1, 19, 5, 12, 8], np.int64)
    vals = rng.randn(len(idx), width).astype(np.float32)
    param = rng.randn(hi - lo, width).astype(np.float32)
    trace = rng.randn(hi - lo, width).astype(np.float32)
    lr, mom = 0.1, 0.9

    def update(g, state, p):
        t = g + mom * state["trace"]
        return -lr * t, {"trace": t}

    got_p, got_s = tsparse.rowsharded_update(
        update, tsparse.SparseGradient(torch.from_numpy(idx),
                                       torch.from_numpy(vals),
                                       (rows, width)),
        torch.from_numpy(param), {"trace": torch.from_numpy(trace)}, lo, hi)
    opt = optax.sgd(lr, momentum=mom)
    state = (optax.TraceState(trace=jnp.asarray(trace)), optax.EmptyState())
    want_p, want_s = jsparse.rowsharded_update(
        opt, jsparse.SparseGradient(jnp.asarray(idx), jnp.asarray(vals),
                                    (rows, width)),
        jnp.asarray(param), state, lo, hi)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_s["trace"].numpy(),
                               np.asarray(want_s[0].trace), rtol=1e-6,
                               atol=1e-6)
    touched = {i - lo for i in idx if lo <= i < hi}
    for r in range(hi - lo):
        assert (got_p[r].numpy() != param[r]).any() == (r in touched)


# ==========================================================================
# Launcher jobs, 2 and 3 ranks, both CPU planes
# ==========================================================================

def _zero_job(mode, plane, size, out, extra=()):
    return _start("torch_port_zero_worker.py",
                  lambda r, rdv, port, o: [mode, str(r), str(size), rdv,
                                           str(port), o],
                  size, out, {**PLANES[plane], **dict(extra)})


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    torch_port_launch.build_port_core()
    root = tmp_path_factory.mktemp("zero")
    wave = {("zero", p, n): n for p in PLANES for n in SIZES}
    wave.update({("mismatch", p, 2): 2 for p in PLANES})
    started = {}
    for key, size in wave.items():
        out = root / "-".join(map(str, key))
        started[key] = (out, _zero_job(key[0], key[1], size, out))
    done = {}
    for key, (out, procs) in started.items():
        job = _read(out, key[2], _finish(procs))
        if key[0] == "zero":
            _ok(job)
            job["npz"] = [dict(np.load(out / f"r{r}.npz"))
                          for r in range(key[2])]
        done[key] = job
    return done


def _mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("hvd",))


def _jax_train(n, inner, steps, compression=None):
    import jax.numpy as jnp
    import horovod_tpu as hvd_mod
    import horovod_tpu.jax as hvd_jax

    def loss(p, batch):
        x, y = batch
        return jnp.mean((x @ p["w"] + p["b"] - y) ** 2) + \
            jnp.mean(p["a"] ** 2)

    kw = {} if compression is None else {
        "compression": getattr(hvd_mod.Compression, compression)}
    zopt = hvd_jax.DistributedOptimizer(inner, zero=True, **kw)
    step = hvd_jax.make_train_step(loss, zopt, mesh=_mesh(n), donate=False)
    params = {k: jnp.asarray(v) for k, v in jax_params().items()}
    state = zopt.init(params)
    x, y = jax_batch(n)
    losses = []
    for _ in range(steps):
        params, state, l = step(params, state,
                                (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(l))
    leaves = [np.asarray(params[k]) for k in ("a", "b", "w")]
    return losses, leaves, state, zopt


@pytest.fixture(scope="module")
def jax_runs(hvd):
    import optax
    from horovod_tpu.ops import zero as jzero
    runs = {}
    for n in SIZES:
        for name, inner in (("sgd", optax.sgd(0.1, momentum=0.9)),
                            ("adam", optax.adam(1e-2))):
            losses, leaves, state, zopt = _jax_train(n, inner, STEPS)
            per_leaf, _, _ = jzero.unshard_moments(state, zopt._zero_rt)
            runs[n, name] = (losses, leaves, per_leaf,
                             zopt._zero_rt.plan.signature())
        for codec in ("int8", "fp8", "fp16"):
            losses, leaves, _, _ = _jax_train(
                n, optax.sgd(0.1, momentum=0.9), CODEC_STEPS, codec)
            runs[n, codec] = (losses, leaves)
    return runs


def _jax_legs(n, codec_name, got):
    """The JAX package's quantized legs on the worker's fixed inputs, each
    step fed the error-feedback residuals the port's ranks (``got``) left
    after the step before, so that both sides quantize the same rows: per
    step, every rank's (shard, scatter residual, full, gather residual) and
    the largest input magnitude."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.compression import codecs as jcodecs
    from horovod_tpu.ops import zero as jzero
    from horovod_tpu.utils.jax_compat import shard_map
    codec, block = jcodecs.get_codec(codec_name), 256
    padded = jcodecs.padded_len(LEG_N, n, block)
    sl = padded // n

    def body(g, u, rs, rg):
        shard, new_rs = jzero._wire_reduce_scatter(
            g[0].reshape(n, sl), "hvd", codec, block, n, rs[0])
        full, new_rg = jzero._wire_all_gather(u, "hvd", codec, block, rg)
        return (shard / n)[None], new_rs[None], full[None], new_rg

    spec = P("hvd")
    fn = jax.jit(shard_map(body, mesh=_mesh(n), in_specs=(spec,) * 4,
                           out_specs=(spec,) * 4, check_vma=False))
    steps = []
    for step in range(CODEC_STEPS):
        ins = [leg_inputs(r, step, n) for r in range(n)]
        if step == 0:
            rs = np.zeros((n, n, sl), np.float32)
            rg = np.zeros((n * sl,), np.float32)
        else:
            pre = f"leg.{codec_name}.{step - 1}."
            rs = np.stack([got[r][pre + "res_s"] for r in range(n)])
            rg = np.concatenate([got[r][pre + "res_g"] for r in range(n)])
        g = np.stack([g for g, _ in ins])
        shard, new_rs, full, new_rg = fn(
            jnp.asarray(g), jnp.asarray(np.concatenate([u for _, u in ins])),
            jnp.asarray(rs), jnp.asarray(rg))
        steps.append((np.asarray(shard), np.asarray(new_rs),
                      np.asarray(full), np.asarray(new_rg).reshape(n, sl),
                      float(np.abs(g + rs.reshape(n, padded)).max())))
    return steps


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_zero_equals_the_replicated_update(jobs, plane, size):
    res = jobs["zero", plane, size]["res"]
    for r in range(size):
        for key, d in res[r]["diffs"].items():
            if size == 2:
                assert d["equal"], (r, key, d)
            else:
                assert d["close"] and d["loss_rel"] <= 1e-6, \
                    (r, key, d)
            assert d["buckets"] == (1 if key.endswith("default") else 2)
    if size == 3:
        # One bucket sums in the fused allreduce's order on both planes.
        assert all(d["equal"] for k, d in res[0]["diffs"].items()
                   if k.endswith("default"))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_zero_equals_the_jax_package(jobs, jax_runs, plane, size):
    job = jobs["zero", plane, size]
    for name, tol in (("sgd", 1e-6), ("adam", 1e-5)):
        losses, leaves, _, signature = jax_runs[size, name]
        for r in range(size):
            assert job["res"][r][f"{name}.plan"] == signature
            got = job["npz"][r]
            np.testing.assert_allclose(got[f"{name}.losses"], losses,
                                       rtol=tol, atol=tol)
            for i, want in enumerate(leaves):
                np.testing.assert_allclose(got[f"{name}.p{i}"], want,
                                           rtol=tol, atol=tol,
                                           err_msg=f"{name} leaf {i}")


SLOTS = {"sgd": {"momentum_buffer": 0},
         "adam": {"exp_avg": 1, "exp_avg_sq": 2}}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_each_rank_holds_its_window_of_the_jax_moments(jobs, jax_runs, plane,
                                                       size):
    job = jobs["zero", plane, size]
    for name, slots in SLOTS.items():
        per_leaf = jax_runs[size, name][2]
        covered = [0, 0, 0]
        for r in range(size):
            windows = job["res"][r][f"{name}.windows"]
            got = job["npz"][r]
            for slot, j in slots.items():
                for i, win in enumerate(windows):
                    if win is None:
                        assert f"{name}.{slot}.{i}" not in got
                        continue
                    np.testing.assert_allclose(
                        got[f"{name}.{slot}.{i}"],
                        per_leaf[j][i][win[0]:win[1]], rtol=1e-5, atol=1e-7,
                        err_msg=f"{name} {slot} leaf {i} rank {r}")
            for i, win in enumerate(windows):
                covered[i] += 0 if win is None else win[1] - win[0]
        # The windows of the ranks tile every leaf exactly once.
        assert covered == [37, 5, 65]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_state_bytes_is_one_nth_of_the_replicated(jobs, plane, size):
    for r, res in job_results(jobs, plane, size):
        for name in ("sgd", "adam"):
            zb, rb = res[f"{name}.state_bytes"], \
                res[f"{name}.replicated_state_bytes"]
            shard_len = res[f"{name}.plan"]["buckets"][0]["shard_len"]
            moments = 1 if name == "sgd" else 2
            assert zb == moments * shard_len * 4 + (4 if name == "adam"
                                                    else 0)
            assert rb / size * 0.9 < zb < rb / size * 1.1, (zb, rb)


def job_results(jobs, plane, size):
    res = jobs["zero", plane, size]["res"]
    return [(r, res[r]) for r in range(size)]


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_wire_legs_equal_the_jax_package(jobs, plane, size, codec):
    job = jobs["zero", plane, size]
    want = _jax_legs(size, codec, job["npz"])
    for r in range(size):
        got = job["npz"][r]
        for step, (shard, rs, full, rg, scale) in enumerate(want):
            pre = f"leg.{codec}.{step}."
            for key, w in (("shard", shard[r]), ("res_s", rs[r]),
                           ("full", full[r][:LEG_N]), ("res_g", rg[r])):
                np.testing.assert_allclose(got[pre + key], w, rtol=0,
                                           atol=1e-6 * max(1.0, scale),
                                           err_msg=pre + key)


@pytest.mark.parametrize("codec", ["int8", "fp8", "fp16"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_codec_train_steps_match_the_jax_package(jobs, jax_runs, plane, size,
                                                 codec):
    from horovod_tpu_torch.compression import codecs
    losses, leaves = jax_runs[size, codec]
    res = jobs["zero", plane, size]["res"]
    wire = codec != "fp16"
    for r in range(size):
        assert res[r][f"{codec}.error_feedback"] == wire
        assert res[r][f"{codec}.residuals"] == (1 if wire else 0)
        got = jobs["zero", plane, size]["npz"][r]
        # Step 1's loss is before any update; step 2's follows one
        # quantized update, summed over the ranks in another order.
        np.testing.assert_allclose(got[f"{codec}.losses"][0], losses[0],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[f"{codec}.losses"][1:], losses[1:],
                                   rtol=1e-3)
        flat_got = np.concatenate([got[f"{codec}.p{i}"].ravel()
                                   for i in range(3)])
        flat_want = np.concatenate([v.ravel() for v in leaves])
        err = np.abs(flat_got - flat_want)
        if not wire:
            assert err.max() <= 1e-3, err.max()
            continue
        # The step-2 update's quantization step, per 256-element block of
        # the padded bucket (the gather leg's blocks).
        start = np.concatenate([v.ravel() for v in jax_params().values()])
        qmax = codecs.get_codec(codec).qmax
        padded = codecs.padded_len(flat_want.size, size, 256)
        u = np.pad(np.abs(flat_want - start), (0, padded - flat_want.size))
        quantum = np.repeat(u.reshape(-1, 256).max(1) / qmax,
                            256)[:flat_want.size]
        if codec == "fp8":
            quantum = np.maximum(quantum, np.abs(flat_want - start) / 8)
        off = err > 1e-6
        assert off.mean() <= 0.05, (codec, off.sum())
        assert np.all(err <= 2 * quantum + 1e-6), (codec, err.max())


@pytest.mark.parametrize("plane", PLANES)
def test_bucket_budget_mismatch_fails_fast_in_negotiation(jobs, plane):
    # The two plans fill one chunk of the same width: the plan probe's
    # width differs, and the core refuses it in the negotiation.
    job = jobs["mismatch", plane, 2]
    res = _ok(job)
    for r in range(2):
        assert "zero.rs." in res[r]["error"], res[r]
        assert "mismatched shapes" in res[r]["error"], res[r]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("plane", PLANES)
def test_version_bump_raises_instead_of_resharding(jobs, plane, size):
    for r, res in job_results(jobs, plane, size):
        for what in ("step", "sync"):
            assert "cannot reshard optimizer state in place" in \
                res[f"bump.{what}"], res[f"bump.{what}"]
            assert "Restore from a checkpoint" in res[f"bump.{what}"]

"""The port's ``parallel/sharding.py``, ``parallel/twod.py`` and the tiled
``all_gather`` / ``psum_scatter`` of ``parallel/axis.py`` against the JAX
package's, on the CPU.

In process: ``make_param_specs`` on the full-width TransformerLM's flax
tree (vocab 30522: replicated embedding and head at tp 4), MoE leaves and
misfit leaves, at several meshes; the port's table of flax paths and
shapes against ``TransformerLM.init``'s tree; ``batch_spec``,
``constrain``; ``to_serving`` raising (item 14).

4-rank gloo jobs (tests/torch_port_sharding_worker.py):

- ``shard_fsdp`` / ``shard_dp``: ``shard_model`` at (dp 1, fsdp 2, tp 2)
  and (dp 2, fsdp 1, tp 2), vocab 128, hidden 32, 2 layers, 2 heads, seq
  16, float32, flash attention (its plain version on CPU tensors), 3
  AdamW steps, against the JAX package's jitted step on sharded parameters
  on the same mesh shape (``tests/test_parallel.py:401-470``): losses
  1e-5, parameters 1e-4 (that test's tolerances); each rank's slices
  before the first step are the JAX placement's shards of its device
  (the qkv weight's three strided row blocks among them).
- ``twod``: ``TwoDZero`` at (dp 2, tp 2) on tests/test_twod.py's toy
  loss, 2 Adam steps, then ``reshard_2d`` to (dp 1, tp 2) and a step:
  1e-6 against ``horovod_tpu.parallel.twod``, bit-equal against the
  port's own same-mesh oracle, the moments moved bit-exactly.
- ``axis``: the collectives and their backwards against ``lax.all_gather``
  / ``lax.psum_scatter`` under ``shard_map``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel import MeshConfig as JaxMeshConfig
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import sharding as jshard
from horovod_tpu.parallel import twod as jtwod
from horovod_tpu.utils.jax_compat import shard_map

import torch_port_sharding_worker as w
from horovod_tpu_torch import models
from horovod_tpu_torch.models.transformer import params_from_flax
from horovod_tpu_torch.parallel import sharding as tshard
from horovod_tpu_torch.parallel import twod as ttwod
from horovod_tpu_torch.utils import tree as ttree

N = w.N
MODES = ("shard_fsdp", "shard_dp", "twod", "axis")


def _jax_cfg(**kw):
    return JaxConfig(dtype=jnp.float32, causal=True, use_rope=True, **kw)


@functools.lru_cache(maxsize=1)
def _flax_params():
    model = JaxLM(_jax_cfg(**w.LM))
    return jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, w.LM["max_len"]), jnp.int32)))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharding")
    np.savez(root / "params.npz", **{
        "/".join(str(k.key) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            _flax_params())[0]})
    j = w.Jobs(root, MODES)
    yield j
    j.kill()


def _spec_map(tree, is_jax):
    if is_jax:
        pairs = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): tuple(spec) for path, spec in pairs}
    return {ttree.path_str(path): tuple(spec)
            for path, spec in ttree.flatten_with_path(tree)}


# -- the rules ---------------------------------------------------------------

MESHES = [dict(dp=2, fsdp=2, tp=2), dict(dp=2, tp=4), dict(dp=4, tp=2),
          dict(dp=8), dict(fsdp=8), dict(dp=1, fsdp=4, tp=2)]


def _jax_mesh(kw):
    cfg = JaxMeshConfig(**kw).resolve(8)
    return jax_make_mesh(cfg)


@pytest.mark.parametrize("kw", MESHES, ids=str)
def test_make_param_specs_match_jax_on_the_full_width_lm(kw):
    full = dict(vocab_size=30522, hidden=1024, layers=2, heads=16,
                max_len=512)
    jtree = jax.eval_shape(JaxLM(_jax_cfg(**full)).init,
                           jax.random.PRNGKey(0),
                           jnp.zeros((1, 512), jnp.int32))
    ttree_ = tshard.flax_shapes(models.TransformerConfig(**full))
    jshapes = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jtree)[0]}
    tshapes = {ttree.path_str(p): tuple(x.shape)
               for p, x in ttree.flatten_with_path(ttree_)}
    assert tshapes == jshapes          # the port's table of flax leaves
    mesh = _jax_mesh(kw)
    want = _spec_map(jshard.make_param_specs(jtree, mesh), True)
    got = _spec_map(tshard.make_param_specs(ttree_, dict(mesh.shape)),
                    False)
    assert got == want
    if mesh.shape.get("tp", 1) == 4:   # 30522 % 4: vocab left whole
        assert got["params/lm_head/kernel"] == ()
        assert got["params/backbone/tok_embed/embedding"] == ()
    if mesh.shape.get("tp", 1) == 2:
        assert "tp" in got["params/lm_head/kernel"]


@pytest.mark.parametrize("kw", MESHES[:3], ids=str)
def test_make_param_specs_match_jax_on_moe_and_misfit_leaves(kw):
    shapes = {"moe": {"w_in": (8, 16, 32), "w_out": (8, 32, 16),
                      "w_gate": (16, 8)},
              "blk": {"attn": {"qkv": {"kernel": (32, 3, 3, 8),
                                       "bias": (3, 3, 8)},
                               "proj": {"kernel": (3, 8, 32)}},
                      "mlp_in": {"kernel": (30, 6)},
                      "other": (7, 5)}}
    jtree = jax.tree.map(lambda s: jnp.zeros(s), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
    ttree_ = _torch_tree(shapes)
    mesh = _jax_mesh(kw)
    want = _spec_map(jshard.make_param_specs(jtree, mesh), True)
    got = _spec_map(tshard.make_param_specs(ttree_, dict(mesh.shape)),
                    False)
    assert got == want
    rules = jshard.transformer_param_rules(fsdp_axis="fsdp")
    assert [(p, tuple(s)) for p, s in
            tshard.transformer_param_rules(fsdp_axis="fsdp")] == \
        [(p, tuple(s)) for p, s in rules]


def _torch_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _torch_tree(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


def test_batch_spec_constrain_and_partition_spec():
    assert tuple(tshard.batch_spec(extra_dims=1)) == \
        tuple(jshard.batch_spec(extra_dims=1))
    assert tshard.P(("dp",), None, "tp") == ("dp", None, "tp")
    assert tuple(tshard.P(("dp",), None)) == tuple(JP(("dp",), None))
    x = torch.zeros(8, 6)
    assert tshard.constrain(x, {"dp": 2, "tp": 2}, tshard.P("dp", "tp")) \
        is x
    with pytest.raises(ValueError, match="does not fit"):
        tshard.constrain(x, {"dp": 2, "tp": 4}, tshard.P("dp", "tp"))


def test_to_serving_names_item_14():
    tz = ttwod.TwoDZero(functools.partial(torch.optim.Adam, lr=1e-2),
                        {"dp": 1, "tp": 1})
    with pytest.raises(NotImplementedError, match="item 14"):
        tz.to_serving({"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="Average/Sum"):
        from horovod_tpu_torch.ops import reduce_ops
        ttwod.TwoDZero(torch.optim.SGD, {"dp": 1, "tp": 1},
                       op=reduce_ops.Adasum)


# -- shard_model -------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _jax_sharded_run(mode):
    """tests/test_parallel.py's sharded step on 4 host devices."""
    kw = w.SHARD_MESHES[mode]
    mesh = jax_make_mesh(JaxMeshConfig(**kw), devices=jax.devices()[:N])
    model = JaxLM(_jax_cfg(**w.LM))
    params = jax.tree.map(jnp.asarray, _flax_params())
    specs = jshard.make_param_specs(params, mesh)
    opt = optax.adamw(w.LM_LR)

    def loss_fn(p, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, x), y).mean()

    def step(p, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(p, batch)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    placed = jax.tree.map(
        lambda v, s: jax.device_put(v, NamedSharding(mesh, s)),
        params, specs)
    x, y = (jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, jshard.batch_spec(extra_dims=1))) for a in w.lm_batch())
    p, s, losses = placed, opt.init(placed), []
    jstep = jax.jit(step)
    for _ in range(w.LM_STEPS):
        p, s, loss = jstep(p, s, (x, y))
        losses.append(float(loss))
    return placed, p, losses


@pytest.mark.parametrize("mode", sorted(w.SHARD_MESHES))
def test_shard_model_matches_the_jax_sharded_step(jobs, mode):
    _, final, losses = _jax_sharded_run(mode)
    res = jobs.get(mode)
    for r in range(N):
        np.testing.assert_allclose(res[r]["losses"], losses, rtol=1e-5,
                                   atol=1e-6)
    cfg = models.TransformerConfig(dtype=torch.float32, **w.LM)
    want = params_from_flax(jax.tree.map(np.asarray, final), cfg)
    for name, t in want.items():
        np.testing.assert_allclose(res[0][f"param_{name}"], t.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", sorted(w.SHARD_MESHES))
def test_shard_model_keeps_each_ranks_jax_shard(jobs, mode):
    """Rank r's slices before the first step are the shards GSPMD places
    on device r, read through the port's layout of each leaf."""
    placed, _, _ = _jax_sharded_run(mode)
    res = jobs.get(mode)
    cfg = models.TransformerConfig(dtype=torch.float32, **w.LM)
    hd = cfg.hidden // cfg.heads
    leaves = {tuple(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(placed)[0]}
    sharded = 0
    for name, path, _, kind in tshard._flax_layout(cfg):
        for r in range(N):
            shard, = [s for s in leaves[path].addressable_shards
                      if s.device.id == r]
            want = tshard._from_flax(kind, torch.tensor(
                np.asarray(shard.data)))
            got = res[r][f"init_{name}"]
            np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
        sharded += leaves[path].sharding.spec != JP()
    # qkv (weight, bias), proj, mlp_in (weight, bias), mlp_out a layer;
    # the embedding and the head
    assert sharded == 6 * cfg.layers + 2
    qkv = res[1]["init_backbone.blocks.0.attn.qkv.weight"]
    assert qkv.shape == (3 * hd, cfg.hidden // w.SHARD_MESHES[mode]["fsdp"])


# -- TwoDZero ----------------------------------------------------------------

def _jax_twod_loss(p, b):
    h = b * p["scale"]
    y = h @ p["mlp_in"]["kernel"] + p["mlp_in"]["bias"]
    return jnp.sum(y * y)


@functools.lru_cache(maxsize=1)
def _jax_twod():
    inner = optax.adam(w.TWOD_LR)
    tz4 = jtwod.TwoDZero(inner, jtwod.make_mesh_2d(2, 2))
    params = jax.tree.map(jnp.asarray, w.twod_params())
    batch = jnp.asarray(w.twod_batch())
    state = tz4.init_state(params)
    step = tz4.make_step(_jax_twod_loss)
    p, s, losses = params, state, []
    for _ in range(2):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    tz2 = jtwod.TwoDZero(inner, jtwod.make_mesh_2d(1, 2))
    s2 = jtwod.reshard_2d(s, tz4, tz2, p)
    tz2.ensure_plan(p)
    p2 = jax.tree.map(lambda leaf, spec: jax.device_put(
        np.asarray(leaf), NamedSharding(tz2.mesh, spec)), p,
        tz2.param_specs, is_leaf=lambda x: hasattr(x, "shape"))
    pa, _, la = tz2.make_step(_jax_twod_loss)(p2, s2, batch)
    return dict(losses=losses, p=p, s=s, s2=s2, pa=pa, loss_after=float(la))


def _block(arr, r):
    """Device r's shard of a JAX array."""
    shard, = [s for s in arr.addressable_shards if s.device.id == r]
    return np.asarray(shard.data)


def _close_moments(got, want):
    """Moments against optax's: 1e-6 relative, and 1e-6 of the vector's
    largest element absolute (a moment that is a difference of larger
    gradient terms carries XLA's and torch's summation orders apart)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def _jax_moments(state, k):
    adam = state[0][k][0]
    return {"exp_avg": adam.mu, "exp_avg_sq": adam.nu, "step": adam.count}


def test_twod_matches_jax_and_is_the_oracle_bit_for_bit(jobs):
    want = _jax_twod()
    res = jobs.get("twod")
    for r in range(N):
        got = res[r]
        for i in range(2):
            assert got[f"loss{i}"] == got[f"oracle_loss{i}"]
            np.testing.assert_allclose(got[f"loss{i}"], want["losses"][i],
                                       rtol=1e-6)
        for j, leaf in enumerate(jax.tree.leaves(want["p"])):
            np.testing.assert_array_equal(got[f"p4_{j}"],
                                          got[f"oracle_p4_{j}"])
            np.testing.assert_allclose(got[f"p4_{j}"], _block(leaf, r),
                                       rtol=1e-6, atol=1e-6)
        for k in range(len(want["s"][0])):
            for slot, leaf in _jax_moments(want["s"], k).items():
                w_ = np.asarray(leaf) if slot == "step" else _block(leaf, r)
                _close_moments(got[f"m4_{k}_{slot}"], w_)


def test_reshard_2d_moves_the_moments_and_the_next_step_holds(jobs):
    want = _jax_twod()
    res = jobs.get("twod")
    assert [bool(res[r]["on_new"]) for r in range(N)] == \
        [True, True, False, False]
    for t in range(2):
        got = res[t]
        for slot in ("exp_avg", "exp_avg_sq"):
            old = np.concatenate([res[d * 2 + t][f"m4_0_{slot}"]
                                  for d in range(2)])
            new = got[f"m2_0_{slot}"]
            size = min(len(new), len(old))
            np.testing.assert_array_equal(new[:size], old[:size])
            _close_moments(new, _block(_jax_moments(want["s2"], 0)[slot],
                                       t))
        assert got["loss_after"] == got["oracle_loss_after"]
        np.testing.assert_allclose(got["loss_after"], want["loss_after"],
                                   rtol=1e-6)
        for j, leaf in enumerate(jax.tree.leaves(want["pa"])):
            np.testing.assert_array_equal(got[f"p2_{j}"],
                                          got[f"oracle_p2_{j}"])
            np.testing.assert_allclose(got[f"p2_{j}"], _block(leaf, t),
                                       rtol=1e-6, atol=1e-6)


# -- axis ----------------------------------------------------------------------

def _axis_mesh():
    return Mesh(np.array(jax.devices()[:N]), ("a",))


def test_all_gather_and_its_backward_match_lax(jobs):
    x, per_rank, _, shared, _ = w.axis_inputs(N)

    def per(xl, c):
        g = lax.all_gather(xl, "a", axis=1, tiled=True)
        return g[None], jnp.sum(g * c[0])[None]
    f = shard_map(per, mesh=_axis_mesh(), in_specs=(JP(None, "a"), JP("a")),
                  out_specs=(JP("a"), JP("a")))
    gathered, _ = f(jnp.asarray(x), jnp.asarray(per_rank))
    grad = jax.grad(lambda x_: jnp.sum(f(x_, jnp.asarray(per_rank))[1]))(
        jnp.asarray(x))
    res = jobs.get("axis")
    for r in range(N):
        np.testing.assert_array_equal(res[r]["gathered"], gathered[r])
        np.testing.assert_allclose(res[r]["gather_grad"],
                                   np.asarray(grad)[:, 2 * r:2 * r + 2],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(res[r]["invariant"], x)
        np.testing.assert_array_equal(res[r]["invariant_grad"],
                                      shared[:, 2 * r:2 * r + 2])


def test_psum_scatter_and_its_backward_match_lax(jobs):
    _, _, scattered, _, stacked = w.axis_inputs(N)

    def per(xs, c):
        s = lax.psum_scatter(xs[0], "a", scatter_dimension=1, tiled=True)
        return s[None], jnp.sum(s * c[0])[None]
    f = shard_map(per, mesh=_axis_mesh(), in_specs=(JP("a"), JP("a")),
                  out_specs=(JP("a"), JP("a")))
    out, _ = f(jnp.asarray(stacked), jnp.asarray(scattered))
    grad = jax.grad(lambda s_: jnp.sum(f(s_, jnp.asarray(scattered))[1]))(
        jnp.asarray(stacked))
    res = jobs.get("axis")
    for r in range(N):
        np.testing.assert_allclose(res[r]["scattered"], out[r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(res[r]["scatter_grad"],
                                   np.asarray(grad)[r], rtol=1e-6,
                                   atol=1e-6)
        assert "divisible" in str(res[r]["indivisible_error"])

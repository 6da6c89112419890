"""The port's ``parallel/`` against the JAX package's, on the CPU.

One 4-rank gloo job per module (worker: tests/torch_port_parallel_worker.py;
all five start together in the module's fixture and each test waits only
for the job it reads) runs the port's strategy over torch process groups
on the seeds and shapes of ``tests/test_parallel.py``; the pytest process
runs the JAX package's strategy under ``shard_map`` on 4 of the 8 host
devices (``tests/conftest.py``), with ``impl="flash"`` where the JAX test
uses it, and holds the two to the JAX test's tolerance: ring attention
2e-4 (outputs) and 1e-3 (gradients), Ulysses 2e-4, the pipeline 1e-5
(outputs), 2e-5 (heterogeneous ends) and 1e-4 (gradients), MoE 2e-4
(outputs) and 2e-3 (gate gradient). The port's ring and Ulysses run the
flash kernels' plain versions on CPU tensors (the ring in their LSE mode,
with offsets and an LSE cotangent). The tests without a job compare pure
functions in process: ``MeshConfig``, ``stack_stage_params``, ``_merge``,
single-program MoE and ``MoELayer`` from flax parameters.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops.flash_attention import (
    reference_attention as jax_reference)
from horovod_tpu.parallel import MeshConfig as JaxMeshConfig
from horovod_tpu.parallel import MoELayer as JaxMoELayer
from horovod_tpu.parallel import make_mesh as jax_make_mesh
from horovod_tpu.parallel import moe_apply as jax_moe_apply
from horovod_tpu.parallel import pipeline_apply as jax_pipeline_apply
from horovod_tpu.parallel import ring_attention as jax_ring_attention
from horovod_tpu.parallel import ulysses_attention as jax_ulysses
from horovod_tpu.parallel.pipeline import stack_stage_params as jax_stack
from horovod_tpu.parallel.ring_attention import _merge as jax_merge
from horovod_tpu.utils.jax_compat import shard_map

import torch_port_launch
import torch_port_parallel_worker as w
from horovod_tpu_torch import parallel as tpar
from horovod_tpu_torch.parallel import moe as tmoe
from horovod_tpu_torch.parallel.ring_attention import _merge as port_merge

HERE = os.path.dirname(os.path.abspath(__file__))
N = 4
MODES = ("mesh", "ring", "ulysses", "pipeline", "moe")
TIMEOUT = 300


class _Jobs:
    """The five 4-rank jobs, started together; :meth:`get` waits for one
    and returns each rank's outputs."""

    def __init__(self, root):
        self.root, self.procs, self.done = root, {}, {}
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
        env.update(OMP_NUM_THREADS="1")
        for mode in MODES:
            out = root / mode
            out.mkdir()
            port = torch_port_launch.free_port()
            self.procs[mode] = [subprocess.Popen(
                [sys.executable, os.path.join(HERE,
                                              "torch_port_parallel_worker.py"),
                 mode, str(r), str(N), str(port), str(out)],
                env=env, stdout=open(out / f"log{r}.txt", "w"),
                stderr=subprocess.STDOUT) for r in range(N)]

    def get(self, mode):
        if mode not in self.done:
            codes = []
            for p in self.procs[mode]:
                try:
                    codes.append(p.wait(timeout=TIMEOUT))
                except subprocess.TimeoutExpired:
                    self.kill()
                    codes.append("timeout")
            out = self.root / mode
            if codes != [0] * N:
                logs = "\n".join((out / f"log{r}.txt").read_text()[-3000:]
                                 for r in range(N))
                self.done[mode] = AssertionError(
                    f"{mode} job exited {codes}:\n{logs}")
            else:
                self.done[mode] = [dict(np.load(out / f"r{r}.npz"))
                                   for r in range(N)]
        if isinstance(self.done[mode], Exception):
            raise self.done[mode]
        return self.done[mode]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    j = _Jobs(tmp_path_factory.mktemp("parallel"))
    yield j
    j.kill()


def _cat(res, key, axis):
    return np.concatenate([r[key] for r in res], axis=axis)


def _mesh(name):
    return Mesh(np.array(jax.devices()[:N]), (name,))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


SEQ = P(None, None, "sp", None)


# -- mesh ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(dp=-1, tp=2, pp=2), dict(dp=-1, tp=2),
                                dict(dp=2, fsdp=2, sp=2), dict()])
def test_mesh_config_resolve_matches_the_jax_package(kw):
    for n in (4, 8):
        try:
            want = JaxMeshConfig(**kw).resolve(n)
        except ValueError:
            with pytest.raises(ValueError):
                tpar.MeshConfig(**kw).resolve(n)
            continue
        got = tpar.MeshConfig(**kw).resolve(n)
        assert got.shape == want.shape
        assert got.data_axes == want.data_axes
    assert tpar.AXIS_ORDER == ("dp", "fsdp", "pp", "sp", "tp")
    for bad in (dict(dp=3, tp=2), dict(tp=3)):
        with pytest.raises(ValueError):
            JaxMeshConfig(**bad).resolve(8)
        with pytest.raises(ValueError):
            tpar.MeshConfig(**bad).resolve(8)


def test_make_mesh_matches_the_jax_mesh(jobs):
    res = jobs.get("mesh")
    mesh = jax_make_mesh(JaxMeshConfig(dp=-1, tp=2), devices=jax.devices()[:N])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r, got in enumerate(res):
        assert tuple(got["names"]) == mesh.axis_names
        np.testing.assert_array_equal(got["layout"], ids)
        at = tuple(int(i[0]) for i in np.nonzero(ids == r))
        for axis, name in enumerate(mesh.axis_names):
            assert int(got[f"size_{name}"]) == mesh.shape[name]
            line = list(at)
            line[axis] = slice(None)
            assert list(got[f"ranks_{name}"]) == list(ids[tuple(line)])


# -- ring attention --------------------------------------------------------

def _jax_inputs(shape):
    return [jnp.asarray(w.rand(shape, i)) for i in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["flash", "einsum"])
def test_ring_attention_matches_jax(jobs, causal, impl):
    q, k, v = _jax_inputs(w.RING["shape"])
    want = jax.jit(shard_map(
        lambda q, k, v: jax_ring_attention(q, k, v, "sp", causal=causal,
                                           impl=impl),
        mesh=_mesh("sp"), in_specs=SEQ, out_specs=SEQ))(q, k, v)
    got = _cat(jobs.get("ring"), f"out_{causal}_{impl}", 2)
    _close(got, want, 2e-4)
    _close(got, jax_reference(q, k, v, causal=causal), 2e-4)


def _jax_seq_grads(fn, shape):
    q, k, v = _jax_inputs(shape)

    def loss(q, k, v):
        losses = shard_map(
            lambda q, k, v: jnp.array([jnp.sum(fn(q, k, v) ** 2)]),
            mesh=_mesh("sp"), in_specs=SEQ, out_specs=P("sp"))(q, k, v)
        return jnp.sum(losses)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)


def test_ring_attention_gradients_match_jax(jobs):
    """The port's backward through the kernels' LSE mode (offsets, an LSE
    cotangent into delta), the fp32 merge and the inverse rotations."""
    want = _jax_seq_grads(
        lambda q, k, v: jax_ring_attention(q, k, v, "sp", causal=True),
        w.RING["shape"])
    res = jobs.get("ring")
    for name, g in zip("qkv", want):
        _close(_cat(res, f"grad_{name}", 2), g, 1e-3)


# -- ulysses ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax(jobs, causal):
    q, k, v = _jax_inputs(w.ULYSSES["shape"])
    want = jax.jit(shard_map(
        lambda q, k, v: jax_ulysses(q, k, v, "sp", causal=causal),
        mesh=_mesh("sp"), in_specs=SEQ, out_specs=SEQ))(q, k, v)
    got = _cat(jobs.get("ulysses"), f"out_{causal}", 2)
    _close(got, want, 2e-4)
    _close(got, jax_reference(q, k, v, causal=causal), 2e-4)


def test_ulysses_gradients_match_jax(jobs):
    want = _jax_seq_grads(
        lambda q, k, v: jax_ulysses(q, k, v, "sp", causal=True),
        w.ULYSSES["shape"])
    res = jobs.get("ulysses")
    for name, g in zip("qkv", want):
        _close(_cat(res, f"grad_{name}", 2), g, 1e-3)


def test_ulysses_rejects_indivisible_heads(jobs):
    for r in jobs.get("ulysses"):
        assert "divisible" in str(r["indivisible_error"])


# -- pipeline --------------------------------------------------------------

def _tanh_stage(w_, x):
    return jnp.tanh(x @ w_)


def _stages(c, count):
    return [jnp.asarray(w.rand((c["d"], c["d"]), c["stage_seed"] + i))
            for i in range(count)]


def test_pipeline_matches_sequential(jobs):
    c = w.PIPE_SEQ
    stages = _stages(c, N)
    x = jnp.asarray(w.rand((c["m"], c["mb"], c["d"]), c["x_seed"]))
    want = jax.jit(shard_map(
        lambda w_, x: jax_pipeline_apply(_tanh_stage, w_, x, "pp"),
        mesh=_mesh("pp"), in_specs=(P("pp"), P("pp")), out_specs=P()))(
            jax_stack(stages), x)
    ref = x
    for s in stages:
        ref = _tanh_stage(s, ref)
    for r in jobs.get("pipeline"):
        _close(r["seq_out"], want, 1e-5)
        _close(r["seq_out"], ref, 1e-5)


def _jax_pipe_grad(stage_fn, stacked, x, **kw):
    def loss(w_, x):
        return shard_map(
            lambda w_, x: jnp.sum(jax_pipeline_apply(stage_fn, w_, x, "pp",
                                                     **kw) ** 2),
            mesh=_mesh("pp"), in_specs=(P("pp"), P("pp")),
            out_specs=P())(w_, x)
    return jax.jit(jax.value_and_grad(loss))(stacked, x)


def test_pipeline_gradients_match_jax(jobs):
    c = w.PIPE_GRAD
    x = jnp.asarray(w.rand((c["m"], c["mb"], c["d"]), c["x_seed"]))
    _, want = _jax_pipe_grad(_tanh_stage, jax_stack(_stages(c, N)), x)
    _close(_cat(jobs.get("pipeline"), "grad_block", 0), want, 1e-4)


def _jax_block(wt, h):
    mu = h.mean(-1, keepdims=True)
    hn = (h - mu) / jnp.sqrt(h.var(-1, keepdims=True) + 1e-5)
    return h + jax.nn.gelu(hn @ wt["w1"]) @ wt["w2"]


def _jax_two_block_stage(wstack, h):
    for i in range(2):
        h = _jax_block(jax.tree.map(lambda a: a[i], wstack), h)
    return h


def _hetero():
    stages, emb, head, tokens = w.hetero_inputs(N)
    stacked = jax_stack([jax.tree.map(jnp.asarray, s) for s in stages])

    def run(wt, e, hd, t):
        return shard_map(
            lambda wt, e, hd, t: jax_pipeline_apply(
                _jax_two_block_stage, wt, t, "pp",
                first_fn=lambda e_, tk: e_[tk], first_params=e,
                last_fn=lambda hd_, h: h @ hd_, last_params=hd),
            mesh=_mesh("pp"), in_specs=(P("pp"), P(), P(), P("pp")),
            out_specs=P())(wt, e, hd, t)
    return run, stacked, jnp.asarray(emb), jnp.asarray(head), \
        jnp.asarray(tokens)


def test_pipeline_transformer_stages_with_hetero_ends_match_jax(jobs):
    run, stacked, emb, head, tokens = _hetero()
    want = jax.jit(run)(stacked, emb, head, tokens)
    for r in jobs.get("pipeline"):
        assert r["hetero_out"].shape == (8, 2, 6, 32)
        _close(r["hetero_out"], want, 2e-5)


def test_pipeline_replicated_end_gradients_match_jax(jobs):
    """``first_params`` (the embedding, used on rank 0) and ``last_params``
    (the head, used on the last rank) come out whole on every rank, as
    JAX's auto-inserted pvary gives; the stage blocks' gradients too. The
    loss is the mean of the squared logits, so that the gradients are O(1)
    and the JAX gradient tests' 1e-4 applies (the sum's reach 4e3, where
    float32 sums in another order differ by 1e-3)."""
    run, stacked, emb, head, tokens = _hetero()
    want = jax.jit(jax.grad(
        lambda wt, e, hd: jnp.mean(run(wt, e, hd, tokens) ** 2),
        argnums=(0, 1, 2)))(stacked, emb, head)
    res = jobs.get("pipeline")
    for name in ("w1", "w2"):
        _close(_cat(res, f"hetero_grad_{name}", 0), want[0][name], 1e-4)
    for r in res:
        _close(r["hetero_grad_emb"], want[1], 1e-4)
        _close(r["hetero_grad_head"], want[2], 1e-4)


def test_pipeline_rounds_interleaved_placement_matches_jax(jobs):
    c = w.PIPE_ROUNDS
    rounds = c["rounds"]
    stages = _stages(c, N * rounds)
    x = jnp.asarray(w.rand((c["m"], c["mb"], c["d"]), c["x_seed"]))
    loss, want = _jax_pipe_grad(_tanh_stage, jax_stack(stages, n_ranks=N),
                                x, rounds=rounds)
    y = x
    for s in stages:
        y = _tanh_stage(s, y)
    res = jobs.get("pipeline")
    for r in res:
        np.testing.assert_allclose(float(r["rounds_loss"]), float(loss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(r["rounds_loss"]),
                                   float(jnp.sum(y ** 2)), rtol=1e-5)
    _close(_cat(res, "rounds_grad_block", 0), want, 1e-4)


def test_pipeline_rejects_params_without_rounds_axis(jobs):
    for r in jobs.get("pipeline"):
        assert "leading rounds=2" in str(r["rounds_error"])


@pytest.mark.parametrize("n_ranks", [None, 4, 2])
def test_stack_stage_params_order_matches_jax(n_ranks):
    stages = [{"a": w.rand((3,), i), "b": [w.rand((2, 2), 10 + i)]}
              for i in range(8 if n_ranks != 2 else 6)]
    if n_ranks is None:
        stages = stages[:4]
    want = jax_stack([jax.tree.map(jnp.asarray, s) for s in stages],
                     n_ranks=n_ranks)
    got = tpar.stack_stage_params(
        [{"a": torch.tensor(s["a"]), "b": [torch.tensor(s["b"][0])]}
         for s in stages], n_ranks=n_ranks)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(want["b"][0]))
    with pytest.raises(ValueError, match="not divisible"):
        tpar.stack_stage_params([torch.zeros(1)] * 6, n_ranks=4)


# -- MoE -------------------------------------------------------------------

def _moe_inputs():
    c = w.MOE
    return (w.rand((c["tokens"], c["d"]), 0), w.rand((c["d"], c["e"]), 1),
            w.rand((c["e"], c["d"], c["f"]), 2),
            w.rand((c["e"], c["f"], c["d"]), 3))


def test_moe_expert_parallel_matches_single(jobs):
    c = w.MOE
    x, wg, wi, wo = (jnp.asarray(a) for a in _moe_inputs())
    kw = dict(k=c["k"], capacity_factor=c["capacity_factor"])
    y_ref, _ = jax_moe_apply(x, wg, wi, wo, **kw)
    y_ep, aux_ep = jax.jit(shard_map(
        lambda x, wg, wi, wo: (lambda y, a: (y, jnp.array([a])))(
            *jax_moe_apply(x, wg, wi, wo, axis_name="ep", **kw)),
        mesh=_mesh("ep"), in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=(P("ep"), P("ep"))))(x, wg, wi, wo)
    res = jobs.get("moe")
    got = _cat(res, "y", 0)
    _close(got, y_ref, 2e-4)
    _close(got, y_ep, 2e-4)
    for r in res:
        np.testing.assert_allclose(float(r["aux"]), float(aux_ep[0]),
                                   rtol=1e-5)


def test_moe_gate_gradient_matches_replicated_oracle(jobs):
    c = w.MOE
    x, wg, wi, wo = (jnp.asarray(a) for a in _moe_inputs())
    g_ref = jax.grad(lambda g: jnp.sum(jax_moe_apply(
        x, g, wi, wo, k=c["k"], capacity_factor=c["capacity_factor"])[0]
        ** 2))(wg)
    for r in jobs.get("moe"):
        _close(r["grad_gate"], g_ref, 2e-3)


@pytest.mark.parametrize("k,cf", [(1, 0.124), (2, 1.25), (2, 8.0)])
def test_moe_single_program_matches_jax(k, cf):
    """``moe_apply`` with no axis: outputs, aux loss and every weight's
    gradient against the JAX package's; with capacity_factor 0.124 most
    tokens drop (zero rows), as ``test_moe_capacity_drops_tokens`` pins."""
    x, wg, wi, wo = _moe_inputs()
    kw = dict(k=k, capacity_factor=cf)

    def jloss(*a):
        y, aux = jax_moe_apply(*a, **kw)
        return jnp.sum(y ** 2) + aux, (y, aux)
    (_, (y_j, aux_j)), g_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in (x, wg, wi, wo)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, wg, wi, wo)]
    y_t, aux_t = tmoe.moe_apply(*leaves, **kw)
    ((y_t ** 2).sum() + aux_t).backward()
    _close(y_t.detach(), y_j, 2e-4)
    np.testing.assert_allclose(float(aux_t.detach()), float(aux_j),
                               rtol=1e-5)
    for leaf, g in zip(leaves, g_j):
        _close(leaf.grad, g, 2e-3)
    if cf < 1:
        assert int(np.sum(np.all(y_t.detach().numpy() == 0.0, -1))) > 0


def test_moe_layer_from_flax_params_matches_flax():
    layer = JaxMoELayer(n_experts=4, d_ff=32)
    x = w.rand((2, 8, 16), 9)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, state = layer.apply(variables, jnp.asarray(x), mutable=["losses"])
    port = tmoe.MoELayer(16, 4, 32)
    port.load_state_dict(tmoe.params_from_flax(
        jax.tree.map(np.asarray, variables)))
    got = port(torch.tensor(x))
    _close(got.detach(), want, 2e-5)
    np.testing.assert_allclose(
        float(port.aux_loss),
        float(state["losses"]["moe_aux_loss"][0]), rtol=1e-5)
    # lecun-normal initialisation: variance 1/fan_in, nothing past 2 std
    fresh = tmoe.MoELayer(256, 8, 64, generator=torch.Generator()
                          .manual_seed(0))
    for p, fan_in in ((fresh.w_gate, 256), (fresh.w_in, 256),
                      (fresh.w_out, 64)):
        std = fan_in ** -0.5
        assert abs(float(p.std()) / std - 1.0) < 0.05
        assert float(p.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6


# -- the merge -------------------------------------------------------------

def test_merge_matches_jax_and_keeps_two_empty_partials_finite():
    rng = np.random.RandomState(4)
    o1, o2 = rng.randn(2, 3, 5, 8).astype(np.float32)
    lse1, lse2 = rng.randn(2, 3, 5).astype(np.float32) * 3
    lse2[:, :2] = -1e30          # rows where the second partial saw no key
    lse1[0] = lse2[0] = -1e30    # rows where neither did
    o1[0] = o2[0] = 0.0
    want_o, want_lse = jax_merge(*(jnp.asarray(a)
                                   for a in (o1, lse1, o2, lse2)))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (o1, lse1, o2, lse2)]
    got_o, got_lse = port_merge(*leaves)
    _close(got_o.detach(), want_o, 1e-6)
    _close(got_lse.detach(), want_lse, 1e-6)
    assert bool((got_o[0] == 0).all())
    assert float(got_lse[0].max()) < -1e29
    (got_o.sum() + got_lse[1:].sum()).backward()
    for leaf in leaves:
        assert bool(torch.isfinite(leaf.grad).all())

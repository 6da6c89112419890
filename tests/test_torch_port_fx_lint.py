"""The port's traced-program analyzer (``horovod_tpu_torch/analysis/fx_lint.py``)
against the JAX package's jaxpr analyzer (``horovod_tpu/analysis/jaxpr_lint.py``).

Every case of ``tests/test_lint.py::TestJaxprRules`` has a torch twin here:
the JAX analyzer runs on the JAX case, the port's on the twin, and the rule
lists must be equal. ``test_unbound_axis_structural`` cannot run on jax
0.9.0 (``jax.core.extend_axis_env_nd`` is gone), so its twin is held to the
rule itself. The JAX ``shard_map`` binds its axis; the port's twin binds it
with a ``DeviceMesh`` dimension of a one-rank gloo world.

Beside the twins: a lint trace launches no kernel and issues no collective
(the flash wrapper records a graph node instead of launching, on fake CUDA
tensors), and ``tpu_compile(verify=...)`` checks each forward signature
once, in its three modes, with training steps bit-equal to an unchecked
bridge's.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as thvd
from horovod_tpu_torch import analysis
from horovod_tpu_torch.analysis import fx_lint
from horovod_tpu_torch.exceptions import CollectiveLintError
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import axis as ax
from horovod_tpu_torch.torch import compile as tcompile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"hvd": 8}


def rules_of(diags):
    return sorted(d.rule for d in diags)


# -- the JAX cases (tests/test_lint.py::TestJaxprRules) and their twins --------

def _jax_cases():
    import jax
    import jax.numpy as jnp
    from jax import lax

    def rank_cond(x):
        pred = lax.axis_index("hvd") == 0
        return lax.cond(pred, lambda y: lax.psum(y, "hvd"), lambda y: y, x)

    def data_cond(x):
        return lax.cond(x.sum() > 0, lambda y: lax.psum(y, "hvd"),
                        lambda y: -y, x)

    def rank_while(x):
        i = lax.axis_index("hvd")
        return lax.while_loop(lambda c: c[0] < i,
                              lambda c: (c[0] + 1, lax.psum(c[1], "hvd")),
                              (0, x))

    def invariant_while(x):
        return lax.while_loop(lambda c: c[0] < 3,
                              lambda c: (c[0] + 1, lax.psum(c[1], "hvd")),
                              (0, x))

    def mismatched(x):
        pred = lax.axis_index("hvd") == 0
        return lax.cond(
            pred, lambda y: lax.psum(y, "hvd"),
            lambda y: lax.psum(y.astype(jnp.bfloat16),
                               "hvd").astype(jnp.float32), x)

    def matching(x):
        pred = lax.axis_index("hvd") == 0
        return lax.cond(pred, lambda y: lax.psum(y * 2, "hvd"),
                        lambda y: lax.psum(y + 1, "hvd"), x)

    return {
        "unbound_axis_at_trace_time": (lambda x: lax.psum(x, "tp"),
                                       jnp.ones(4), AXES),
        "declared_axis_is_clean": (lambda x: lax.pmean(x, "hvd"),
                                   jnp.ones(4), AXES),
        "rank_dependent_cond": (rank_cond, jnp.float32(1.0), AXES),
        "data_dependent_cond_is_clean": (data_cond, jnp.ones(4), AXES),
        "rank_dependent_while": (rank_while, jnp.float32(1.0), AXES),
        "invariant_while_is_clean": (invariant_while, jnp.float32(1.0),
                                     AXES),
        "mismatched_branch_collectives": (mismatched, jnp.ones(4), AXES),
        "matching_branch_collectives_no_103": (matching, jnp.ones(4), AXES),
        "collective_through_jit_is_seen": (
            jax.jit(lambda x: lax.psum(x, "tp")), jnp.ones(4), AXES),
        "clean_function": (jax.jit(lambda x: x * 2), jnp.ones(3), None),
    }


def _port_rank_cond(x):
    pred = ax.axis_index("hvd") == 0
    return torch.cond(pred, lambda y: ax.psum(y, "hvd"),
                      lambda y: y.clone(), (x,))


def _port_data_cond(x):
    return torch.cond(x.sum() > 0, lambda y: ax.psum(y, "hvd"),
                      lambda y: -y, (x,))


def _port_rank_while(x):
    i = ax.axis_index("hvd")
    return torch.while_loop(lambda c, y: c < i,
                            lambda c, y: (c + 1, ax.psum(y, "hvd")),
                            (torch.tensor(0), x))


def _port_invariant_while(x):
    return torch.while_loop(lambda c, y: c < 3,
                            lambda c, y: (c + 1, ax.psum(y, "hvd")),
                            (torch.tensor(0), x))


def _port_mismatched(x):
    pred = ax.axis_index("hvd") == 0
    return torch.cond(
        pred, lambda y: ax.psum(y, "hvd"),
        lambda y: ax.psum(y.to(torch.bfloat16), "hvd").float(), (x,))


def _port_matching(x):
    pred = ax.axis_index("hvd") == 0
    return torch.cond(pred, lambda y: ax.psum(y * 2, "hvd"),
                      lambda y: ax.psum(y + 1, "hvd"), (x,))


def _port_through_checkpoint(x):
    # The port's remat region (models/_remat.py) is the nested call a
    # jax.jit is in the JAX case.
    from torch.utils.checkpoint import checkpoint
    return checkpoint(lambda y: ax.psum(y, "tp"), x, use_reentrant=False)


PORT_CASES = {
    "unbound_axis_at_trace_time": (lambda x: ax.psum(x, "tp"),
                                   torch.ones(4), AXES),
    "declared_axis_is_clean": (lambda x: ax.pmean(x, "hvd"), torch.ones(4),
                               AXES),
    "rank_dependent_cond": (_port_rank_cond, torch.tensor(1.0), AXES),
    "data_dependent_cond_is_clean": (_port_data_cond, torch.ones(4), AXES),
    "rank_dependent_while": (_port_rank_while, torch.tensor(1.0), AXES),
    "invariant_while_is_clean": (_port_invariant_while, torch.tensor(1.0),
                                 AXES),
    "mismatched_branch_collectives": (_port_mismatched, torch.ones(4),
                                      AXES),
    "matching_branch_collectives_no_103": (_port_matching, torch.ones(4),
                                           AXES),
    "collective_through_jit_is_seen": (_port_through_checkpoint,
                                       torch.ones(4), AXES),
    "clean_function": (lambda x: x * 2, torch.ones(3), None),
}

EXPECTED = {
    "unbound_axis_at_trace_time": ["HVD101"],
    "declared_axis_is_clean": [],
    "rank_dependent_cond": ["HVD102"],
    "data_dependent_cond_is_clean": [],
    "rank_dependent_while": ["HVD102"],
    "invariant_while_is_clean": [],
    "mismatched_branch_collectives": ["HVD102", "HVD103"],
    "matching_branch_collectives_no_103": ["HVD102"],
    "collective_through_jit_is_seen": ["HVD101"],
    "clean_function": [],
}


@pytest.fixture(scope="module")
def jax_rules():
    from horovod_tpu import analysis as jax_analysis
    return {name: rules_of(jax_analysis.check_fn(fn, x, axis_sizes=sizes))
            for name, (fn, x, sizes) in _jax_cases().items()}


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_twin_gives_the_jax_rule_list(case, jax_rules):
    fn, x, sizes = PORT_CASES[case]
    got = rules_of(analysis.check_fn(fn, x, axis_sizes=sizes))
    assert got == jax_rules[case] == EXPECTED[case]


def test_unbound_axis_structural_twin_holds_the_rule():
    # The JAX case traces under extend_axis_env_nd([hvd, tp]) and checks
    # with only hvd bound; its JAX side fails on jax 0.9.0 (ROADMAP C).
    gm = fx_lint.trace(lambda x: ax.psum(x, "tp"), torch.tensor(1.0),
                       axis_sizes={"hvd": 8, "tp": 2})
    assert rules_of(analysis.check_graph(gm, bound_axes={"hvd"})) == \
        ["HVD101"]
    # negative: the axis IS declared bound
    assert analysis.check_graph(gm, bound_axes={"hvd", "tp"}) == []


def test_enforce_raises_on_errors():
    diags = analysis.check_fn(lambda x: ax.psum(x, "tp"), torch.ones(4),
                              axis_sizes=AXES)
    with pytest.raises(CollectiveLintError) as err:
        analysis.enforce(diags, True, what="test")
    assert "HVD101" in str(err.value)
    # warn mode never raises
    analysis.enforce(diags, "warn", what="test")
    analysis.enforce(diags, False, what="test")


def test_findings_carry_the_source_line_of_the_cond_and_the_call():
    [cond] = analysis.check_fn(_port_rank_cond, torch.tensor(1.0),
                               axis_sizes=AXES)
    src = open(__file__).read().splitlines()
    assert cond.file == os.path.abspath(__file__)
    assert "torch.cond(" in src[cond.line - 1]
    [call] = analysis.check_fn(lambda x: ax.psum(x, "tp"), torch.ones(4),
                               axis_sizes=AXES)
    assert "ax.psum(x, \"tp\")" in src[call.line - 1]
    # the messages are the JAX analyzer's, in the port's terms
    assert cond.message.startswith("cond predicate depends on axis_index")
    assert call.message.startswith("collective `psum` uses axis 'tp'")


def test_trace_records_collectives_with_shapes_and_taints_closures():
    def fn(x):
        g = ax.all_gather(x, "hvd", dim=0)
        s = ax.psum_scatter(g, "hvd", dim=0)
        a = ax.all_to_all(g.reshape(8, 8), "hvd", split_axis=0,
                          concat_axis=1)
        return s, a, ax.ppermute(x, [(0, 1), (1, 0)], "hvd")

    gm = fx_lint.trace(fn, torch.ones(8), axis_sizes=AXES)
    recs = [(n.args[1], tuple(n.meta["val"].shape)) for n in gm.graph.nodes
            if fx_lint._is_op(n, "collective")]
    assert recs == [("all_gather", (64,)), ("psum_scatter", (8,)),
                    ("all_to_all", (1, 64)), ("ppermute", (8,))]
    # an axis_index of a name bound nowhere fails the trace: HVD101
    assert rules_of(analysis.check_fn(lambda x: x * ax.axis_index("tp"),
                                      torch.ones(3), axis_sizes=AXES)) == \
        ["HVD101"]


def test_a_lint_trace_launches_no_kernel(monkeypatch):
    """Fake CUDA tensors reach the flash wrapper's kernel path: under the
    trace it records one ``hvd_lint::kernel`` node per launch site, builds
    nothing and counts nothing."""
    from horovod_tpu_torch import _build

    def no_build(*a, **k):
        raise AssertionError("a lint trace must not build or load kernels")
    monkeypatch.setattr(_build, "load", no_build)
    tfa.reset_launches()

    def fn(x):
        bh, s, d = 2, 128, 64
        q, k, v = (torch.empty_strided((bh, s, d), (s * d, d, 1),
                                       dtype=torch.bfloat16, device="cuda")
                   for _ in range(3))
        o, lse = tfa.attention_fwd(q, k, v, (0, 0, s), 0.125, True)
        return ax.psum(o.float().sum() + x, "hvd"), lse

    gm = fx_lint.trace(fn, torch.ones(()), axis_sizes=AXES)
    kernels = [n.args[0] for n in gm.graph.nodes
               if fx_lint._is_op(n, "kernel")]
    assert kernels == ["fwd"]
    assert not any(tfa.LAUNCHES.values())
    assert analysis.check_graph(gm, axis_sizes=AXES) == []


def test_string_axes_at_run_time():
    with pytest.raises(ValueError, match="names no process group"):
        ax.psum(torch.ones(2), "tp")
    assert not fx_lint.tracing()


# -- bound by a live group: the world and a DeviceMesh dimension ---------------

@pytest.fixture
def world(tmp_path):
    """A one-rank gloo world (the process's own, if one is up)."""
    if dist.is_initialized():
        assert dist.get_world_size() == 1
        yield dist.group.WORLD
        return
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_shard_map_twin_a_device_mesh_binds_its_axis(world):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu import analysis as jax_analysis
    from torch.distributed.device_mesh import init_device_mesh

    mesh = Mesh(np.array(jax.devices()), ("hvd",))
    jfn = shard_map(lambda x: lax.psum(x, "hvd"), mesh=mesh,
                    in_specs=P("hvd"), out_specs=P())
    assert jax_analysis.check_fn(jfn, jnp.ones(8)) == []
    tmesh = init_device_mesh("cpu", (1,), mesh_dim_names=("hvd",))
    assert analysis.check_fn(lambda x: ax.psum(x, tmesh),
                             torch.ones(8)) == []
    gm = fx_lint.trace(lambda x: ax.psum(x, tmesh), torch.ones(8))
    [node] = [n for n in gm.graph.nodes if fx_lint._is_op(n, "collective")]
    assert node.args[2:4] == ("hvd", True)
    # The world group is "hvd", bound by itself; so is the name while
    # torch.distributed is initialized. Another name is not.
    assert analysis.check_fn(lambda x: ax.psum(x, world), torch.ones(2)) \
        == []
    assert analysis.check_fn(lambda x: ax.psum(x, "hvd"), torch.ones(2)) \
        == []
    assert rules_of(analysis.check_fn(lambda x: ax.psum(x, "tp"),
                                      torch.ones(2))) == ["HVD101"]
    # At run time "hvd" is the world group (one rank: the identity).
    assert torch.equal(ax.psum(torch.arange(3.0), "hvd"), torch.arange(3.0))


class _RankGuarded(torch.nn.Module):
    """A psum under a cond on the rank: rank 0 of a one-rank world takes
    the other branch at run time, so only the lint sees the hazard."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))

    def forward(self, x):
        y = x * self.w
        return {"loss": torch.cond(ax.axis_index("hvd") == 5,
                                   lambda t: ax.psum(t, "hvd"),
                                   lambda t: t * 2, (y,)).sum()}


@pytest.fixture
def port(monkeypatch):
    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "always")
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def test_verify_modes_on_the_bridge(port, world):
    import logging
    from horovod_tpu_torch.utils.logging_util import get_logger
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    get_logger().addHandler(handler)
    x = torch.arange(3.0)
    checked = tcompile.tpu_compile(_RankGuarded(), verify=True)
    with pytest.raises(CollectiveLintError, match="HVD102"):
        checked(x=x)
    assert checked._verified == set()   # a refused signature is re-checked
    warned = tcompile.tpu_compile(_RankGuarded(), verify="warn")
    try:
        out = warned(x=x)
    finally:
        get_logger().removeHandler(handler)
    assert float(out["loss"]) == 6.0
    assert any("HVD102" in r.getMessage() for r in records)
    assert warned._verified == {(False, False, ("x",))}
    plain = tcompile.tpu_compile(_RankGuarded())
    assert float(plain(x=x)["loss"]) == 6.0 and plain._verified == set()


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_verify_is_trace_only_and_the_steps_are_bit_equal(port,
                                                          monkeypatch):
    """chip_smoke.py's BERT stand-in, narrow, in train mode with dropout
    (the keep-mask mode on the CPU): three SGD steps through a bridge with
    ``verify=True`` equal, bit for bit, those of one without. The check
    traces the train signature once, before its first step."""
    cs = _chip_smoke()
    cfg = cs.BertConfig(hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=128,
                        vocab_size=512, max_position_embeddings=64)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 64)))
    batch = {"input_ids": ids, "labels": ids}
    runs = {}
    for verify in (True, False):
        model = cs.BertForMaskedLM(cfg, generator=torch.Generator()
                                   .manual_seed(1))
        comp = tcompile.tpu_compile(model, verify=verify)
        step = comp.make_train_step(torch.optim.SGD(comp.params.values(),
                                                    lr=0.1))
        tfa.reset_launches()
        losses = [step(batch, rng=i).item() for i in range(3)]
        runs[verify] = (losses, {k: v.detach().clone()
                                 for k, v in comp.params.items()},
                        comp._verified, dict(tfa.LAUNCHES))
    (l1, p1, v1, n1), (l0, p0, v0, n0) = runs[True], runs[False]
    assert l1 == l0
    assert all(torch.equal(p1[k], p0[k]) for k in p0)
    assert v1 == {(True, True, ("input_ids", "labels"))} and v0 == set()
    assert n1 == n0

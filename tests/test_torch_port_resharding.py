"""The port's ``resharding/`` and partial ``analysis/costmodel.py`` against
the JAX package's, on the CPU.

In process: on the specs of ``tests/test_resharding.py``, ``Spec``'s
ownership and signature, ``plan_redistribution``'s strategy, steps,
copies, prices and signature, and ``execute_host``'s buffers (bit-equal)
and peak bytes are the JAX package's; the cost model's kinds and times
are too. A 4-rank gloo job (tests/torch_port_sharding_worker.py, mode
``reshard``) runs ``make_jit_executor`` over a one-axis ``DeviceMesh`` and
``execute_group`` over the world group; each rank's buffers are held to
the JAX package's ``make_jit_executor`` on 4 host devices and
``execute_host`` (bit-equal), mixed dtypes to the port's own
``execute_host``. ``Program.prove``, ``sim_stream`` and ``check_streams``
give the JAX package's verdicts: every program proves clean, a dropped
comm step is HVD501 and a flipped kind HVD502 in both packages.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu import resharding as J
from horovod_tpu.analysis import costmodel as jcost
from horovod_tpu.ops.zero import plan_zero as jplan

import torch_port_sharding_worker as w
from horovod_tpu_torch import resharding as T
from horovod_tpu_torch.analysis import costmodel as tcost
from horovod_tpu_torch.ops.zero import plan_zero as tplan


def _meta(*shapes, dtype="float32"):
    return [(tuple(s), dtype) for s in shapes]


def _plans(meta, n):
    return (jplan([jax.ShapeDtypeStruct(s, d) for s, d in meta], n),
            tplan([torch.empty(s, dtype=getattr(torch, d), device="meta")
                   for s, d in meta], n))


def _both(build, meta):
    """``build(pkg, plan_of)`` for each package: (JAX spec, port spec)."""
    def plan_of(pkg):
        return lambda m, n: _plans(m, n)[0 if pkg is J else 1]
    return build(J, plan_of(J)), build(T, plan_of(T))


def _np(bufs):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor)
                          and v.dtype == torch.bfloat16 else v)
            for k, v in bufs.items()}


# Spec pairs of tests/test_resharding.py (and its property test's kinds).
def _case_zero_to_rep(pkg, plan):
    meta = _meta((37,), (13, 5), (5,))
    return (pkg.zero_flat_spec(plan(meta, 4), axis="z"),
            pkg.replicated_spec(3, {"s": 2}), meta, None)


def _case_zero4_zero2(pkg, plan):
    meta = _meta((37,), (13, 5), (5,))
    return (pkg.zero_flat_spec(plan(meta, 4), axis="z"),
            pkg.zero_flat_spec(plan(meta, 2), axis="z"), meta, None)


def _case_rows(pkg, plan):
    meta = _meta((13, 5))
    return (pkg.zero_flat_spec(plan(meta, 4), axis="z"),
            pkg.Spec({"s": 3}, [pkg.Sharded("s", 0, even=False)]), meta,
            None)


def _case_cost(pkg, plan):
    meta = _meta((64, 64))
    return (pkg.zero_flat_spec(plan(meta, 4), axis="z"),
            pkg.replicated_spec(1, {"s": 4}), meta, None)


def _case_budget(pkg, plan):
    meta = _meta((512, 64))
    return (pkg.zero_flat_spec(plan(meta, 4), axis="z"),
            pkg.replicated_spec(1, {"s": 2}), meta, 4096)


def _case_local(pkg, plan):
    meta = _meta((16, 4))
    spec = pkg.zero_flat_spec(plan(meta, 4), axis="z")
    return spec, spec, meta, None


def _case_pending(pkg, plan):
    meta = _meta((8, 4))
    return (pkg.Spec({"d": 4}, [pkg.Replicated()], pending_sum=True),
            pkg.Spec({"d": 4}, [pkg.Sharded("d", 0)]), meta, None)


def _case_jit(pkg, plan):
    meta = w.JIT_CASE["meta"]
    return (pkg.zero_flat_spec(plan(meta, 4), axis="hvd"),
            pkg.Spec({"hvd": 4}, [pkg.Sharded("hvd", 1),
                                  pkg.Sharded("hvd", 0)]), meta, None)


def _case_2d(pkg, plan):
    meta = _meta((8, 4), (4,), (8,))
    local = [(8, 2), (2,), (8,)]
    lay = [pkg.Sharded("tp", 1), pkg.Sharded("tp", 0), pkg.Replicated()]
    return (pkg.Spec({"dp": 2, "tp": 2}, lay, zero=pkg.ZeroFlat(
                "dp", plan([(s, "float32") for s in local], 2))),
            pkg.Spec({"dp": 1, "tp": 2}, lay, zero=pkg.ZeroFlat(
                "dp", plan([(s, "float32") for s in local], 1))),
            meta, None)


CASES = {"zero_to_rep": _case_zero_to_rep, "zero4_zero2": _case_zero4_zero2,
         "rows": _case_rows, "cost": _case_cost, "budget": _case_budget,
         "local": _case_local, "pending": _case_pending, "jit": _case_jit,
         "2d": _case_2d}


def _programs(name):
    (js, jd, meta, bucket), (ts, td, _, _) = _both(CASES[name], None)
    return (J.plan_redistribution(js, jd, meta, bucket_bytes=bucket),
            T.plan_redistribution(ts, td, meta, bucket_bytes=bucket), meta)


def _copies(step):
    return [(c.leaf, c.src_rank, c.src_buf, c.src_off, c.dst_rank,
             c.dst_buf, c.dst_off, c.length) for c in step.copies]


# -- specs -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_spec_ownership_and_signature_match_jax(name):
    (js, jd, meta, _), (ts, td, _, _) = _both(CASES[name], None)
    for a, b in ((js, ts), (jd, td)):
        assert a.signature() == b.signature()
        assert a.world == b.world
        for r in range(a.world):
            got = [[(iv.g0, iv.length, iv.buf, iv.b0) for iv in ivs]
                   for ivs in b.ownership(meta, r)]
            want = [[(iv.g0, iv.length, iv.buf, iv.b0) for iv in ivs]
                    for ivs in a.ownership(meta, r)]
            assert got == want
            assert b.local_buffers(meta, r) == a.local_buffers(meta, r)


def test_spec_validation_and_helpers_match_jax():
    spec = T.Spec({"t": 2}, [T.Sharded("t", 1)])
    with pytest.raises(ValueError):
        spec.validate(_meta((4, 7)))
    with pytest.raises(ValueError):
        T.Spec({"t": 0}, [])
    with pytest.raises(ValueError):
        T.Spec({"t": 2}, [T.Sharded("u", 0)])
    jp, tp = _plans(_meta((10,), (3, 4), (7, 2)), 2)
    assert T.leaf_offsets(tp) == J.leaf_offsets(jp)
    assert T.zero_flat_spec(tp, axis="z", extra_axes={"x": 3}).signature() \
        == J.zero_flat_spec(jp, axis="z", extra_axes={"x": 3}).signature()
    tree = {"b": torch.zeros(3, 2, dtype=torch.bfloat16),
            "a": [np.zeros(4, np.int32), torch.zeros(())]}
    assert T.tree_meta_of(tree) == [((4,), "int32"), ((), "float32"),
                                    ((3, 2), "bfloat16")]
    assert T.tree_meta_of({"b": np.zeros((3, 2), np.float32),
                           "a": [np.zeros(4, np.int32), np.zeros((), np.float32)]}) \
        == J.tree_meta_of({"b": jnp.zeros((3, 2)),
                           "a": [jnp.zeros(4, jnp.int32), jnp.zeros(())]})


# -- planner ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax(name):
    jprog, tprog, _ = _programs(name)
    assert tprog.signature() == jprog.signature()
    assert tprog.sig8 == jprog.sig8
    assert tprog.strategy == jprog.strategy
    assert tprog.predicted_s == jprog.predicted_s
    assert tprog.candidates == jprog.candidates
    assert tprog.bytes_moved() == jprog.bytes_moved()
    assert tprog.comm_steps() == jprog.comm_steps()
    assert [(s.index, s.kind, s.op, s.name, s.nbytes, s.total_bytes)
            for s in tprog.steps] == \
        [(s.index, s.kind, s.op, s.name, s.nbytes, s.total_bytes)
         for s in jprog.steps]
    for a, b in zip(jprog.steps, tprog.steps):
        assert _copies(b) == _copies(a)
    for r in range(max(jprog.src.world, jprog.dst.world)):
        assert tprog.leg_digests(r) == jprog.leg_digests(r)


@pytest.mark.parametrize("meta", [_meta((8,), (4,)), _meta((7,))])
def test_plan_rejects_what_jax_rejects(meta):
    def plan(pkg):
        spec = pkg.Spec({"d": 2}, [pkg.Sharded("d", 0)])
        try:
            return pkg.plan_redistribution(spec, spec, meta).strategy
        except ValueError as e:
            return type(e).__name__
    assert plan(T) == plan(J) == "ValueError"


@pytest.mark.parametrize("kind", ["allreduce", "allgather_async",
                                  "grouped_reducescatter", "psum_scatter",
                                  "alltoall", "ppermute", "broadcast",
                                  "barrier", "sparse_allreduce", "pmax",
                                  None])
@pytest.mark.parametrize("world", [1, 2, 3, 8, 256])
def test_cost_model_matches_jax(kind, world):
    assert tcost.canonical_kind(kind) == jcost.canonical_kind(kind)
    for nbytes in (0, 1 << 20):
        assert tcost.collective_time(kind, nbytes, world) == \
            jcost.collective_time(kind, nbytes, world)
    table = {"kinds": {"allgather": {"alpha_s": 3e-6, "byte_s": 2e-10}}}
    assert tcost.collective_time(kind, 4096, world, table) == \
        jcost.collective_time(kind, 4096, world, table)
    assert tcost.DEFAULT_TABLE == jcost.DEFAULT_TABLE


def _events(stream):
    return [(ev.kind, ev.name, ev.pset, ev.op, ev.line) for ev in stream]


@pytest.mark.parametrize("name", sorted(CASES))
def test_prove_and_sim_stream_match_jax(name):
    jprog, tprog, _ = _programs(name)
    assert _events(tprog.sim_stream()) == _events(jprog.sim_stream())
    for world in (None, 2, 5):
        assert tprog.prove(world) == [] == jprog.prove(world)
    if name == "local":
        assert all(ev.pset == "local" for ev in tprog.sim_stream())


def _corrupt(pkg, prog, how):
    streams = {r: prog.sim_stream() for r in range(4)}
    comm = [i for i, ev in enumerate(streams[2]) if ev.pset == "global"]
    assert comm, "program has no comm step to corrupt"
    if how == "drop":
        del streams[2][comm[0]]
    else:
        ev = copy.copy(streams[2][comm[0]])
        ev.kind = "alltoall" if ev.kind != "alltoall" else "allgather"
        streams[2][comm[0]] = ev
    return pkg.check_streams(streams)


@pytest.mark.parametrize("how,rule", [("drop", "HVD501"),
                                      ("flip", "HVD502")])
@pytest.mark.parametrize("name", ["zero_to_rep", "2d", "pending"])
def test_corrupted_streams_are_proven_like_jax(name, how, rule):
    jprog, tprog, _ = _programs(name)
    got, want = _corrupt(T, tprog, how), _corrupt(J, jprog, how)
    assert [d.rule for d in got] == [d.rule for d in want] == [rule]
    assert [(d.severity, d.message, d.trace) for d in got] == \
        [(d.severity, d.message, d.trace) for d in want]


class _Board(dict):
    def put(self, key, value):
        self[key] = value


def test_verify_consistency_catches_a_divergent_program():
    from horovod_tpu_torch.exceptions import CollectiveMismatchError
    _, prog, meta = _programs("zero_to_rep")
    other = T.plan_redistribution(prog.src, prog.dst, meta, bucket_bytes=64)
    board = _Board()
    prog.verify_consistency(board=board, rank=0, size=1)   # no peers
    for r in (1, 2, 3):
        for leg, digest in other.leg_digests(r).items():
            from horovod_tpu_torch import guardian
            board.put(f"reshard.plan.{leg}.{r}",
                      guardian.render_digest(digest))
    with pytest.raises(CollectiveMismatchError, match="redistribution"):
        prog.verify_consistency(board=board, rank=0, size=4, timeout_s=0.5)
    same = _Board()
    for r in range(4):
        for leg, digest in prog.leg_digests(r).items():
            from horovod_tpu_torch import guardian
            same.put(f"reshard.plan.{leg}.{r}",
                     guardian.render_digest(digest))
    prog.verify_consistency(board=same, rank=0, size=4, timeout_s=0.5)


# -- host executor ---------------------------------------------------------

def _seed(pkg, spec, meta, per_rank):
    return {r: pkg.buffers_of_tree(spec, meta, per_rank[r], r)
            for r in range(spec.world)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_execute_host_is_the_jax_executor_bit_for_bit(name):
    jprog, tprog, meta = _programs(name)
    leaves = w.rand_tree(meta, 7)
    per_rank = {r: [lv * (r + 1) for lv in leaves]
                for r in range(jprog.src.world)} if jprog.src.pending_sum \
        else {r: leaves for r in range(jprog.src.world)}
    jbufs = _seed(J, jprog.src, meta, per_rank)
    tbufs = _seed(T, tprog.src, meta, per_rank)
    for r in jbufs:
        assert _np(tbufs[r]).keys() == jbufs[r].keys()
        for k in jbufs[r]:
            np.testing.assert_array_equal(_np(tbufs[r])[k], jbufs[r][k])
    jl, tl = J.MemoryLedger(), T.MemoryLedger()
    jres, jrep = J.execute_host(jprog, J.reader_for_buffers(jbufs),
                                ledger=jl)
    tres, trep = T.execute_host(tprog, T.reader_for_buffers(tbufs),
                                ledger=tl)
    assert tres.keys() == jres.keys()
    for r in jres:
        got = _np(tres[r])
        assert got.keys() == jres[r].keys()
        for k in jres[r]:
            np.testing.assert_array_equal(got[k], jres[r][k])
    for key in ("strategy", "predicted_s", "peak_bytes", "bytes_by_leg",
                "wire_bytes"):
        assert trep[key] == jrep[key], key
    assert (tl.peak, tl.live) == (jl.peak, jl.live)


@pytest.mark.parametrize("seed", range(6))
def test_random_spec_pairs_match_jax_and_keep_the_bound(seed):
    """tests/test_resharding.py's property test, both packages from the
    same random choices: identity round trips, bit-equal buffers and the
    shard + 2 × bucket peak bound."""
    meta = _meta((8, 4), (24,), (6, 2, 2))
    leaves = w.rand_tree(meta, seed)
    bucket = 256

    def random_spec(pkg, rng, world):
        kind = rng.randint(3)
        axes = {"m": world}
        if kind == 0:
            return pkg.replicated_spec(len(meta), axes)
        if kind == 1:
            lays = []
            for shape, _ in meta:
                dims = [d for d, e in enumerate(shape) if e % world == 0]
                if dims and rng.randint(2):
                    lays.append(pkg.Sharded("m", dims[rng.randint(
                        len(dims))]))
                else:
                    lays.append(pkg.Replicated())
            return pkg.Spec(axes, lays)
        return pkg.zero_flat_spec(
            _plans(meta, world)[0 if pkg is J else 1], axis="m")

    jrng, trng = np.random.RandomState(seed), np.random.RandomState(seed)
    for src_world in (1, 2, 4):
        for dst_world in (1, 2, 4):
            js, ts = random_spec(J, jrng, src_world), \
                random_spec(T, trng, src_world)
            jd, td = random_spec(J, jrng, dst_world), \
                random_spec(T, trng, dst_world)
            assert ts.signature() == js.signature()
            assert td.signature() == jd.signature()
            tf = T.plan_redistribution(ts, td, meta, bucket_bytes=bucket)
            jf = J.plan_redistribution(js, jd, meta, bucket_bytes=bucket)
            assert tf.signature() == jf.signature()
            src_bufs = _seed(T, ts, meta, {r: leaves
                                           for r in range(ts.world)})
            mid, rep = T.execute_host(tf, T.reader_for_buffers(src_bufs))
            jmid, _ = J.execute_host(jf, J.reader_for_buffers(
                _seed(J, js, meta, {r: leaves for r in range(js.world)})))
            for r in jmid:
                for k in jmid[r]:
                    np.testing.assert_array_equal(mid[r][k].numpy(),
                                                  jmid[r][k])
            shard = max(sum(n * np.dtype(d).itemsize for n, d in
                            spec.local_buffers(meta, r).values())
                        for spec in (ts, td) for r in range(spec.world))
            assert rep["peak_bytes"] <= shard + 2 * bucket
            back = T.plan_redistribution(td, ts, meta, bucket_bytes=bucket)
            out, _ = T.execute_host(back, T.reader_for_buffers(mid))
            for r in src_bufs:
                for k, buf in src_bufs[r].items():
                    assert torch.equal(out[r][k], buf)


def test_dtype_override_and_bfloat16_windows():
    meta = [((6, 4), "bfloat16"), ((5,), "float32")]
    _, tp = _plans(meta, 2)
    src = T.zero_flat_spec(tp, axis="z")
    dst = T.replicated_spec(2, {"s": 1})
    leaves = [torch.randn(6, 4, generator=torch.Generator().manual_seed(0))
              .to(torch.bfloat16), torch.arange(5.0)]
    bufs = _seed(T, src, meta, {r: leaves for r in range(2)})
    prog = T.plan_redistribution(src, dst, meta)
    res, _ = T.execute_host(prog, T.reader_for_buffers(bufs))
    assert res[0][("leaf", 0)].dtype == torch.bfloat16
    assert torch.equal(res[0][("leaf", 0)].view(6, 4), leaves[0])
    wide, _ = T.execute_host(prog, T.reader_for_buffers(bufs),
                             dtype_override="float32")
    assert wide[0][("leaf", 0)].dtype == torch.float32
    assert torch.equal(wide[0][("leaf", 0)].view(6, 4), leaves[0].float())


def test_reshard_metrics_flow(monkeypatch):
    from horovod_tpu_torch.telemetry import core
    monkeypatch.setattr(core, "_ENABLED", True)
    monkeypatch.setattr(core, "_FAMILIES", {})
    jprog, tprog, meta = _programs("zero_to_rep")
    leaves = w.rand_tree(meta, 17)
    bufs = _seed(T, tprog.src, meta, {r: leaves for r in range(4)})
    _, report = T.execute_host(tprog, T.reader_for_buffers(bufs))
    assert report["peak_bytes"] > 0
    assert sum(report["bytes_by_leg"].values()) >= tprog.bytes_moved()
    assert {"hvd_reshard_bytes_total", "hvd_reshard_peak_bytes",
            "hvd_reshard_seconds"} <= set(core._FAMILIES)
    assert core._FAMILIES["hvd_reshard_peak_bytes"].value == \
        report["peak_bytes"]


def test_knob_sets_the_bucket_budget(monkeypatch):
    from horovod_tpu_torch.utils import envparse
    _, tprog, meta = _programs("budget")
    monkeypatch.setenv("HVDTPU_RESHARD_BUCKET_BYTES", "8192")
    prog = T.plan_redistribution(tprog.src, tprog.dst, meta)
    assert prog.bucket_bytes == 8192
    monkeypatch.delenv("HVDTPU_RESHARD_BUCKET_BYTES")
    assert T.plan_redistribution(tprog.src, tprog.dst, meta).bucket_bytes \
        == T.DEFAULT_RESHARD_BUCKET_BYTES
    assert envparse.KNOBS["RESHARD_BUCKET_BYTES"]["default"] == "4 MiB"


# -- over a group (4 gloo ranks) -------------------------------------------

@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    j = w.Jobs(tmp_path_factory.mktemp("reshard"), ["reshard"])
    yield j
    j.kill()


def test_jit_executor_matches_the_jax_one(jobs):
    jprog, _, meta = _programs("jit")
    leaves = w.rand_tree(meta, w.JIT_CASE["seed"])
    bufs = _seed(J, jprog.src, meta, {r: leaves for r in range(4)})
    mesh = Mesh(np.array(jax.devices()[:4]), ("hvd",))
    run = J.make_jit_executor(jprog, mesh, "hvd")
    out = run({k: jnp.concatenate([jnp.asarray(bufs[r][k])
                                   for r in range(4)])
               for k in sorted(bufs[0])})
    res = jobs.get("reshard")
    for key in sorted(out):
        want = np.asarray(out[key]).reshape(4, -1)
        for r in range(4):
            np.testing.assert_array_equal(res[r][f"jit_{key[0]}{key[1]}"],
                                          want[r])


def test_jit_executor_refusals():
    _, prog, meta = _programs("zero_to_rep")
    with pytest.raises(NotImplementedError, match="single-axis"):
        T.make_jit_executor(prog, _FakeGroup(4), "z")
    _, pend, _ = _programs("pending")
    with pytest.raises(NotImplementedError, match="pending-sum"):
        T.make_jit_executor(pend, _FakeGroup(4), "d")


class _FakeGroup:
    """Stands in for a process group of ``n`` ranks (the refusals read only
    its size)."""

    def __init__(self, n):
        self.n = n


@pytest.fixture(autouse=True)
def _fake_sizes(monkeypatch):
    import torch.distributed as dist
    real_size, real_rank = dist.get_world_size, dist.get_rank
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: g.n
                        if isinstance(g, _FakeGroup) else real_size(g))
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 0
                        if isinstance(g, _FakeGroup) else real_rank(g))


@pytest.mark.parametrize("name", ["zero4_to_rep2", "zero4_to_zero2",
                                  "zero4_to_rows3", "pending_sum",
                                  "mixed_rep4_to_zero2"])
def test_execute_group_is_the_host_executor_bit_for_bit(jobs, name):
    """Each rank's destination buffers from ``execute_group`` (windows
    read from its own source buffers only, byte views through
    ``all_to_all_single``) equal ``execute_host``'s — the JAX package's
    where numpy has the dtypes, the port's for the bfloat16 leaf."""
    src, dst, meta, per_rank = w.group_cases(T, w.port_plan)[name]
    prog = T.plan_redistribution(src, dst, meta, bucket_bytes=64)
    bufs = _seed(T, src, meta, per_rank)
    want, _ = T.execute_host(prog, T.reader_for_buffers(bufs))
    res = jobs.get("reshard")
    for r in range(dst.world):
        for key, buf in want[r].items():
            got = res[r][f"{name}_{key[0]}{key[1]}"]
            np.testing.assert_array_equal(got, _np({0: buf})[0])
    for r in range(dst.world, 4):
        assert not [k for k in res[r] if k.startswith(name + "_b")
                    or k.startswith(name + "_l")]
    if name != "mixed_rep4_to_zero2":
        js, jd, _, _ = w.group_cases(
            J, lambda m, n: _plans(m, n)[0])[name]
        jprog = J.plan_redistribution(js, jd, meta, bucket_bytes=64)
        jres, _ = J.execute_host(jprog, J.reader_for_buffers(
            _seed(J, js, meta, per_rank)))
        for r in range(dst.world):
            for key, buf in jres[r].items():
                np.testing.assert_array_equal(
                    res[r][f"{name}_{key[0]}{key[1]}"], buf)


def test_execute_group_round_trip_is_the_identity(jobs):
    src, _, meta, per_rank = w.group_cases(T, w.port_plan)["zero4_to_zero2"]
    res = jobs.get("reshard")
    for r in range(4):
        for key, buf in T.buffers_of_tree(src, meta, per_rank[r],
                                          r).items():
            np.testing.assert_array_equal(
                res[r][f"roundtrip_{key[0]}{key[1]}"], buf.numpy())

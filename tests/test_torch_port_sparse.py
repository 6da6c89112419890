"""The port's sparse gradient plane (``horovod_tpu_torch/ops/sparse.py``)
against the JAX package's, on the CPU.

Inputs come from a numpy seed. Tolerances: the int8 row codec's payloads
and scales are bit-equal; scatter-adds equal the JAX package's within
1e-6 (float32 sums of duplicates in another order); the policy, the EMA
and the wire-byte formulas give the same decisions and numbers. Also, in a
single-process job: with ``HVDTPU_SPARSE`` unset a sparse gradient
densifies bit-identically into the dense allreduce; with it set the gather
path scatter-adds locally; the binding's optimizer keeps a sparse
gradient sparse, so that ``torch.optim.SparseAdam`` steps.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
import horovod_tpu_torch.torch as pt
from horovod_tpu.ops import sparse as jsparse
from horovod_tpu_torch import basics, train
from horovod_tpu_torch.ops import reduce_ops, sparse


def _slices(seed, rows=30, width=5, nnz=12, dup=3):
    rng = np.random.RandomState(seed)
    idx = rng.choice(rows, size=nnz, replace=False)
    idx = np.concatenate([idx, idx[:dup]]).astype(np.int64)
    vals = rng.randn(idx.shape[0], width).astype(np.float32)
    vals[1] = 0   # an all-zero row
    return idx, vals, (rows, width)


@pytest.mark.parametrize("shape", [(15, 5), (8, 3, 4), (6,)])
def test_row_codec_bit_equals_the_jax_package(shape):
    import jax.numpy as jnp
    rng = np.random.RandomState(len(shape))
    vals = (rng.randn(*shape) * 10.0 ** rng.randint(-3, 2, size=shape[:1])
            .reshape((-1,) + (1,) * (len(shape) - 1))).astype(np.float32)
    vals[0] = 0
    jq, js = jsparse.encode_rows(jnp.asarray(vals))
    tq, ts = sparse.encode_rows(torch.from_numpy(vals))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        sparse.decode_rows(tq, ts, torch.float32).numpy(),
        np.asarray(jsparse.decode_rows(jq, js, jnp.float32)))


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("op", [reduce_ops.Sum, reduce_ops.Average])
def test_scatter_add_equals_the_jax_package(op, world):
    idx, vals, shape = _slices(world)
    want = np.asarray(jsparse.scatter_add_dense(idx, vals, shape, world, op))
    got = sparse.scatter_add_dense(torch.from_numpy(idx),
                                   torch.from_numpy(vals), shape, world, op)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sparse_gradient_matches_the_jax_package():
    idx, vals, shape = _slices(4)
    j = jsparse.SparseGradient(idx, vals, shape)
    t = sparse.SparseGradient(torch.from_numpy(idx), torch.from_numpy(vals),
                              shape)
    np.testing.assert_allclose(t.densify().numpy(), np.asarray(j.densify()),
                               rtol=1e-6, atol=1e-6)
    jd, td = j.deduplicate(), t.deduplicate()
    np.testing.assert_array_equal(td.indices.numpy(), jd.indices)
    np.testing.assert_allclose(td.values.numpy(), jd.values, rtol=1e-6,
                               atol=1e-6)
    assert td.nnz == jd.nnz == 12
    # A COO tensor with one sparse dim is the same gradient.
    coo = torch.sparse_coo_tensor(torch.from_numpy(idx[None]),
                                  torch.from_numpy(vals), shape)
    v = sparse.SparseGradient.from_coo(coo)
    assert torch.equal(v.indices, td.indices)
    assert torch.equal(v.to_coo().to_dense(), coo.to_dense())


def test_crossover_and_wire_bytes_match_the_jax_package():
    for world in (1, 2, 3, 8, 64):
        for row, index in ((4096, 8), (16, 4), (2, 8)):
            for theta in (0.5, 1.0, 3.0):
                assert sparse.crossover_density(world, row, index, theta) == \
                    jsparse.crossover_density(world, row, index, theta)
            for codec in (None, "int8"):
                assert sparse.gather_wire_bytes(1234, row // 4, 4, index,
                                                world, codec) == \
                    jsparse.gather_wire_bytes(1234, row // 4, 4, index,
                                              world, codec)
    for shape in ((30522, 1024), (10,), (4, 3, 2)):
        assert sparse.dense_wire_bytes(shape, 4) == \
            jsparse.dense_wire_bytes(shape, 4)
        assert sparse.row_elems(shape) == jsparse.row_elems(shape)


@pytest.mark.parametrize("spec", ["auto", "gather", "dense", "emb*=gather",
                                  "emb*=auto;x*=gather;dense", "",
                                  "bogus", "emb*=", "=gather"])
def test_rules_parse_alike(spec):
    try:
        want = jsparse.parse_rules(spec)
    except ValueError:
        with pytest.raises(ValueError):
            sparse.parse_rules(spec)
        return
    assert sparse.parse_rules(spec) == want


@pytest.mark.parametrize("spec,ema,theta", [
    ("auto", 0.8, 1.0), ("auto", 0.0, 0.3), ("emb*=auto;gather", 0.5, 2.0),
    ("emb*=dense;auto", 0.9, 1.0)])
def test_policy_and_ema_decide_alike_over_a_density_sequence(spec, ema,
                                                             theta):
    jp = jsparse.SparsePlane(jsparse.SparsePolicy(
        jsparse.parse_rules(spec), theta, ema))
    tp = sparse.SparsePlane(sparse.SparsePolicy(
        sparse.parse_rules(spec), theta, ema))
    rng = np.random.RandomState(0)
    names = ["emb.table", "x.auto.mod:f:3#1", "x.auto.mod:f:3#2", "other"]
    for step in range(40):
        nnz = int(rng.choice([5, 200, 900, 3000, 9000]))
        name = names[step % len(names)]
        for world in (2, 4):
            args = (name, nnz, 10000, 4096, 8, world)
            assert tp.select(*args) == jp.select(*args), (step, args)
            assert tp.density(name) == jp.density(name)
    assert tp.path_counts == jp.path_counts
    for bad in ((spec, 0.0, ema), (spec, float("inf"), ema),
                (spec, theta, 1.0)):
        with pytest.raises(ValueError):
            sparse.SparsePolicy(sparse.parse_rules(bad[0]), bad[1], bad[2])


def test_wire_codec_for_follows_the_compression_policy(monkeypatch):
    monkeypatch.setenv("HVDTPU_COMPRESSION", "emb*=int8;fp8")
    jp = jsparse.SparsePlane(jsparse.SparsePolicy([("*", "gather")]))
    tp = sparse.SparsePlane(sparse.SparsePolicy([("*", "gather")]))
    import jax.numpy as jnp
    for name in ("emb.table", "other"):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.int64, jnp.int64)):
            assert tp.wire_codec_for(name, tdt) == \
                jp.wire_codec_for(name, jdt)


# --------------------------------------------------------------------------
# a single-process job
# --------------------------------------------------------------------------
def _job(monkeypatch, spec):
    if spec:
        monkeypatch.setenv("HVDTPU_SPARSE", spec)
    else:
        monkeypatch.delenv("HVDTPU_SPARSE", raising=False)
    thvd.shutdown()
    thvd.init(device="cpu")


def test_disabled_plane_densifies_bit_identically(monkeypatch):
    _job(monkeypatch, "")
    try:
        assert basics.runtime().coordinator._sparse is None
        idx, vals, shape = _slices(5)
        sg = sparse.SparseGradient(torch.from_numpy(idx),
                                   torch.from_numpy(vals), shape)
        got = thvd.sparse_allreduce(sg, name="e", op=thvd.Sum)
        dense = thvd.allreduce(sg.densify(), name="d", op=thvd.Sum)
        assert torch.equal(got, dense)
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("op", [reduce_ops.Sum, reduce_ops.Average])
def test_gather_path_scatter_adds_locally(monkeypatch, op):
    _job(monkeypatch, "gather")
    try:
        idx, vals, shape = _slices(6)
        coo = torch.sparse_coo_tensor(torch.from_numpy(idx[None]),
                                      torch.from_numpy(vals), shape)
        got = thvd.sparse_allreduce(coo, name="e", op=op)
        want = jsparse.scatter_add_dense(idx, vals, shape, 1, op)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        assert basics.runtime().coordinator._sparse.path_counts == \
            {"gather": 1, "dense": 0}
        with pytest.raises(ValueError, match="Sum/Average"):
            thvd.sparse_allreduce(coo, name="m", op=thvd.Max)
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("spec", ["", "gather"])
def test_binding_sparse_allreduce_returns_the_coalesced_tensor(monkeypatch,
                                                               spec):
    _job(monkeypatch, spec)
    try:
        idx, vals, shape = _slices(7)
        coo = torch.sparse_coo_tensor(torch.from_numpy(idx[None]),
                                      torch.from_numpy(vals), shape)
        got = pt.synchronize(pt.sparse_allreduce_async(coo, name="b"))
        assert got.is_sparse and got.is_coalesced()
        assert torch.equal(got.to_dense(), coo.to_dense())
        with pytest.raises(ValueError, match="sparse tensor"):
            pt.sparse_allreduce_async(coo.to_dense())
        with pytest.raises(ValueError, match="dense tensors"):
            pt.allreduce(coo)
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("wrap", ["binding", "train"])
def test_sparse_embedding_gradients_stay_sparse_for_sparse_adam(monkeypatch,
                                                                wrap):
    _job(monkeypatch, "gather")
    try:
        torch.manual_seed(0)
        emb = torch.nn.Embedding(20, 4, sparse=True)
        ref = torch.nn.Embedding(20, 4, sparse=True)
        ref.load_state_dict(emb.state_dict())
        inner = torch.optim.SparseAdam(emb.parameters(), lr=0.1)
        opt = (pt.DistributedOptimizer(inner,
                                       named_parameters=emb.named_parameters())
               if wrap == "binding" else train.DistributedOptimizer(inner))
        ref_opt = torch.optim.SparseAdam(ref.parameters(), lr=0.1)
        ids = torch.tensor([[1, 5, 5, 9], [2, 5, 7, 1]])
        for m, o in ((emb, opt), (ref, ref_opt)):
            m(ids).square().sum().backward()
            o.step()
        assert emb.weight.grad.is_sparse
        assert torch.equal(emb.weight, ref.weight)
    finally:
        thvd.shutdown()

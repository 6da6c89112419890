"""The port's gradient compression (``horovod_tpu_torch/compression/``,
``ops/compression.py``) against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages. Tolerances:
codec payloads and scales are bit-equal, and so are the decoded values;
the plain quantized allreduce equals the JAX package's in-jit pipeline on
the 8-device CPU mesh within one quantization step of each block (the
float32 sums may differ in their last bit, and a requantization then
rounds the other way); policies and wire bytes give the same decisions
and numbers. Also: the residual store's reset, the disabled contract, the
loud rejects, and the single-process plane (both legs quantized; the
identity for the optimizers).
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
import horovod_tpu_torch.torch as pt
from horovod_tpu.compression import codecs as jcodecs
from horovod_tpu.compression import policy as jpolicy
from horovod_tpu_torch import basics, train
from horovod_tpu_torch.compression import codecs, policy, residual
from horovod_tpu_torch.ops import reduce_ops

_TORCH_DTYPE = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16}


@pytest.fixture
def port():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _blocks(n, seed, zero_block=None, block=256):
    """A vector whose blocks span five decades, one block all zero."""
    rng = np.random.RandomState(seed)
    scale = 10.0 ** rng.randint(-4, 1, size=-(-n // block))
    x = rng.randn(n) * np.repeat(scale, block)[:n]
    if zero_block is not None:
        x[zero_block * block:(zero_block + 1) * block] = 0
    return x.astype(np.float32)


def _jax_encode(name, x, block):
    import jax.numpy as jnp
    q, s = jcodecs.get_codec(name).encode(jnp.asarray(x), block)
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("block", [32, 256])
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_codec_payloads_and_scales_bit_equal_the_jax_package(name, block,
                                                             dtype):
    import jax.numpy as jnp
    # A ragged tail (1000 is no multiple of either block), padded with
    # zeros as the data planes pad, and an all-zero block.
    x = _blocks(1000, seed=block, zero_block=1, block=block)
    padded = -(-1000 // block) * block
    x = np.pad(x, (0, padded - 1000))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(_TORCH_DTYPE[dtype])
    jq, js = _jax_encode(name, xj, block)
    tq, ts = codecs.get_codec(name).encode(xt, block)
    assert tq.dtype == codecs.get_codec(name).payload_dtype
    np.testing.assert_array_equal(tq.view(torch.int8).numpy(),
                                  jq.view(np.int8))
    np.testing.assert_array_equal(ts.numpy(), js)
    assert np.all(ts.numpy()[1] == 0)   # the zero block: scale 0, no nan
    jd = jcodecs.get_codec(name).decode(jnp.asarray(jq), jnp.asarray(js),
                                        block)
    td = codecs.get_codec(name).decode(tq, ts, block)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("name", ["fp16", "bf16", "none"])
def test_cast_codecs_cast_as_the_jax_package(name):
    import jax.numpy as jnp
    x = _blocks(300, seed=3)
    jq, js = jcodecs.get_codec(name).encode(jnp.asarray(x), 256)
    tq, ts = codecs.get_codec(name).encode(torch.from_numpy(x), 256)
    assert js is None and ts is None
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq, np.float32))
    assert codecs.get_codec(name).wire is False


@pytest.mark.parametrize("nelems", [1, 255, 256, 1000, 1 << 20])
@pytest.mark.parametrize("name", sorted(jcodecs.CODECS))
def test_wire_bytes_and_padding_match_the_jax_package(name, nelems):
    for block in (32, 256):
        for itemsize in (2, 4):
            assert (codecs.get_codec(name).wire_bytes(nelems, block, itemsize)
                    == jcodecs.get_codec(name).wire_bytes(nelems, block,
                                                          itemsize))
        for n in (1, 2, 3, 8):
            assert codecs.padded_len(nelems, n, block) == \
                jcodecs.padded_len(nelems, n, block)
    assert sorted(codecs.CODECS) == sorted(jcodecs.CODECS)
    with pytest.raises(ValueError, match="unknown compression codec"):
        codecs.get_codec("int4")


@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_plain_pipeline_equals_the_jax_axis_pipeline(n, name, average):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.utils.jax_compat import shard_map
    block = 128
    x = np.stack([_blocks(1000, seed=10 * n + r, block=block)
                  for r in range(n)])
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    fn = jax.jit(shard_map(
        lambda v: jcodecs.quantized_allreduce_axis(
            v[0], "hvd", name, block, average=average)[None],
        mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"), check_vma=False))
    want = np.asarray(fn(jnp.asarray(x)))
    got = codecs.quantized_allreduce_plain(torch.from_numpy(x), name, block,
                                           average=average).numpy()
    assert got.shape == (1000,) and got.dtype == np.float32
    # One quantization step of each block of the reduced vector.
    qmax = 127.0 if name == "int8" else 448.0
    red = np.abs(np.pad(want[0], (0, 24))).reshape(-1, block).max(1)
    step = np.repeat(red / qmax, block)[:1000]
    if name == "fp8":   # 3 mantissa bits: a step is relative to the value
        step = np.maximum(step, np.abs(want[0]) / 8)
    assert np.all(np.abs(got - want[0]) <= step + 1e-7)
    # And it is a quantized sum, not the exact one.
    exact = x.sum(0) / (n if average else 1)
    assert 0 < np.abs(got - exact).max()


def test_plain_pipeline_takes_the_input_dtype_and_refuses_casts():
    x = torch.from_numpy(np.stack([_blocks(600, seed=s) for s in (1, 2)]))
    out = codecs.quantized_allreduce_plain(x.to(torch.bfloat16), "int8")
    assert out.dtype == torch.bfloat16 and out.shape == (600,)
    with pytest.raises(ValueError, match="needs a wire codec"):
        codecs.quantized_allreduce_plain(x, "fp16")


# --------------------------------------------------------------------------
# policy
# --------------------------------------------------------------------------
SPECS = ["int8", "fp8", "fp16", "bf16", "none", "*bias*=none;int8",
         "embed*=bf16;grad.*=fp8", "grad.a*=int8;none", ""]
QUERIES = [
    ("grad.a.weight", 4096, "float32", reduce_ops.Average, 0),
    ("grad.a.bias", 4096, "float32", reduce_ops.Sum, 0),
    ("embed.table", 2048, "bfloat16", reduce_ops.Average, 0),
    ("grad.small", 100, "float32", reduce_ops.Average, 0),
    ("grad.int", 4096, "int32", reduce_ops.Sum, 0),
    ("grad.max", 4096, "float32", reduce_ops.Max, 0),
    ("grad.adasum", 4096, "float32", reduce_ops.Adasum, 0),
    ("grad.subset", 4096, "float16", reduce_ops.Average, 3),
    (None, 4096, "float32", reduce_ops.Average, None),
]


def _decision(pol, q, dtype):
    try:
        return pol.select(q[0], q[1], dtype, q[3], q[4])
    except ValueError as e:
        return ("ValueError", str(e).split(":")[0])


@pytest.mark.parametrize("spec", SPECS)
def test_policy_decisions_match_the_jax_package(spec):
    import jax.numpy as jnp
    assert policy.parse_rules(spec) == jpolicy.parse_rules(spec)
    for threshold in (1024, 100):
        mine = policy.CompressionPolicy(policy.parse_rules(spec), threshold)
        theirs = jpolicy.CompressionPolicy(jpolicy.parse_rules(spec),
                                           threshold)
        for q in QUERIES:
            assert _decision(mine, q, getattr(torch, q[2])) == \
                _decision(theirs, q, jnp.dtype(q[2])), (spec, q)


@pytest.mark.parametrize("spec", ["int8", "fp8;x=none", "x=int8;fp16",
                                  "x=int8", "", "*=fp8;bf16"])
def test_simple_wire_policy_matches_the_jax_package(spec, monkeypatch):
    monkeypatch.setenv("HVDTPU_COMPRESSION", spec)
    monkeypatch.setenv("HVDTPU_COMPRESSION_BLOCK", "64")
    assert policy.simple_wire_policy() == jpolicy.simple_wire_policy()


@pytest.mark.parametrize("spec", ["int4", "a=", "=int8", "x=int8;bogus"])
def test_malformed_specs_raise_in_both_packages(spec):
    with pytest.raises(ValueError):
        jpolicy.parse_rules(spec)
    with pytest.raises(ValueError):
        policy.parse_rules(spec)


def test_residual_store_resets_when_the_elastic_version_moves(monkeypatch):
    monkeypatch.setenv("HVDTPU_ELASTIC_VERSION", "3")
    store = residual.ResidualStore()
    store.put("g", [torch.ones(2)])
    assert len(store) == 1 and torch.equal(store.get("g")[0], torch.ones(2))
    monkeypatch.setenv("HVDTPU_ELASTIC_VERSION", "4")
    assert store.get("g") is None and len(store) == 0
    store.put("g", [torch.zeros(2)])
    store.reset()
    assert len(store) == 0


# --------------------------------------------------------------------------
# the plane in a single-process job
# --------------------------------------------------------------------------
def test_disabled_contract_and_explicit_marker(port, monkeypatch):
    coord = basics.runtime().coordinator
    x = torch.from_numpy(_blocks(2000, seed=5))
    assert torch.equal(pt.allreduce(x, name="plain"), x)
    assert coord._compression is None
    got = pt.allreduce(x, name="q", compression=pt.Compression.int8)
    assert coord._compression is not None
    # Both legs quantized at one rank: the plain pipeline of one rank.
    want = codecs.quantized_allreduce_plain(x[None], "int8", 256)
    assert torch.equal(got, want) and not torch.equal(got, x)
    # Error feedback: the residual is the first leg's error, and the next
    # step adds it to its input.
    (res,) = coord._compression.residuals.get("q")
    got2 = pt.allreduce(x, name="q", compression=pt.Compression.int8)
    want2 = codecs.quantized_allreduce_plain((x + res)[None], "int8", 256)
    assert torch.equal(got2, want2)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_in_place_and_grouped_wire_codecs_at_size_one(port, codec):
    xs = [torch.from_numpy(_blocks(1500, seed=s)) for s in (7, 8)]
    ys = [x.clone() for x in xs]
    pt.synchronize(thvd.grouped_allreduce_async_(ys, name="g", codec=codec))
    flat = torch.cat(xs)[None]
    want = codecs.quantized_allreduce_plain(flat, codec, 256)
    assert torch.equal(torch.cat(ys), want)
    z = xs[0].clone()
    assert pt.allreduce_(z, name="z", compression=getattr(
        pt.Compression, codec)) is z
    assert torch.equal(z, codecs.quantized_allreduce_plain(xs[0][None],
                                                           codec, 256))


@pytest.mark.parametrize("codec", ["fp16", "bf16"])
def test_env_cast_policy_rides_the_narrow_dtype(monkeypatch, codec):
    monkeypatch.setenv("HVDTPU_COMPRESSION", codec)
    thvd.shutdown()
    thvd.init(device="cpu")
    try:
        x = torch.from_numpy(_blocks(2000, seed=9))
        got = pt.allreduce(x, name="c")
        dt = codecs.get_codec(codec).cast_dtype
        assert got.dtype == torch.float32
        assert torch.equal(got, x.to(dt).float())
        small = torch.from_numpy(_blocks(100, seed=9))
        assert torch.equal(pt.allreduce(small, name="s"), small)
    finally:
        thvd.shutdown()


def test_wire_codec_rejects_are_loud(port):
    x = torch.ones(2048)
    with pytest.raises(ValueError, match="op=Adasum"):
        pt.allreduce(x, name="a", op=pt.Adasum,
                     compression=pt.Compression.int8)
    with pytest.raises(ValueError, match="Sum/Average"):
        pt.allreduce(x, name="m", op=pt.Max, compression=pt.Compression.fp8)
    # A process set other than the global one (none exists at size 1:
    # the entry is stamped directly).
    import types
    from horovod_tpu_torch.coordinator import TensorEntry
    subset = types.SimpleNamespace(process_set_id=3, ranks=[0])
    entry = TensorEntry("p", "allreduce", [x], subset,
                        op=reduce_ops.Average, codec="int8")
    with pytest.raises(ValueError, match="global process set"):
        basics.runtime().coordinator._compression.stamp(entry)
    # The same tensors without compression still work.
    assert torch.equal(pt.allreduce(x, name="p"), x)
    with pytest.raises(ValueError, match="Adasum"):
        train.DistributedOptimizer(
            torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=0.1),
            op=reduce_ops.Adasum, compression=pt.Compression.fp8)
    with pytest.raises(ValueError, match="Adasum"):
        pt.DistributedOptimizer(
            torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=0.1),
            op=pt.Adasum, compression=pt.Compression.int8)


def test_compression_surface_matches_the_jax_package():
    from horovod_tpu.ops.compression import Compression as J
    from horovod_tpu_torch.ops.compression import Compression as T
    for name in ("none", "fp16", "bf16", "int8", "fp8"):
        assert getattr(getattr(T, name), "wire_codec", None) == \
            getattr(getattr(J, name), "wire_codec", None)
    x = np.linspace(-3, 3, 7).astype(np.float32)
    for name in ("fp16", "bf16"):
        jc, jctx = getattr(J, name).compress(x)
        tc, tctx = getattr(T, name).compress(torch.from_numpy(x))
        np.testing.assert_array_equal(tc.float().numpy(),
                                      np.asarray(jc, np.float32))
        back = getattr(T, name).decompress(tc, tctx)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(getattr(J, name).decompress(jc, jctx)))
        assert back.dtype == torch.float32
        ints = torch.arange(3)
        assert getattr(T, name).compress(ints) == (ints, None)


@pytest.mark.parametrize("kwargs", [
    {"compression": pt.Compression.int8}, {"compression": pt.Compression.fp8},
    {"compression": pt.Compression.fp16}, {"compression": pt.Compression.bf16},
    {"op": reduce_ops.Adasum}])
def test_single_process_optimizer_is_the_identity(port, kwargs):
    torch.manual_seed(0)
    model = torch.nn.Linear(50, 40)
    ref = torch.nn.Linear(50, 40)
    ref.load_state_dict(model.state_dict())
    opt = train.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), **kwargs)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    x = torch.randn(8, 50)
    for m, o in ((model, opt), (ref, ref_opt)):
        m(x).square().sum().backward()
        o.step()
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_chip_smoke_gradient_check_holds_the_written_back_result(name):
    # chip_smoke.py's [compress] phase reads one step's gradients back
    # where the optimizer reads them, not knowing how the core fused them:
    # the plain pipeline's result at any fusion layout passes, a dropped
    # write-back (the exact gradients) and a misplaced one fail.
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    rng = np.random.RandomState(5)
    shapes = [(300,), (1000, 7), (5,), (64, 64), (1024,), (3000,)]
    pre = [torch.from_numpy((rng.randn(*s) * 10.0 ** rng.randint(-3, 3))
                            .astype(np.float32)) for s in shapes]
    pre[1][:100] = 0
    c = codecs.get_codec(name)
    flat = torch.cat([p.reshape(-1) for p in pre])
    cut = sum(p.numel() for p in pre[:3])
    out = torch.cat([codecs.quantized_allreduce_plain(part[None], c, 256,
                                                      average=False)
                     for part in (flat[:cut], flat[cut:])])
    post = [t.reshape(p.shape)
            for t, p in zip(out.split([p.numel() for p in pre]), pre)]
    worst, changed, nonzero = chip_smoke.check_written_back(pre, post, c,
                                                            256)
    assert worst <= 1.0 and 2 * changed >= nonzero > 0
    worst, changed, _ = chip_smoke.check_written_back(
        pre, [p.clone() for p in pre], c, 256)
    assert changed == 0
    post[3] = post[3].flip(0)
    worst, _, _ = chip_smoke.check_written_back(pre, post, c, 256)
    assert worst > 1.0

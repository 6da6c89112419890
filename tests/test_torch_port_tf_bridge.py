"""The ``tf.function`` bridge on torch (``horovod_tpu_torch/tensorflow/
compile.py``) against the JAX package's (``horovod_tpu/tensorflow/
compile.py``): the same TF functions through both bridges. Both read the
same TF variables, so the weights are carried by construction. Mirrors the
in-process cases of tests/test_tf_compile.py; its keras subprocess cases
are tests/test_torch_port_tf_bridge_keras.py, the records and the op table
tests/test_torch_port_tf_records.py.

Tolerances: fp32 forwards to 1e-5 absolute (TF and the JAX bridge run the
same fp32 math in another order); gradients to 1e-5 absolute and 1e-4
relative; flash-routed attention to 2e-4 (the kernels' plain versions
accumulate per tile, as the JAX test allows); bf16 compute to 5% of the
fp32 loss, as the JAX test.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

import horovod_tpu as jhvd  # noqa: E402
import horovod_tpu_torch as thvd  # noqa: E402
from horovod_tpu.tensorflow.compile import tpu_compile as jax_compile  # noqa
from horovod_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from horovod_tpu_torch.tensorflow.compile import tpu_compile  # noqa: E402

FP32 = dict(rtol=0, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
FLASH = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def _runtimes():
    jhvd.init()
    thvd.shutdown()
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _ConvNet(tf.Module):
    def __init__(self):
        tf.random.set_seed(0)
        init = tf.random.normal
        self.wc = tf.Variable(init([3, 3, 1, 8], stddev=0.1), name="wc")
        self.bc = tf.Variable(tf.zeros([8]), name="bc")
        self.w1 = tf.Variable(init([14 * 14 * 8, 32], stddev=0.05),
                              name="w1")
        self.b1 = tf.Variable(tf.zeros([32]), name="b1")
        self.w2 = tf.Variable(init([32, 10], stddev=0.05), name="w2")
        self.b2 = tf.Variable(tf.zeros([10]), name="b2")

    def loss(self, x, y):
        h = tf.nn.conv2d(x, self.wc, strides=1, padding="SAME") + self.bc
        h = tf.nn.relu(h)
        h = tf.nn.max_pool2d(h, 2, 2, padding="VALID")
        h = tf.reshape(h, [tf.shape(h)[0], -1])
        h = tf.nn.relu(tf.matmul(h, self.w1) + self.b1)
        logits = tf.matmul(h, self.w2) + self.b2
        return tf.reduce_mean(
            tf.nn.sparse_softmax_cross_entropy_with_logits(
                labels=y, logits=logits))


def _mnist_batch(batch=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, size=(batch,)).astype(np.int64)
    return x, y


def test_convnet_forward_parity():
    m = _ConvNet()
    x, y = _mnist_batch()
    tf_loss = float(m.loss(tf.constant(x), tf.constant(y)))
    jax_loss = float(jax_compile(m.loss, example_inputs=(x, y))(x, y))
    port = tpu_compile(m.loss, example_inputs=(x, y))
    assert port.device == thvd.device()
    port_loss = float(port(x, y))
    np.testing.assert_allclose(port_loss, tf_loss, **FP32)
    np.testing.assert_allclose(port_loss, jax_loss, **FP32)


def test_convnet_trains_and_writes_back():
    optax = pytest.importorskip("optax")
    m = _ConvNet()
    x, y = _mnist_batch()
    jstep = jax_compile(m.loss, example_inputs=(x, y)).make_train_step(
        optax.sgd(0.1))
    jax_losses = [float(jstep((x, y))) for _ in range(8)]
    compiled = tpu_compile(m.loss, example_inputs=(x, y))
    step = compiled.make_train_step(
        torch.optim.SGD(compiled.parameters(), lr=0.1))
    losses = [float(step((x, y))) for _ in range(8)]
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=1e-5)
    compiled.copy_params_to_variables()
    # TF-side eval sees the trained weights.
    tf_loss = float(m.loss(tf.constant(x), tf.constant(y)))
    np.testing.assert_allclose(float(compiled(x, y)), tf_loss, **FP32)


def test_gradient_parity_with_tf_and_the_jax_bridge():
    m = _ConvNet()
    x, y = _mnist_batch(8)
    with tf.GradientTape() as tape:
        loss = m.loss(tf.constant(x), tf.constant(y))
    tf_vars = [m.wc, m.bc, m.w1, m.b1, m.w2, m.b2]
    tf_grads = {v.name: g.numpy() for v, g in
                zip(tf_vars, tape.gradient(loss, tf_vars))}

    jc = jax_compile(m.loss, example_inputs=(x, y))
    jax_grads = jax.grad(lambda p: jc.apply(p, [x, y])[0])(jc.params)

    compiled = tpu_compile(m.loss, example_inputs=(x, y))
    params = compiled.params
    out, _ = compiled.apply(params, [x, y])
    grads = dict(zip(params, torch.autograd.grad(out, list(
        params.values()))))
    assert set(grads) == set(tf_grads) == set(jax_grads)
    for name, g in tf_grads.items():
        np.testing.assert_allclose(_np(grads[name]), g, **GRAD)
        np.testing.assert_allclose(_np(grads[name]),
                                   np.asarray(jax_grads[name]), **GRAD)


def test_image_resize_parity():
    def fwd(x):
        up = tf.image.resize(x, (8, 8), method="bilinear")
        return tf.image.resize(up, (2, 2), method="nearest")

    x = np.random.RandomState(2).rand(2, 4, 4, 3).astype(np.float32)
    out = _np(tpu_compile(fwd, example_inputs=(x,))(x))
    np.testing.assert_allclose(out, fwd(tf.constant(x)).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        out, np.asarray(jax_compile(fwd, example_inputs=(x,))(x)),
        rtol=1e-5, atol=1e-6)


def test_embedding_and_einsum():
    """ResourceGather (embedding) + Einsum + LayerNorm-style math."""
    tf.random.set_seed(2)
    table = tf.Variable(tf.random.normal([64, 8]), name="emb")
    wq = tf.Variable(tf.random.normal([8, 8], stddev=0.3), name="wq")

    def fwd(ids):
        e = tf.nn.embedding_lookup(table, ids)
        q = tf.einsum("bsd,de->bse", e, wq)
        s = tf.nn.softmax(tf.matmul(q, e, transpose_b=True), axis=-1)
        return tf.reduce_mean(tf.matmul(s, e), axis=1)

    ids = np.random.RandomState(0).randint(0, 64, size=(4, 10))
    out = _np(tpu_compile(fwd, example_inputs=(ids,))(ids))
    np.testing.assert_allclose(out, fwd(tf.constant(ids)).numpy(), **FP32)
    np.testing.assert_allclose(
        out, np.asarray(jax_compile(fwd, example_inputs=(ids,))(ids)),
        **FP32)


def test_div_no_nan_gradient_finite():
    """divide_no_nan with a zero denominator has finite gradients, equal to
    the JAX bridge's."""
    w = tf.Variable(tf.ones([4]), name="w")

    def fwd(x, mask):
        s = tf.reduce_sum(x * w * mask)
        return tf.math.divide_no_nan(s, tf.reduce_sum(mask))

    x = np.ones(4, np.float32)
    mask = np.zeros(4, np.float32)
    jc = jax_compile(fwd, example_inputs=(x, mask))
    jg = jax.grad(lambda p: jc.apply(p, [x, mask])[0])(jc.params)
    compiled = tpu_compile(fwd, example_inputs=(x, mask))
    out, _ = compiled.apply(compiled.params, [x, mask])
    (g,) = torch.autograd.grad(out, [compiled.params["w:0"]])
    assert torch.isfinite(g).all()
    np.testing.assert_array_equal(_np(g), np.asarray(jg["w:0"]))


def test_unsupported_op_is_loud():
    def fwd(x):
        return tf.raw_ops.MatrixInverse(input=x)

    x = np.eye(3, dtype=np.float32)[None]
    compiled = tpu_compile(fwd, example_inputs=(x,))
    with pytest.raises(NotImplementedError, match="MatrixInverse"):
        compiled(x)


def test_int64_inputs_stay_whole():
    """The port keeps int64 (and float64) whole where the JAX bridge
    narrows them to 32 bits (ROADMAP C): the values agree, the input
    dtype differs."""
    def fwd(ids):
        return tf.cast(ids, tf.float32) * 2.0, ids + 1

    ids = np.arange(6, dtype=np.int64)
    scaled, bumped = tpu_compile(fwd, example_inputs=(ids,))(ids)
    jscaled, jbumped = jax_compile(fwd, example_inputs=(ids,))(ids)
    np.testing.assert_array_equal(_np(scaled), (ids * 2).astype(np.float32))
    np.testing.assert_array_equal(_np(scaled), np.asarray(jscaled))
    np.testing.assert_array_equal(_np(bumped), np.asarray(jbumped))
    assert bumped.dtype == torch.int64
    assert np.asarray(jbumped).dtype == np.int32


def _attention_module(causal, heads=4, key_dim=16, d_model=64, out_dim=8):
    """The op pattern keras-3 MultiHeadAttention emits (einsum
    projections, scalar Mul scale, SelectV2 masked softmax, combine einsum)
    with raw TF ops, as tests/test_tf_compile.py builds it."""
    tf.random.set_seed(0)

    class MHA(tf.Module):
        def __init__(self):
            init = tf.random.normal
            self.wq = tf.Variable(init([d_model, heads, key_dim],
                                       stddev=0.05), name="wq")
            self.wk = tf.Variable(init([d_model, heads, key_dim],
                                       stddev=0.05), name="wk")
            self.wv = tf.Variable(init([d_model, heads, key_dim],
                                       stddev=0.05), name="wv")
            self.wo = tf.Variable(init([heads, key_dim, out_dim],
                                       stddev=0.05), name="wo")

        def __call__(self, x):
            q = tf.einsum("bsc,cnh->bsnh", x, self.wq)
            k = tf.einsum("bsc,cnh->bsnh", x, self.wk)
            v = tf.einsum("bsc,cnh->bsnh", x, self.wv)
            s = tf.einsum("bqnh,bknh->bnqk", q, k)
            s = s * (1.0 / float(key_dim) ** 0.5)
            if causal:
                n = tf.shape(x)[1]
                rows = tf.range(n)
                keep = rows[:, None] >= rows[None, :]
                cond = tf.logical_and(tf.ones_like(s, tf.bool),
                                      keep[None, None])
                s = tf.where(cond, s, tf.constant(-1e9))
            p = tf.nn.softmax(s)
            out = tf.einsum("bnqk,bknh->bqnh", p, v)
            return tf.einsum("bqnh,nho->bqo", out, self.wo)

    return MHA()


def _spy(monkeypatch, record):
    orig = tfa.flash_attention

    def spy(*args, **kwargs):
        record.append(kwargs.get("causal"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_attention", spy)


@pytest.mark.parametrize("use_causal_mask", [False, True])
def test_attention_pattern_flash_routing_parity(monkeypatch,
                                                use_causal_mask):
    """The attention pattern routes to the port's flash call (the SelectV2
    causal mask is recognised from its host value) and agrees with the
    einsum lowering, TF and the JAX bridge."""
    model = _attention_module(use_causal_mask)
    x = np.random.RandomState(0).normal(size=(2, 32, 64)).astype(
        np.float32)
    ref = model(tf.constant(x)).numpy()
    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "never")
    einsum = _np(tpu_compile(model, example_inputs=(tf.constant(x),))(x))
    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "always")
    jax_out = np.asarray(jax_compile(model, example_inputs=(
        tf.constant(x),))(x))
    hits = []
    _spy(monkeypatch, hits)
    out = _np(tpu_compile(model, example_inputs=(tf.constant(x),))(x))
    assert hits == [use_causal_mask]
    np.testing.assert_allclose(einsum, ref, **FP32)
    np.testing.assert_allclose(out, einsum, **FLASH)
    np.testing.assert_allclose(out, jax_out, **FLASH)


def test_attention_pattern_flash_training_gradients(monkeypatch):
    """Training through the flash-routed attention: the first step's
    gradients equal the JAX bridge's, and the loss falls."""
    model = _attention_module(False)
    x = np.random.RandomState(1).normal(size=(8, 32, 64)).astype(
        np.float32)
    y = np.random.RandomState(2).normal(size=(8, 32, 8)).astype(
        np.float32)

    def loss_fn(a, t):
        return tf.reduce_mean(tf.square(model(a) - t))

    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "always")
    ex = (tf.constant(x), tf.constant(y))
    jc = jax_compile(loss_fn, example_inputs=ex)
    jg = jax.grad(lambda p: jc.apply(p, [x, y])[0])(jc.params)
    hits = []
    _spy(monkeypatch, hits)
    compiled = tpu_compile(loss_fn, example_inputs=ex)
    params = compiled.params
    out, _ = compiled.apply(params, [x, y])
    grads = torch.autograd.grad(out, list(params.values()))
    assert hits == [False]
    for name, g in zip(params, grads):
        np.testing.assert_allclose(_np(g), np.asarray(jg[name]), **FLASH)
    step = compiled.make_train_step(
        torch.optim.Adam(compiled.parameters(), lr=1e-2))
    losses = [float(step((x, y))) for _ in range(5)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_attention_pattern_flash_fallback_on_padding_mask(monkeypatch):
    """A data-dependent key-padding mask is no compile-time constant: the
    site takes the einsum lowering, notes the fallback and stays equal to
    TF and the JAX bridge."""
    base = _attention_module(False)

    def masked_model(x, mask):
        q = tf.einsum("bsc,cnh->bsnh", x, base.wq)
        k = tf.einsum("bsc,cnh->bsnh", x, base.wk)
        v = tf.einsum("bsc,cnh->bsnh", x, base.wv)
        s = tf.einsum("bqnh,bknh->bnqk", q, k) * 0.25
        cond = tf.logical_and(tf.ones_like(s, tf.bool),
                              mask[:, None, None, :])
        s = tf.where(cond, s, tf.constant(-1e9))
        p = tf.nn.softmax(s)
        out = tf.einsum("bnqk,bknh->bqnh", p, v)
        return tf.einsum("bqnh,nho->bqo", out, base.wo)

    x = np.random.RandomState(0).normal(size=(2, 32, 64)).astype(
        np.float32)
    mask = np.ones((2, 32), bool)
    mask[:, -7:] = False
    ex = (tf.constant(x), tf.constant(mask))
    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "always")
    jax_out = np.asarray(jax_compile(masked_model, example_inputs=ex)(
        x, mask))
    hits, notes = [], []
    _spy(monkeypatch, hits)
    monkeypatch.setattr(tfa, "note_flash_fallback", notes.append)
    out = _np(tpu_compile(masked_model, example_inputs=ex)(x, mask))
    assert not hits, "a padding mask must not route to the flash kernels"
    assert notes == ["attention mask is not a compile-time constant"]
    np.testing.assert_allclose(
        out, masked_model(tf.constant(x), tf.constant(mask)).numpy(),
        **FP32)
    np.testing.assert_allclose(out, jax_out, **FP32)


def test_compute_dtype_bf16_parity_and_training():
    """compute_dtype=bf16: master weights stay fp32, the loss is within 5%
    of fp32 (and of the JAX bridge's bf16 loss), and training converges."""
    import jax.numpy as jnp
    m = _ConvNet()
    x, y = _mnist_batch()
    l32 = float(tpu_compile(m.loss, example_inputs=(x, y))(x, y))
    c16 = tpu_compile(m.loss, example_inputs=(x, y),
                      compute_dtype=torch.bfloat16)
    l16 = float(c16(x, y))
    j16 = float(np.asarray(jax_compile(m.loss, example_inputs=(x, y),
                                       compute_dtype=jnp.bfloat16)(x, y)))
    assert abs(l32 - l16) / abs(l32) < 0.05
    assert abs(j16 - l16) / abs(l32) < 0.05
    assert all(p.dtype == torch.float32 for p in c16.parameters())
    step = c16.make_train_step(torch.optim.SGD(c16.parameters(), lr=0.05))
    losses = [float(step((x, y))) for _ in range(6)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_verify_on_a_clean_graph_finds_nothing_and_changes_nothing(
        monkeypatch):
    """``verify=True`` lints the forward once per signature (a trace on
    fake tensors) before its first run: a clean graph raises nothing and
    gives the outputs of ``verify=False``, as the JAX bridge's does. A
    flash-routed causal site keeps its host-side mask concrete under the
    trace (the routed call sees fake tensors, then real ones)."""
    monkeypatch.setenv("HVDTPU_BRIDGE_FLASH", "always")
    model = _attention_module(True)
    xa = np.random.RandomState(0).normal(size=(2, 32, 64)).astype(
        np.float32)
    ex = (tf.constant(xa),)
    plain_attn = _np(tpu_compile(model, example_inputs=ex)(xa))
    kinds = []
    orig = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **k: (
        kinds.append(type(a[0]).__name__), orig(*a, **k))[1])
    checked_attn = tpu_compile(model, example_inputs=ex, verify=True)
    np.testing.assert_array_equal(_np(checked_attn(xa)), plain_attn)
    assert kinds == ["FakeTensor", "Tensor"]

    m = _ConvNet()
    x, y = _mnist_batch()
    plain = float(tpu_compile(m.loss, example_inputs=(x, y))(x, y))
    checked = tpu_compile(m.loss, example_inputs=(x, y), verify=True)
    assert float(checked(x, y)) == plain
    assert float(checked(x, y)) == plain
    assert checked._verified == {(False, False, 2)}
    jax_checked = jax_compile(m.loss, example_inputs=(x, y), verify=True)
    np.testing.assert_allclose(plain, float(jax_checked(x, y)), **FP32)


def test_op_attrs_the_jax_bridge_drops_follow_tf():
    """LeakyRelu's ``alpha`` and Cumsum's ``exclusive``/``reverse`` are op
    attrs: the port reads them, and equals TF (the JAX bridge calls
    ``jax.nn.leaky_relu`` with its default slope and ``jnp.cumsum`` without
    either flag, ``compile.py:1125``, ``:957``; ROADMAP C, reference
    notes)."""
    def fwd(x):
        return (tf.nn.leaky_relu(x, alpha=0.3),
                tf.math.cumsum(x, axis=1, exclusive=True, reverse=True),
                tf.math.cumsum(x, axis=0, reverse=True))

    x = np.random.RandomState(4).normal(size=(3, 5)).astype(np.float32)
    outs = tpu_compile(fwd, example_inputs=(x,))(x)
    for got, want in zip(outs, fwd(tf.constant(x))):
        np.testing.assert_allclose(_np(got), want.numpy(), **FP32)
    jax_leaky = np.asarray(jax_compile(fwd, example_inputs=(x,))(x)[0])
    assert not np.allclose(jax_leaky, _np(outs[0]))

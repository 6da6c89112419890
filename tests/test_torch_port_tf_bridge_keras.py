"""The keras cases of tests/test_tf_compile.py through both ``tf.function``
bridges, the port's and the JAX package's, each scenario in a fresh
interpreter (keras binds its backend at first import; both bridges read
the same keras variables there).

Tolerances: fp32 forwards to 1e-5 absolute against the JAX bridge and 1e-4
against TF (the JAX test's bar for the applications); flash-routed keras
attention to 2e-4.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("tensorflow")

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

_PRELUDE = r"""
import os, sys
os.environ["KERAS_BACKEND"] = "tensorflow"
sys.path.insert(0, {repo!r})
import numpy as np
import tensorflow as tf
import torch
import jax
jax.config.update("jax_platforms", "cpu")
import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu.tensorflow.compile import tpu_compile as jax_compile
from horovod_tpu_torch.tensorflow.compile import tpu_compile
jhvd.init()
thvd.init(device="cpu")

def close(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    d = float(np.abs(a - b).max())
    assert d <= atol, (d, atol)
    return d
"""

_KERAS_MODEL = r"""
import optax
# BN/dropout keras model: BN buffer writes, seeded stateless dropout.
tf.random.set_seed(0)
model = tf.keras.Sequential([
    tf.keras.layers.Input((16,)),
    tf.keras.layers.Dense(32, activation="relu"),
    tf.keras.layers.BatchNormalization(),
    tf.keras.layers.Dropout(0.1),
    tf.keras.layers.Dense(10),
])
lossf = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)
def loss_fn(x, y):
    return lossf(y, model(x, training=True))
rng = np.random.RandomState(0)
x = rng.rand(32, 16).astype(np.float32)
y = rng.randint(0, 10, size=(32,)).astype(np.int64)
compiled = tpu_compile(loss_fn, example_inputs=(x, y))
# The same seed gives the same dropout draws; another seed others.
a, b, c = (float(compiled(x, y, rng=s)) for s in (3, 3, 4))
assert a == b != c, (a, b, c)
try:
    compiled(x, y)
    raise SystemExit("a random op ran without rng=")
except ValueError as e:
    assert "rng=" in str(e)
step = compiled.make_train_step(
    torch.optim.SGD(compiled.parameters(), lr=0.05))
mmk = next(k for k in compiled.aux if "moving_mean" in k)
mm0 = compiled.aux[mmk].clone()
losses = [float(step((x, y), rng=i)) for i in range(8)]
assert losses[-1] < losses[0], losses
assert not torch.allclose(mm0, compiled.aux[mmk]), "BN stale"
# Dropout-free, the first training step's loss and BN update equal the
# JAX bridge's (its dropout keys cannot equal the port's draws).
model0 = tf.keras.Sequential([
    tf.keras.layers.Input((16,)),
    tf.keras.layers.Dense(32, activation="relu"),
    tf.keras.layers.BatchNormalization(),
    tf.keras.layers.Dense(10),
])
def loss0(x, y):
    return lossf(y, model0(x, training=True))
jstep = jax_compile(loss0, example_inputs=(x, y)).make_train_step(
    optax.sgd(0.05))
c0 = tpu_compile(loss0, example_inputs=(x, y))
pstep = c0.make_train_step(torch.optim.SGD(c0.parameters(), lr=0.05))
jl = [float(jstep((x, y))) for _ in range(3)]
pl = [float(pstep((x, y))) for _ in range(3)]
close(pl, jl, 1e-5)

# training=False parity: BN moving stats, dropout off.
tf.random.set_seed(1)
model2 = tf.keras.Sequential([
    tf.keras.layers.Input((16,)),
    tf.keras.layers.Dense(32, activation="tanh"),
    tf.keras.layers.BatchNormalization(),
    tf.keras.layers.Dropout(0.5),
    tf.keras.layers.Dense(4),
])
def fwd(x):
    return model2(x, training=False)
x2 = np.random.RandomState(3).rand(8, 16).astype(np.float32)
out = tpu_compile(fwd, example_inputs=(x2,))(x2).numpy()
close(out, model2(tf.constant(x2)).numpy(), 1e-5)
close(out, np.asarray(jax_compile(fwd, example_inputs=(x2,))(x2)), 1e-5)

# MHA transformer block (Einsum, Erfc-gelu, Softmax): forward parity and
# training descent.
tf.random.set_seed(0)
inp = tf.keras.Input((16, 32))
h = tf.keras.layers.MultiHeadAttention(num_heads=4, key_dim=8)(inp, inp)
h = tf.keras.layers.LayerNormalization()(h + inp)
f = tf.keras.layers.Dense(64, activation="gelu")(h)
f = tf.keras.layers.Dense(32)(f)
mha_model = tf.keras.Model(inp, tf.keras.layers.LayerNormalization()(h + f))
xm = np.random.RandomState(0).rand(2, 16, 32).astype(np.float32)
mfwd = lambda x: mha_model(x, training=False)
out = tpu_compile(mfwd, example_inputs=(xm,))(xm).numpy()
close(out, mha_model(tf.constant(xm)).numpy(), 1e-5)
close(out, np.asarray(jax_compile(mfwd, example_inputs=(xm,))(xm)), 1e-5)
xt = np.random.RandomState(3).rand(8, 16, 32).astype(np.float32)
yt = np.random.RandomState(1).rand(8, 16, 32).astype(np.float32)
def mha_loss(x, y):
    return tf.reduce_mean(tf.square(mha_model(x, training=True) - y))
cmt = tpu_compile(mha_loss, example_inputs=(xt, yt))
ms = cmt.make_train_step(torch.optim.Adam(cmt.parameters(), lr=1e-3))
mlosses = [float(ms((xt, yt))) for _ in range(6)]
assert mlosses[-1] < mlosses[0], mlosses

# Recurrence (LSTM -> a TensorList while loop) fails loud.
tf.random.set_seed(1)
lstm = tf.keras.Sequential([
    tf.keras.layers.Input((12,), dtype="int32"),
    tf.keras.layers.Embedding(100, 16),
    tf.keras.layers.LSTM(8),
    tf.keras.layers.Dense(2)])
ids = np.random.RandomState(1).randint(0, 100, size=(2, 12)).astype(np.int32)
cl = tpu_compile(lambda x: lstm(x, training=False), example_inputs=(ids,))
try:
    cl(ids)
    raise SystemExit("LSTM did not fail loud")
except NotImplementedError:
    pass
print("KERAS-BRIDGE OK")
"""

_APPLICATIONS = r"""
tf.random.set_seed(0)
model = getattr(tf.keras.applications, {name!r})(
    weights=None, input_shape=(96, 96, 3), classes=10)
x = np.random.RandomState(0).rand(2, 96, 96, 3).astype(np.float32)
f = lambda a: model(a, training=False)
out = tpu_compile(f, example_inputs=(x,))(x).numpy()
d_tf = close(out, model(tf.constant(x)).numpy(), 1e-4)
d_jax = close(out, np.asarray(jax_compile(f, example_inputs=(x,))(x)), 1e-5)
print("APPLICATIONS OK", d_tf, d_jax)
"""

_REAL_MHA = r"""
from horovod_tpu_torch.ops import flash_attention as fa
tf.keras.utils.set_random_seed(0)
inp = tf.keras.Input((32, 64))
h = tf.keras.layers.MultiHeadAttention(num_heads=4, key_dim=16)(
    inp, inp, use_causal_mask=True)
model = tf.keras.Model(inp, h)
x = np.random.RandomState(0).normal(size=(2, 32, 64)).astype(np.float32)
def f(a):
    return model(a, training=False)
os.environ["HVDTPU_BRIDGE_FLASH"] = "never"
ref = tpu_compile(f, example_inputs=(tf.constant(x),))(x).numpy()
close(ref, model(tf.constant(x)).numpy(), 1e-5)
os.environ["HVDTPU_BRIDGE_FLASH"] = "always"
jout = np.asarray(jax_compile(f, example_inputs=(tf.constant(x),))(x))
hits = []
orig = fa.flash_attention
def spy(*a, **kw):
    hits.append(kw.get("causal")); return orig(*a, **kw)
fa.flash_attention = spy
out = tpu_compile(f, example_inputs=(tf.constant(x),))(x).numpy()
assert hits == [True], hits
close(out, ref, 2e-4)
close(out, jout, 2e-4)
print("MHA-FLASH OK")
"""


def _run(body, marker, **fmt):
    # One JAX device: on the suite's 8-device CPU mesh the JAX step would
    # shard the batch, and batch norm would see 8 batches of 4.
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "XLA_FLAGS"))}
    env.update(KERAS_BACKEND="tensorflow", JAX_PLATFORMS="cpu")
    script = (_PRELUDE + body).format(repo=REPO, **fmt)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    assert marker in out.stdout


def test_keras_model_bridge_subprocess():
    """BN buffer writes, seeded dropout (deterministic per seed), the first
    dropout-free training steps equal to the JAX bridge's, inference
    parity, the MHA block, and an LSTM failing loud."""
    _run(_KERAS_MODEL, "KERAS-BRIDGE OK")


@pytest.mark.parametrize("name", ["MobileNetV2", "EfficientNetB0",
                                  "DenseNet121", "InceptionV3",
                                  "ConvNeXtTiny", "Xception",
                                  "MobileNetV3Small"])
def test_keras_applications_through_bridge(name):
    """The tf.keras.applications families the JAX test runs: depthwise
    convs, swish/relu6, BN inference, skip connections, global pooling."""
    _run(_APPLICATIONS, "APPLICATIONS OK", name=name)


def test_real_keras_mha_flash_routing_subprocess():
    """The real keras MultiHeadAttention graph (causal) routes to the
    port's flash call and agrees with the einsum lowering, TF and the JAX
    bridge."""
    _run(_REAL_MHA, "MHA-FLASH OK")

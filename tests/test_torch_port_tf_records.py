"""The TensorFlow-free records of the port's ``tf.function`` bridge
(``horovod_tpu_torch/tensorflow/compile.py``):

- the port's op table covers every op type the JAX bridge dispatches
  (pinned below as a literal list, with ``horovod_tpu/tensorflow/
  compile.py`` line numbers);
- a record written, loaded and replayed equals the direct run, exactly;
- each committed fixture (tests/torch_port_fixtures/tf_*.npz, written by
  scripts/torch_port_tf_records.py) replays on the CPU at a small batch
  within 1e-4 of TF's own output on the same weights (ResNet-50 and the
  24-layer encoders are deep fp32 stacks, hence the JAX applications
  test's bar rather than 1e-5);
- replaying a record loads no tensorflow, keras or jax (a subprocess);
- a two-rank CPU job replays the rank record (each rank gets its own rank)
  and trains the ResNet-50 record to bit-equal parameters on both ranks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_port_fixtures")
WORKER = os.path.join(REPO, "tests", "torch_port_tf_bridge_worker.py")
JOB_TIMEOUT = 300

#: Every op type the JAX bridge handles, by the line of
#: horovod_tpu/tensorflow/compile.py that dispatches it.
JAX_BRIDGE_OPS = {
    724: ["Placeholder", "Arg", "_Arg"], 726: ["NoOp"], 793: ["Const"],
    797: ["Identity", "PreventGradient", "EnsureShape", "CheckNumerics",
          "Snapshot"],
    800: ["IdentityN"], 802: ["StopGradient"], 805: ["ReadVariableOp"],
    807: ["ResourceGather"],
    812: ["AssignVariableOp", "AssignAddVariableOp", "AssignSubVariableOp"],
    831: ["PartitionedCall", "StatefulPartitionedCall"], 834: ["EagerPyFunc"],
    844: ["StatelessRandomGetKeyCounter"], 849: ["StatelessRandomGetAlg"],
    859: ["Shape"], 861: ["ShapeN"], 863: ["Size"], 865: ["Rank"],
    867: ["Reshape"], 872: ["Squeeze"], 875: ["ExpandDims"],
    880: ["Transpose"], 883: ["Pack"], 885: ["Unpack"], 890: ["ConcatV2"],
    892: ["Split"], 896: ["SplitV"], 901: ["StridedSlice"], 908: ["Slice"],
    914: ["Tile"], 917: ["Fill"], 920: ["ZerosLike"], 922: ["OnesLike"],
    924: ["Range"], 930: ["BroadcastTo"], 933: ["GatherV2"], 948: ["Pad"],
    952: ["PadV2"], 956: ["Cumsum"], 958: ["ReverseV2"],
    961: ["ResizeNearestNeighbor", "ResizeBilinear"], 976: ["OneHot"],
    983: ["Select", "SelectV2"], 985: ["Cast"], 992: ["MatMul"],
    996: ["BatchMatMul", "BatchMatMulV2", "BatchMatMulV3"],
    1000: ["Einsum"], 1011: ["BiasAdd"], 1014: ["Conv2D"],
    1023: ["DepthwiseConv2dNative"], 1028: ["MaxPool"], 1032: ["AvgPool"],
    1036: ["FusedBatchNormV3"],
    1038: ["SparseSoftmaxCrossEntropyWithLogits"],
    1040: ["SoftmaxCrossEntropyWithLogits"], 1042: ["L2Loss"],
    1047: ["ArgMax"], 1050: ["ArgMin"],
    1065: ["RandomUniform", "RandomStandardNormal"],
    1066: ["StatelessRandomUniformV2", "StatelessRandomNormalV2"],
    1069: ["Mean", "Sum"], 1070: ["Max", "Min"], 1071: ["Prod", "All"],
    1072: ["Any"], 1091: ["Add"], 1092: ["AddV2"], 1093: ["Sub"],
    1094: ["Mul"], 1095: ["RealDiv"], 1096: ["Div"], 1097: ["FloorDiv"],
    1098: ["FloorMod"], 1099: ["Pow"], 1100: ["Maximum"],
    1101: ["Minimum"], 1102: ["SquaredDifference"], 1106: ["DivNoNan"],
    1108: ["AddN"], 1109: ["Square", "Sqrt"], 1110: ["Rsqrt"],
    1111: ["Exp", "Log", "Log1p"], 1112: ["Expm1"],
    1113: ["Neg", "Abs", "Sign"], 1114: ["Floor", "Ceil", "Round"],
    1115: ["Rint"], 1116: ["Tanh", "Sigmoid"], 1117: ["Erf"],
    1118: ["Erfc"], 1119: ["Erfinv"], 1120: ["Sin", "Cos"],
    1121: ["Sinh", "Cosh"], 1122: ["Atan2"], 1123: ["Relu"],
    1124: ["Relu6"], 1125: ["LeakyRelu"], 1126: ["Elu", "Selu"],
    1127: ["Softplus"], 1128: ["Softsign"], 1129: ["Softmax"],
    1131: ["LogSoftmax"], 1133: ["Equal"], 1134: ["NotEqual"],
    1135: ["Less"], 1136: ["LessEqual"], 1137: ["Greater"],
    1138: ["GreaterEqual"], 1139: ["LogicalAnd"], 1140: ["LogicalOr"],
    1141: ["LogicalNot"], 1142: ["ClipByValue"], 1143: ["Reciprocal"],
    1144: ["IsFinite"], 1145: ["IsNan"], 1146: ["IsInf"],
}


def test_op_table_covers_every_op_the_jax_bridge_dispatches():
    from horovod_tpu_torch.tensorflow import compile as bridge
    src = open(os.path.join(REPO, "horovod_tpu", "tensorflow",
                            "compile.py")).read().splitlines()
    for line, types in JAX_BRIDGE_OPS.items():
        statement = " ".join(src[line - 1:line + 2])   # may wrap
        for t in types:
            assert f'"{t}"' in statement, (line, t)
    jax_ops = {t for types in JAX_BRIDGE_OPS.values() for t in types}
    port_ops = set(bridge.OPS) | set(bridge.BOUND_OPS)
    assert len(jax_ops) == 142
    assert sorted(jax_ops - port_ops) == []


def test_record_round_trip_equals_the_direct_run(tmp_path):
    """save_record -> load_record -> from_record replays a keras BN model
    (its training-mode buffer writes included) exactly as the
    CompiledFunction tpu_compile made from the live function."""
    tf = pytest.importorskip("tensorflow")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.tensorflow import compile as bridge
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        tf.random.set_seed(0)
        w = tf.Variable(tf.random.normal([6, 4]), name="w")
        mean = tf.Variable(tf.zeros([4]), trainable=False, name="mean")

        def fn(x):
            h = tf.nn.relu(x @ w)
            m = tf.reduce_mean(h, axis=0)
            mean.assign(0.9 * mean + 0.1 * m)
            return {"loss": tf.reduce_sum((h - m) ** 2),
                    "shape": tf.shape(h)}

        x = np.random.RandomState(0).rand(5, 6).astype(np.float32)
        direct = bridge.tpu_compile(fn, example_inputs=(x,))
        path = tmp_path / "fn.npz"
        bridge.save_record(bridge.record_function(
            fn, example_inputs=(x,), weights=True), path)
        replay = bridge.CompiledFunction.from_record(str(path))
        (d_out, d_new), (r_out, r_new) = (c.apply(c.params, [x])
                                          for c in (direct, replay))
        assert torch.equal(d_out["loss"], r_out["loss"])
        assert r_out["shape"].tolist() == [5, 4]
        assert torch.equal(d_new["mean:0"], r_new["mean:0"])
        rec = json.loads(json.dumps(bridge.load_record(str(path))["record"]))
        assert [v["name"] for v in rec["variables"]] == ["w:0", "mean:0"]
        assert rec["variables"][1]["init"] == {"fill": 0.0}
    finally:
        hvd.shutdown()


_FIXTURE_CHECK = r"""
import os, sys
os.environ["KERAS_BACKEND"] = "tensorflow"
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "scripts"))
import numpy as np
import tensorflow as tf
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.tensorflow.compile import CompiledFunction
import torch_port_tf_records as recs
hvd.init(device="cpu")
tf.keras.utils.set_random_seed(0)
model, fn, sig = recs.build({name!r})
rng = np.random.RandomState(0)
if {name!r} == "resnet50":
    args = (rng.rand(2, 224, 224, 3).astype(np.float32),
            rng.randint(0, 1000, size=(2,)).astype(np.int32))
elif {name!r} == "rank":
    args = (np.arange(3, dtype=np.float32),)
else:
    args = (rng.randint(0, 30522, size=(1, 16)).astype(np.int32),
            rng.randint(0, 30522, size=(1, 16)).astype(np.int32))
variables = tf.function(fn).get_concrete_function(*sig).variables
weights = {{v.name: v.numpy() for v in variables}}
want = tf.nest.flatten(tf.function(fn)(*[tf.constant(a) for a in args]))
replay = CompiledFunction.from_record(
    os.path.join({repo!r}, "tests", "torch_port_fixtures",
                 "tf_" + {name!r} + ".npz"), device="cpu", weights=weights)
assert set(replay.params) | set(replay.aux) == set(weights)
got = replay(*args)
got = list(got) if isinstance(got, tuple) else [got]
for g, w in zip(got, want):
    d = float(np.abs(g.numpy() - w.numpy()).max())
    assert d <= 1e-4, d
    print("diff", d)
print("FIXTURE OK")
"""


@pytest.mark.parametrize("name", ["resnet50", "encoder_causal", "encoder",
                                  "rank"])
def test_committed_fixture_replays_within_tolerance_of_tf(name):
    pytest.importorskip("tensorflow")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env.update(KERAS_BACKEND="tensorflow", OMP_NUM_THREADS="4")
    out = subprocess.run(
        [sys.executable, "-c", _FIXTURE_CHECK.format(repo=REPO, name=name)],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "FIXTURE OK" in out.stdout


def test_committed_fixtures_are_small_and_hold_no_weights():
    from horovod_tpu_torch.tensorflow.compile import load_record
    for name in ("resnet50", "encoder_causal", "encoder", "rank"):
        path = os.path.join(FIXTURES, f"tf_{name}.npz")
        assert os.path.getsize(path) < 2 << 20
        rec = load_record(path)["record"]
        assert not any("value" in v for v in rec["variables"])


_NO_TF = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import horovod_tpu_torch as hvd
from horovod_tpu_torch.tensorflow.compile import CompiledFunction
hvd.init(device="cpu")
c = CompiledFunction.from_record({path!r}, seed=0)
loss, logits = c(np.zeros((1, 64, 64, 3), np.float32),
                 np.zeros((1,), np.int32))
assert logits.shape == (1, 1000) and bool(loss.isfinite())
bad = [m for m in ("tensorflow", "keras", "jax", "horovod_tpu")
       if m in sys.modules]
print("LOADED", bad)
"""


def test_replaying_a_record_loads_no_tensorflow():
    path = os.path.join(FIXTURES, "tf_resnet50.npz")
    out = subprocess.run(
        [sys.executable, "-c", _NO_TF.format(repo=REPO, path=path)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "LOADED []" in out.stdout


def run_job(out, env_extra, image, batch, steps):
    """tests/torch_port_tf_bridge_worker.py as a two-rank launcher job
    with a time limit of its own; (exit code, log, per-rank results)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu",
               HVDTPU_CPU_OPERATIONS="nccl", **env_extra)
    out.mkdir(parents=True, exist_ok=True)
    code, log = torch_port_launch.run_launcher(
        ["-np", "2", "--start-timeout", "120", sys.executable, WORKER,
         str(out), str(image), str(batch), str(steps)], cwd=REPO, env=env,
        timeout=JOB_TIMEOUT)
    ranks = [json.loads((out / f"r{r}.json").read_text())
             for r in range(2) if (out / f"r{r}.json").exists()]
    return code, log, ranks


def check_ranks(ranks, backend):
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["backend"] == backend
        # x * rank + size, the rank resolved in this process
        assert r["rank_record"] == [float(i * r["rank"] + 2)
                                    for i in range(3)]
        assert np.all(np.isfinite(r["losses"]))
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_two_rank_job_replays_its_own_rank_and_trains_in_lockstep(tmp_path):
    torch_port_launch.build_port_core()
    code, log, ranks = run_job(tmp_path / "job", {"PORT_TEST_DEVICE": "cpu"},
                               image=64, batch=2, steps=3)
    assert code == 0, log[-4000:]
    check_ranks(ranks, "gloo")

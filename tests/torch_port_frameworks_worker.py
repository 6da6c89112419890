"""One rank of a two-rank job of the TensorFlow or Keras binding, for
tests/test_torch_port_frameworks_*_job.py. The package comes from the
environment, so that one script runs the port and the JAX package on the
same seeded model and data:

    FRAMEWORKS_PKG=horovod_tpu_torch|horovod_tpu \\
        python torch_port_frameworks_worker.py MODE RANK SIZE RDV_DIR \\
        MASTER_PORT OUT

or, for the port on GPUs (one rank per card,
tests/test_torch_port_frameworks_cuda.py), under its launcher:

    FRAMEWORKS_PKG=horovod_tpu_torch python -m \\
        horovod_tpu_torch.runner.launch -np 2 python \\
        torch_port_frameworks_worker.py MODE OUT

MODE ``tf``: ``<pkg>.tensorflow`` on tf.Variables — ``broadcast_variables``
from rank 0 over rank-perturbed starting weights, two ``tf.function`` steps
of a ``DistributedGradientTape``, one eager ``DistributedOptimizer`` step,
then the eager collectives (allreduce of float32/float64/int64, allgather,
broadcast, reducescatter). MODE ``keras``: ``<pkg>.keras`` with the backend
of ``KERAS_BACKEND`` — a two-layer MLP from rank-perturbed weights, 3 SGD
steps of ``model.fit`` through ``DistributedOptimizer`` with the broadcast
and metric-average callbacks. For the port, what reaches its grouped
allreduce is recorded (type and device of each tensor).

Each rank writes ``OUT/r<rank>.npz`` (the weights after 3 steps, the
collectives' results) and last ``OUT/r<rank>.json`` (dtypes, losses, what
the allreduce saw). With the rendezvous arguments the port runs on the CPU
(``init(device="cpu")``, its plane from the environment) and the JAX
package on its TCP plane; under the launcher the port takes its default
device.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

import torch_port_launch  # noqa: E402

PKG = os.environ["FRAMEWORKS_PKG"]
STEPS, BATCH, LR = 3, 8, 0.1


def weights(rank):
    """The seeded MLP (8 -> 16 -> 4), shifted by the rank: the broadcast
    from rank 0 must undo the shift."""
    rng = np.random.RandomState(0)
    w = [rng.randn(8, 16) * 0.3, np.zeros(16), rng.randn(16, 4) * 0.3,
         np.zeros(4)]
    return [(a + rank).astype(np.float32) for a in w]


def data(rank):
    rng = np.random.RandomState(10 + rank)
    x = rng.randn(STEPS * BATCH, 8).astype(np.float32)
    y = rng.randn(STEPS * BATCH, 4).astype(np.float32)
    return x, y


def collective_inputs(rank):
    rng = np.random.RandomState(30 + rank)
    return {"f32": rng.randn(4, 3).astype(np.float32),
            "f64": rng.randn(4, 3),
            "i64": rng.randint(-9, 9, size=(4, 3)).astype(np.int64)}


class PlainSGD:
    """A TF-native optimizer: the binding's DistributedOptimizer wraps any
    object with ``apply_gradients``."""

    def __init__(self, lr):
        self.lr = lr

    def apply_gradients(self, grads_and_vars, *args, **kwargs):
        for g, v in grads_and_vars:
            v.assign_sub(self.lr * g)


def tf_job(rank, size):
    import tensorflow as tf
    hvd = __import__(f"{PKG}.tensorflow", fromlist=["x"])
    variables = [tf.Variable(w) for w in weights(rank)]
    hvd.broadcast_variables(variables, root_rank=0)
    x, y = data(rank)

    def loss_of(xb, yb):
        h = tf.nn.relu(xb @ variables[0] + variables[1])
        return tf.reduce_mean((h @ variables[2] + variables[3] - yb) ** 2)

    @tf.function
    def tape_step(xb, yb):
        with hvd.DistributedGradientTape(tf.GradientTape()) as tape:
            loss = loss_of(xb, yb)
        grads = tape.gradient(loss, variables)
        for g, v in zip(grads, variables):
            v.assign_sub(LR * g)
        return loss

    losses = [float(tape_step(x[i * BATCH:(i + 1) * BATCH],
                              y[i * BATCH:(i + 1) * BATCH]))
              for i in range(STEPS - 1)]
    opt = hvd.DistributedOptimizer(PlainSGD(LR))
    with tf.GradientTape() as tape:
        loss = loss_of(x[-BATCH:], y[-BATCH:])
    opt.apply_gradients(zip(tape.gradient(loss, variables), variables))
    losses.append(float(loss))
    res = {f"w{i}": v.numpy() for i, v in enumerate(variables)}
    dtypes = {}
    for key, val in collective_inputs(rank).items():
        t = tf.constant(val)
        outs = {"sum": hvd.allreduce(t, op=hvd.Sum, name=f"ar.{key}"),
                "gather": hvd.allgather(t, name=f"ag.{key}"),
                "bcast": hvd.broadcast(t, 1, name=f"bc.{key}")}
        if key != "i64":
            outs["avg"] = hvd.allreduce(t, name=f"avg.{key}")
            outs["rs"] = hvd.reducescatter(t, op=hvd.Sum, name=f"rs.{key}")
        for op, out in outs.items():
            res[f"{op}_{key}"] = out.numpy()
            dtypes[f"{op}_{key}"] = out.dtype.name
    return res, {"losses": losses, "dtypes": dtypes}


def keras_job(rank, size):
    import keras
    hvd = __import__(f"{PKG}.keras", fromlist=["x"])
    seen = []
    if PKG == "horovod_tpu_torch":
        from horovod_tpu_torch.ops import collectives as c
        plain = c.grouped_allreduce

        def recording(tensors, *a, **k):
            seen.append([(type(t).__name__, str(t.device)) for t in tensors])
            return plain(tensors, *a, **k)
        c.grouped_allreduce = recording
    model = keras.Sequential([keras.layers.Input((8,)),
                              keras.layers.Dense(16, activation="relu"),
                              keras.layers.Dense(4)])
    model.set_weights(weights(rank))
    model.compile(optimizer=hvd.DistributedOptimizer(
        keras.optimizers.SGD(LR)), loss="mse")
    x, y = data(rank)
    hist = model.fit(x, y, batch_size=BATCH, epochs=1, shuffle=False,
                     verbose=0, callbacks=[
                         hvd.callbacks.BroadcastGlobalVariablesCallback(0),
                         hvd.callbacks.MetricAverageCallback()])
    res = {f"w{i}": np.asarray(w) for i, w in enumerate(model.get_weights())}
    return res, {"losses": [float(v) for v in hist.history["loss"]],
                 "backend": keras.backend.backend(), "seen": seen}


def main():
    core = __import__(PKG)
    if len(sys.argv) == 3:        # under the launcher
        mode, out_dir = sys.argv[1:3]
        core.init()
    else:
        mode, rank, size, rdv, port, out_dir = sys.argv[1:7]
        native = __import__(f"{PKG}.native", fromlist=["x"])
        peers = torch_port_launch.peers(rdv, int(rank), int(size),
                                        native.reserve_listen_port)
        os.environ.update(torch_port_launch.launcher_env(
            int(rank), int(size), peers, int(port)))
        if PKG == "horovod_tpu_torch":
            core.init(device="cpu")
        else:
            core.init()
    rank, size = core.rank(), core.size()
    try:
        res, checks = (tf_job if mode == "tf" else keras_job)(rank, size)
    finally:
        core.shutdown()
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(checks, f)


if __name__ == "__main__":
    main()

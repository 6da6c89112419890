"""One rank of a two-rank job of a Spark estimator's executor body (the
Spark-free ``fit_on_parquet*`` loops), for tests/test_torch_port_spark.py
and tests/test_torch_port_spark_cuda.py. The package comes from the
environment, so that one script runs the port and the JAX package on the
same parquet shards and the same starting weights:

    SPARK_PKG=horovod_tpu_torch|horovod_tpu STORE_PREFIX=DIR \\
        python torch_port_spark_worker.py MODE RANK SIZE RDV_DIR \\
        MASTER_PORT OUT

or, for the port on GPUs (one rank per card), under its launcher:

    SPARK_PKG=horovod_tpu_torch STORE_PREFIX=DIR python -m \\
        horovod_tpu_torch.runner.launch -np 2 python \\
        torch_port_spark_worker.py MODE OUT

MODE ``torch``: ``fit_on_parquet_torch`` (Adam, 5 epochs, a validation
split), then a second run with ``backward_passes_per_step=2`` and bf16
compression. MODE ``lightning``: ``fit_on_parquet_lightning`` with a
LightningModule-protocol module (a scheduler stepped per epoch). MODE
``keras``: ``fit_on_parquet`` (the port under ``KERAS_BACKEND=torch``, the
JAX package under tensorflow) with bf16 compression. The model is a linear
layer 4 -> 1 whose starting weights come from numpy, shifted by the rank
(the broadcast from rank 0 must undo the shift).

Each rank writes ``OUT/r<rank>.json``: the histories, the devices the torch
models computed on, and the port's device and backend.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
PKG = os.environ.get("SPARK_PKG", "horovod_tpu_torch")
if len(sys.argv) > 1 and sys.argv[1] == "keras":
    os.environ.setdefault("KERAS_BACKEND", "torch" if PKG.endswith("_torch")
                          else "tensorflow")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_port_launch  # noqa: E402

W0 = np.array([[0.3, -0.2, 0.1, 0.5]], np.float32)
SEEN = set()        # the devices the model computed on


def linear(rank):
    model = torch.nn.Linear(4, 1)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(W0 + rank))
        model.bias.fill_(0.1 * rank)
    return model


class LinearLightning(torch.nn.Module):
    """The LightningModule protocol on a plain module (no lightning
    package): training_step, validation_step, configure_optimizers."""

    def __init__(self, rank=0):
        super().__init__()
        self.net = linear(rank)
        self.epoch_ends = 0

    def forward(self, x):
        return self.net(x)

    def training_step(self, batch, batch_idx):
        x, y = batch
        out = self(x)
        SEEN.add(str(out.device))
        return {"loss": torch.nn.functional.mse_loss(
            out.squeeze(-1), y.to(torch.float32))}

    def validation_step(self, batch, batch_idx):
        x, y = batch
        return torch.nn.functional.mse_loss(self(x).squeeze(-1),
                                            y.to(torch.float32))

    def configure_optimizers(self):
        opt = torch.optim.Adam(self.parameters(), lr=0.05)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=3, gamma=0.5)
        return {"optimizer": opt, "lr_scheduler": {"scheduler": sched}}

    def on_train_epoch_end(self):
        self.epoch_ends += 1


def write_parquet_dataset(path, n_files=4, rows_per_file=64, seed=0):
    """The estimator tests' dataset: y = x . w + 1 over 4 features, as
    parquet part files (a list column and a scalar column)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    w = np.array([1.0, -2.0, 3.0, 0.5], np.float64)
    for i in range(n_files):
        x = rng.uniform(-1, 1, size=(rows_per_file, 4))
        table = pa.table({
            "features": pa.array(list(x), type=pa.list_(pa.float64())),
            "label": pa.array(x @ w + 1.0),
        })
        pq.write_table(table, os.path.join(path, f"part-{i}.parquet"))


def mse(out, y):
    SEEN.add(str(out.device))
    return torch.nn.functional.mse_loss(out.squeeze(-1), y.to(out.dtype))


def torch_job(rank, store):
    from importlib import import_module
    est = import_module(f"{PKG}.spark.torch")
    compression = import_module(f"{PKG}.ops.compression").Compression
    common = dict(store_prefix=store, feature_cols=["features"],
                  label_cols=["label"], loss=mse)
    hist = est.fit_on_parquet_torch(
        run_id="torchrun", model_bytes=est.serialize_torch(linear(rank)),
        opt_spec=(torch.optim.Adam, {"lr": 0.05}), batch_size=16, epochs=5,
        validation=0.25, **common)
    hist2 = est.fit_on_parquet_torch(
        run_id="torchrun_agg", model_bytes=est.serialize_torch(linear(rank)),
        opt_spec=(torch.optim.Adam, {"lr": 0.05}), batch_size=8, epochs=4,
        backward_passes_per_step=2, compression=compression.bf16, **common)
    return {"history": hist, "history_agg": hist2}


def lightning_job(rank, store):
    from importlib import import_module
    est = import_module(f"{PKG}.spark.lightning")
    ser = import_module(f"{PKG}.spark.torch").serialize_torch
    hist = est.fit_on_parquet_lightning(
        store_prefix=store, run_id="plrun",
        module_bytes=ser(LinearLightning(rank)), feature_cols=["features"],
        label_cols=["label"], batch_size=16, epochs=5, validation=0.25)
    return {"history": hist}


def keras_job(rank, store):
    import keras
    from importlib import import_module
    est = import_module(f"{PKG}.spark.keras")
    compression = import_module(f"{PKG}.ops.compression").Compression
    model = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(1)])
    model.set_weights([W0.T + rank, np.full((1,), 0.1 * rank, np.float32)])
    hist = est.fit_on_parquet(
        store_prefix=store, run_id="testrun",
        model_bytes=est.serialize_model(model), feature_cols=["features"],
        label_cols=["label"], batch_size=16, epochs=5,
        optimizer={"class_name": "Adam",
                   "config": {"learning_rate": 0.05}},
        loss="mse", validation=0.25, compression=compression.bf16)
    return {"history": hist, "backend": keras.backend.backend()}


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
    rank = core.rank()
    job = {"torch": torch_job, "lightning": lightning_job,
           "keras": keras_job}[mode]
    res = job(rank, os.environ["STORE_PREFIX"])
    res["computed_on"] = sorted(SEEN)
    if PKG == "horovod_tpu_torch":
        import torch.distributed as dist
        res["device"] = str(core.device())
        res["backend_plane"] = dist.get_backend() \
            if dist.is_initialized() else None
    core.shutdown()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()

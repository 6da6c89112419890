"""Spark ML-style Torch estimator on the port (port of
``horovod_tpu/spark/torch.py``; reference:
horovod/spark/torch/estimator.py:91 ``TorchEstimator`` and
torch/remote.py's executor-side loop).

The worker-side loop (``fit_on_parquet_torch``) is Spark-free: Store,
parquet shards and the port's torch binding (its grad-hook
``DistributedOptimizer``). The model and its batches sit on the rank's
device (the runtime's: ``cuda:<local_rank>`` in a GPU job). Only DataFrame
materialization and ``transform`` need pyspark. A checkpoint is saved from
the device and loaded onto the CPU (``map_location``), so that a model
trained on GPUs predicts anywhere.
"""

import io
import uuid

import numpy as np

from ._transform import (check_output_width, materialize_df,
                         require_pyspark, transform_with)
from .data import stack_column as _stack_column
from .store import Store


def serialize_torch(obj):
    import torch
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def deserialize_torch(data, map_location="cpu"):
    import torch
    return torch.load(io.BytesIO(data), map_location=map_location,
                      weights_only=False)


def _optimizer_spec(optimizer):
    """(class, defaults) — enough to rebuild the optimizer against the
    deserialized model's parameters (reference:
    horovod/spark/torch/remote.py:444 get_optimizer_with_unscaled_lr).
    Multi-param-group optimizers cannot round-trip this way (parameter
    identity does not survive serialization), so they are rejected
    rather than silently rebuilt with one uniform setting. The live
    param_groups[0] hyperparameters are captured (not ``defaults``) so
    post-construction changes — manual decay, schedulers — survive."""
    if len(optimizer.param_groups) > 1:
        raise ValueError(
            "TorchEstimator supports single-param-group optimizers "
            "only: per-group hyperparameters cannot be re-attached to "
            "the deserialized model's parameters on the executors. "
            "Rebuild the groups inside a custom training fn run via "
            "horovod_tpu_torch.spark.run instead.")
    hparams = {k: v for k, v in optimizer.param_groups[0].items()
               if k != "params" and k in optimizer.defaults}
    return type(optimizer), hparams


def _resolve_loss(loss):
    if callable(loss):
        return loss
    import torch.nn.functional as F
    fn = getattr(F, loss, None)
    if fn is None:
        raise ValueError(f"unknown loss {loss!r} (not a callable or a "
                         "torch.nn.functional name)")
    return fn


def fit_on_parquet_torch(store_prefix, run_id, model_bytes, opt_spec,
                         loss, feature_cols, label_cols, batch_size=32,
                         epochs=1, validation=None,
                         train_steps_per_epoch=None, shuffle_seed=0,
                         verbose=0, train_path=None,
                         feature_dtype="float32", label_dtype=None,
                         compression=None, backward_passes_per_step=1):
    """Train one rank's shard; the executor body of
    ``TorchEstimator.fit`` (reference: horovod/spark/torch/remote.py:100
    ``train``). Returns {'loss': [...], 'val_loss': [...]} with metrics
    averaged across ranks; rank 0 checkpoints the model to the store."""
    import torch

    from .. import basics
    from .. import torch as hvd
    from .data import ParquetShard, shard_files

    hvd.init()
    rank, size = hvd.rank(), hvd.size()
    dev = basics.device()

    store = Store.create(store_prefix)
    train_path = train_path or store.get_train_data_path()
    files = shard_files(store.list_parquet_files(train_path), rank, size)
    cols = list(feature_cols) + list(label_cols)
    shard = ParquetShard(store, files, cols)

    model = deserialize_torch(model_bytes, map_location=dev)
    loss_fn = _resolve_loss(loss)
    opt_cls, opt_defaults = (opt_spec if isinstance(opt_spec, tuple)
                             else deserialize_torch(opt_spec))
    optimizer = opt_cls(model.parameters(), **opt_defaults)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression,
        backward_passes_per_step=backward_passes_per_step)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    n_rows = shard.num_rows
    val_batch = None
    if validation is not None:
        if not (isinstance(validation, float) and 0.0 < validation < 1.0):
            raise ValueError(
                f"validation must be a float in (0, 1) (got "
                f"{validation!r}); pre-split the DataFrame for "
                "indicator-column validation")
        val_rows = max(1, int(n_rows * validation))
        order = np.random.RandomState(shuffle_seed).permutation(n_rows)
        val_batch = {c: shard.columns[c][order[:val_rows]] for c in cols}
        shard.columns = {c: shard.columns[c][order[val_rows:]]
                         for c in cols}
        shard.num_rows -= val_rows
        n_rows -= val_rows

    if size > 1:
        n_rows = int(min(
            int(t) for t in hvd.allgather(torch.tensor(
                [n_rows], dtype=torch.int64, device=dev))))
    if n_rows == 0:
        # Raise on ALL ranks (the allgathered min is identical
        # everywhere): one rank raising alone would leave its peers
        # deadlocked in the first gradient allreduce.
        raise ValueError(
            "a rank has 0 training rows after the validation split; "
            "repartition the dataset or lower the validation fraction")
    steps = train_steps_per_epoch or max(1, n_rows // batch_size)
    k = int(backward_passes_per_step)
    if k > 1:
        # The wrapper syncs every k-th backward and expects grads to
        # accumulate across the window (zero_grad/step only at window
        # boundaries). Trim the epoch to whole windows so no partially
        # accumulated, un-synced gradient is ever applied.
        steps = max(k, (steps // k) * k)

    def to_xy(batch):
        xs = [torch.as_tensor(_stack_column(batch[c])).to(
            dev, getattr(torch, feature_dtype)) for c in feature_cols]
        ys = []
        for c in label_cols:
            y = torch.as_tensor(_stack_column(batch[c])).to(dev)
            if label_dtype is not None:
                y = y.to(getattr(torch, label_dtype))
            ys.append(y)
        return (xs[0] if len(xs) == 1 else xs,
                ys[0] if len(ys) == 1 else ys)

    # Async batch assembly: stacking + tensor conversion overlap the
    # training step (reference: pytorch_data_loaders.py:71 async loader).
    from .data import AsyncShardBatchLoader
    loader = AsyncShardBatchLoader(shard=shard, batch_size=batch_size,
                                   steps=steps, transform=to_xy,
                                   seed=shuffle_seed + rank)
    history = {"loss": []}
    if val_batch is not None:
        history["val_loss"] = []

    model.train()
    try:
        for epoch in range(epochs):
            total = 0.0
            micro = 0
            for x, y in loader:
                if micro % k == 0:
                    optimizer.zero_grad()
                loss_val = loss_fn(model(x), y)
                loss_val.backward()
                micro += 1
                if micro % k == 0:
                    # k==1: every batch. k>1: the k-th backward fired the
                    # allreduce over the accumulated grads (postscaled
                    # 1/k by the wrapper); step() applies the average.
                    optimizer.step()
                total += float(loss_val.detach())
            # Cross-rank metric averaging (the MetricAverageCallback analog).
            avg = float(hvd.allreduce(
                torch.tensor([total / steps], device=dev),
                name=f"ep{epoch}.loss"))
            history["loss"].append(avg)
            if val_batch is not None:
                # Batched eval: one whole-split forward would allocate
                # activations for 25% of a host-RAM-sized shard at once.
                model.eval()
                n_val = len(next(iter(val_batch.values())))
                vl_sum, vl_n = 0.0, 0
                with torch.no_grad():
                    for start in range(0, n_val, batch_size):
                        chunk = {c: v[start:start + batch_size]
                                 for c, v in val_batch.items()}
                        vx, vy = to_xy(chunk)
                        rows = len(next(iter(chunk.values())))
                        vl_sum += float(loss_fn(model(vx), vy)) * rows
                        vl_n += rows
                model.train()
                # `val_batch is not None` is replica-invariant: it is
                # decided by the `validation` argument (same on every
                # rank) — val_rows = max(1, ...) guarantees a non-None
                # val_batch on EVERY rank whenever validation is set,
                # even for ranks whose shard taint suggests otherwise.
                # hvd-lint: disable=HVD401
                history["val_loss"].append(float(hvd.allreduce(
                    torch.tensor([vl_sum / vl_n], device=dev),
                    name=f"ep{epoch}.vloss")))
            if verbose and rank == 0:
                print(f"epoch {epoch}: " + ", ".join(
                    f"{k}={v[-1]:.4f}" for k, v in history.items()),
                    flush=True)

    finally:
        loader.close()
    if rank == 0:
        store.write(store.get_checkpoint_path(run_id),
                    serialize_torch(model))
    hvd.barrier()
    return history


class TorchModel:
    """Trained-model transformer (reference:
    horovod/spark/torch/estimator.py TorchModel)."""

    def __init__(self, model_bytes, feature_cols, label_cols,
                 output_cols=None, feature_dtype="float32"):
        self.model_bytes = model_bytes
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.output_cols = list(
            output_cols or [f"{c}__output" for c in label_cols])
        self.feature_dtype = feature_dtype

    def torch_model(self):
        return deserialize_torch(self.model_bytes)

    def predict(self, features):
        import torch
        model = self.torch_model()
        model.eval()
        xs = [torch.as_tensor(_stack_column(np.asarray(f))).to(
            getattr(torch, self.feature_dtype)) for f in features]
        with torch.no_grad():
            out = model(xs[0] if len(xs) == 1 else xs).numpy()
        check_output_width(out.reshape(len(out), -1), self.output_cols)
        return out

    def transform(self, df):
        model_bytes = self.model_bytes
        feature_dtype = self.feature_dtype

        def make_predict():
            import torch
            model = deserialize_torch(model_bytes)
            model.eval()

            def predict(feats):
                xs = [torch.as_tensor(f).to(getattr(torch, feature_dtype))
                      for f in feats]
                with torch.no_grad():
                    return model(xs[0] if len(xs) == 1 else xs).numpy()
            return predict

        return transform_with(df, self.feature_cols, self.output_cols,
                              make_predict)


class TorchEstimator:
    """Fit a torch model to a Spark DataFrame over the port's ranks
    (reference: horovod/spark/torch/estimator.py:91)."""

    def __init__(self, model=None, store=None, optimizer=None, loss=None,
                 feature_cols=None, label_cols=None, batch_size=32,
                 epochs=1, num_proc=None, validation=None, run_id=None,
                 train_steps_per_epoch=None, verbose=1,
                 feature_dtype="float32", label_dtype=None,
                 compression=None, backward_passes_per_step=1):
        if model is None or store is None or optimizer is None:
            raise ValueError(
                "TorchEstimator requires model=, store= and optimizer=")
        if not feature_cols or not label_cols:
            raise ValueError("feature_cols and label_cols are required")
        if loss is None:
            raise ValueError("loss is required (callable or "
                             "torch.nn.functional name)")
        self.model = model
        self.store = (store if isinstance(store, Store)
                      else Store.create(store))
        self.optimizer = optimizer
        self.loss = loss
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.batch_size = batch_size
        self.epochs = epochs
        self.num_proc = num_proc
        self.validation = validation
        self.run_id = run_id or f"run_{uuid.uuid4().hex[:8]}"
        self.train_steps_per_epoch = train_steps_per_epoch
        self.verbose = verbose
        self.feature_dtype = feature_dtype
        self.label_dtype = label_dtype
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step

    def fit(self, df):
        require_pyspark("TorchEstimator.fit")
        from . import run as spark_run
        from pyspark import SparkContext

        sc = SparkContext.getOrCreate()
        num_proc = self.num_proc or sc.defaultParallelism
        materialize_df(df, self.store, num_proc)

        spark_run(
            fit_on_parquet_torch, kwargs=dict(
                store_prefix=self.store.prefix_path,
                run_id=self.run_id,
                model_bytes=serialize_torch(self.model),
                opt_spec=_optimizer_spec(self.optimizer),
                loss=self.loss,
                feature_cols=self.feature_cols,
                label_cols=self.label_cols,
                batch_size=self.batch_size,
                epochs=self.epochs,
                validation=self.validation,
                train_steps_per_epoch=self.train_steps_per_epoch,
                verbose=self.verbose,
                feature_dtype=self.feature_dtype,
                label_dtype=self.label_dtype,
                compression=self.compression,
                backward_passes_per_step=self.backward_passes_per_step),
            num_proc=num_proc)
        return self.load(self.store, self.run_id,
                         feature_cols=self.feature_cols,
                         label_cols=self.label_cols,
                         feature_dtype=self.feature_dtype)

    @staticmethod
    def load(store, run_id, feature_cols, label_cols,
             feature_dtype="float32"):
        store = store if isinstance(store, Store) else Store.create(store)
        data = store.read(store.get_checkpoint_path(run_id))
        return TorchModel(data, feature_cols, label_cols,
                          feature_dtype=feature_dtype)

"""Spark ML-style Lightning estimator on the port (port of
``horovod_tpu/spark/lightning.py``; reference:
horovod/spark/lightning/estimator.py:100 ``TorchEstimator`` [the lightning
flavor] and lightning/remote.py's executor loop). The module and its
batches sit on the rank's device.

Design difference from the reference: the reference embeds a full
``pl.Trainer`` on every executor (remote.py:348). Here the estimator
consumes the **LightningModule protocol** — ``training_step``,
``configure_optimizers``, optional ``validation_step`` /
``on_train_epoch_end`` — and drives it with the same Spark-free shard
loop the Keras/Torch flavors use (spark/keras.py, spark/torch.py). Any
real ``pytorch_lightning.LightningModule`` satisfies the protocol (it is
just an ``nn.Module`` with those methods), but the integration neither
imports nor requires the lightning package.
The optimizer round-trip problem the torch estimator has (rebuilding
param groups on the executor) disappears entirely: Lightning modules
construct their own optimizers on the worker via
``configure_optimizers``.

Batches arrive as ``(features, labels)`` tuples (single-tensor when one
column), the dominant LightningModule convention.
"""

import uuid

import numpy as np

from ._transform import (check_output_width, materialize_df,
                         require_pyspark, transform_with)
from .data import stack_column as _stack_column
from .store import Store
from .torch import deserialize_torch, serialize_torch


def _resolve_optimizers(module):
    """Normalize configure_optimizers() output to (optimizer, schedulers)
    (Lightning accepts several shapes; multi-optimizer setups — GAN
    style — need a custom loop via horovod_tpu_torch.spark.run)."""
    cfg = module.configure_optimizers()
    if cfg is None:
        raise ValueError("configure_optimizers() returned None")
    schedulers = []
    if isinstance(cfg, tuple) and len(cfg) == 2 \
            and isinstance(cfg[0], (list, tuple)):
        opts, schedulers = list(cfg[0]), list(cfg[1])
    elif isinstance(cfg, (list, tuple)):
        opts = list(cfg)
    elif isinstance(cfg, dict):
        opts = [cfg["optimizer"]]
        if cfg.get("lr_scheduler") is not None:
            schedulers = [cfg["lr_scheduler"]]
    else:
        opts = [cfg]
    if len(opts) != 1:
        raise ValueError(
            f"LightningEstimator supports exactly one optimizer; "
            f"configure_optimizers() returned {len(opts)}. Drive "
            "multi-optimizer training with a custom fn via "
            "horovod_tpu_torch.spark.run.")
    # Scheduler dicts ({'scheduler': ..., 'interval': ...}) -> object.
    schedulers = [s["scheduler"] if isinstance(s, dict) else s
                  for s in schedulers]
    return opts[0], schedulers


def _step_loss(out):
    """training_step may return a loss tensor or a dict with 'loss'."""
    if isinstance(out, dict):
        out = out.get("loss")
    if out is None:
        raise ValueError(
            "training_step returned no loss (None or a dict without "
            "'loss'); manual-optimization modules are out of scope")
    return out


def fit_on_parquet_lightning(store_prefix, run_id, module_bytes,
                             feature_cols, label_cols, batch_size=32,
                             epochs=1, validation=None,
                             train_steps_per_epoch=None, shuffle_seed=0,
                             verbose=0, train_path=None,
                             feature_dtype="float32", label_dtype=None,
                             compression=None):
    """Train one rank's shard; the executor body of
    ``LightningEstimator.fit`` (reference:
    horovod/spark/lightning/remote.py:100 ``train``). Returns
    {'loss': [...], 'val_loss': [...]} averaged across ranks; rank 0
    checkpoints the module to the store."""
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

    module = deserialize_torch(module_bytes, map_location=dev)
    optimizer, schedulers = _resolve_optimizers(module)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=module.named_parameters(),
        compression=compression)
    hvd.broadcast_parameters(module.state_dict(), root_rank=0)
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
        # everywhere) — see spark/torch.py on deadlock avoidance.
        raise ValueError(
            "a rank has 0 training rows after the validation split; "
            "repartition the dataset or lower the validation fraction")
    steps = train_steps_per_epoch or max(1, n_rows // batch_size)

    def to_batch(raw):
        xs = [torch.as_tensor(_stack_column(raw[c])).to(
            dev, getattr(torch, feature_dtype)) for c in feature_cols]
        ys = []
        for c in label_cols:
            y = torch.as_tensor(_stack_column(raw[c])).to(dev)
            if label_dtype is not None:
                y = y.to(getattr(torch, label_dtype))
            ys.append(y)
        return (xs[0] if len(xs) == 1 else xs,
                ys[0] if len(ys) == 1 else ys)

    # Async batch assembly overlapping the step (reference:
    # pytorch_data_loaders.py:71; see spark/data.py).
    from .data import AsyncShardBatchLoader
    loader = AsyncShardBatchLoader(shard=shard, batch_size=batch_size,
                                   steps=steps, transform=to_batch,
                                   seed=shuffle_seed + rank)
    history = {"loss": []}
    if val_batch is not None:
        history["val_loss"] = []

    module.train()
    global_step = 0
    try:
        for epoch in range(epochs):
            total = 0.0
            for batch in loader:
                optimizer.zero_grad()
                loss = _step_loss(module.training_step(batch, global_step))
                loss.backward()
                optimizer.step()
                total += float(loss.detach())
                global_step += 1
            for sched in schedulers:
                sched.step()
            avg = float(hvd.allreduce(
                torch.tensor([total / steps], device=dev),
                name=f"ep{epoch}.loss"))
            history["loss"].append(avg)
            if val_batch is not None:
                module.eval()
                n_val = len(next(iter(val_batch.values())))
                vl_sum, vl_n = 0.0, 0
                with torch.no_grad():
                    for start in range(0, n_val, batch_size):
                        chunk = {c: v[start:start + batch_size]
                                 for c, v in val_batch.items()}
                        vb = to_batch(chunk)
                        rows = len(next(iter(chunk.values())))
                        # Real pl.LightningModule defines a validation_step
                        # STUB returning None on the base class, so hasattr
                        # alone cannot detect an override — a None loss means
                        # "not implemented here", fall back to training_step.
                        vloss = None
                        if hasattr(module, "validation_step"):
                            out = module.validation_step(
                                vb, start // batch_size)
                            vloss = (out.get("loss")
                                     if isinstance(out, dict) else out)
                        if vloss is None:
                            vloss = _step_loss(module.training_step(
                                vb, start // batch_size))
                        vl_sum += float(vloss) * rows
                        vl_n += rows
                module.train()
                # `val_batch is not None` is replica-invariant: decided
                # by the `validation` argument (same on every rank),
                # with val_rows = max(1, ...) guaranteeing a non-None
                # val_batch on EVERY rank whenever validation is set.
                # hvd-lint: disable=HVD401
                history["val_loss"].append(float(hvd.allreduce(
                    torch.tensor([vl_sum / vl_n], device=dev),
                    name=f"ep{epoch}.vloss")))
            if hasattr(module, "on_train_epoch_end"):
                module.on_train_epoch_end()
            if verbose and rank == 0:
                print(f"epoch {epoch}: " + ", ".join(
                    f"{k}={v[-1]:.4f}" for k, v in history.items()),
                    flush=True)

    finally:
        loader.close()
    if rank == 0:
        store.write(store.get_checkpoint_path(run_id),
                    serialize_torch(module))
    hvd.barrier()
    return history


class LightningModel:
    """Trained-module transformer (reference:
    horovod/spark/lightning/estimator.py TorchModel)."""

    def __init__(self, module_bytes, feature_cols, label_cols,
                 output_cols=None, feature_dtype="float32"):
        self.module_bytes = module_bytes
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.output_cols = list(
            output_cols or [f"{c}__output" for c in label_cols])
        self.feature_dtype = feature_dtype

    def lightning_module(self):
        return deserialize_torch(self.module_bytes)

    def predict(self, features):
        import torch
        module = self.lightning_module()
        module.eval()
        xs = [torch.as_tensor(_stack_column(np.asarray(f))).to(
            getattr(torch, self.feature_dtype)) for f in features]
        with torch.no_grad():
            out = module(xs[0] if len(xs) == 1 else xs).numpy()
        check_output_width(out.reshape(len(out), -1), self.output_cols)
        return out

    def transform(self, df):
        module_bytes = self.module_bytes
        feature_dtype = self.feature_dtype

        def make_predict():
            import torch
            module = deserialize_torch(module_bytes)
            module.eval()

            def predict(feats):
                xs = [torch.as_tensor(f).to(getattr(torch, feature_dtype))
                      for f in feats]
                with torch.no_grad():
                    return module(xs[0] if len(xs) == 1 else xs).numpy()
            return predict

        return transform_with(df, self.feature_cols, self.output_cols,
                              make_predict)


class LightningEstimator:
    """Fit a LightningModule-protocol model to a Spark DataFrame over
    the port's ranks (reference:
    horovod/spark/lightning/estimator.py:100)."""

    def __init__(self, model=None, store=None, feature_cols=None,
                 label_cols=None, batch_size=32, epochs=1, num_proc=None,
                 validation=None, run_id=None,
                 train_steps_per_epoch=None, verbose=1,
                 feature_dtype="float32", label_dtype=None,
                 compression=None):
        if model is None or store is None:
            raise ValueError("LightningEstimator requires model= and "
                             "store=")
        for method in ("training_step", "configure_optimizers"):
            if not callable(getattr(model, method, None)):
                raise ValueError(
                    f"model must implement the LightningModule protocol; "
                    f"missing {method}()")
        if not feature_cols or not label_cols:
            raise ValueError("feature_cols and label_cols are required")
        self.model = model
        self.store = (store if isinstance(store, Store)
                      else Store.create(store))
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

    def fit(self, df):
        require_pyspark("LightningEstimator.fit")
        from . import run as spark_run
        from pyspark import SparkContext

        sc = SparkContext.getOrCreate()
        num_proc = self.num_proc or sc.defaultParallelism
        materialize_df(df, self.store, num_proc)

        spark_run(
            fit_on_parquet_lightning, kwargs=dict(
                store_prefix=self.store.prefix_path,
                run_id=self.run_id,
                module_bytes=serialize_torch(self.model),
                feature_cols=self.feature_cols,
                label_cols=self.label_cols,
                batch_size=self.batch_size,
                epochs=self.epochs,
                validation=self.validation,
                train_steps_per_epoch=self.train_steps_per_epoch,
                verbose=self.verbose,
                feature_dtype=self.feature_dtype,
                label_dtype=self.label_dtype,
                compression=self.compression),
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
        return LightningModel(data, feature_cols, label_cols,
                              feature_dtype=feature_dtype)

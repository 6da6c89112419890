"""Spark ML-style Keras estimator on the port (port of
``horovod_tpu/spark/keras.py``; reference:
horovod/spark/keras/estimator.py:88 ``KerasEstimator`` and
horovod/spark/keras/remote.py's executor-side training loop).

The worker-side training loop (``fit_on_parquet``) is plain Python over a
``Store`` and parquet shards, on the port's keras binding: under
``KERAS_BACKEND=torch`` keras places the model on the rank's CUDA device.
Only the DataFrame materialization and ``transform`` touch pyspark; keras
is imported at the use.

    est = KerasEstimator(model=model, optimizer="adam", loss="mse",
                         feature_cols=["x"], label_cols=["y"],
                         store=Store.create("/tmp/run"), epochs=2)
    keras_model = est.fit(df)          # Spark path
    hist = fit_on_parquet(...)         # same loop, no Spark needed
"""

import os
import tempfile
import uuid

import numpy as np

from ._transform import (check_output_width, materialize_df,
                         require_pyspark, transform_with)
from .data import stack_column as _stack_column
from .store import Store


def serialize_model(model):
    """Keras model -> bytes via the native .keras archive."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.keras")
        model.save(path)
        with open(path, "rb") as f:
            return f.read()


def deserialize_model(data, custom_objects=None):
    import keras
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.keras")
        with open(path, "wb") as f:
            f.write(data)
        return keras.models.load_model(
            path, custom_objects=custom_objects, compile=False)


def fit_on_parquet(store_prefix, run_id, model_bytes, feature_cols,
                   label_cols, batch_size=32, epochs=1, optimizer=None,
                   loss=None, metrics=None, custom_objects=None,
                   validation=None, callbacks=None,
                   train_steps_per_epoch=None, shuffle_seed=0, verbose=0,
                   train_path=None, compression=None,
                   backward_passes_per_step=1):
    """Train one rank's shard of a materialized parquet dataset; the
    executor-side body of ``KerasEstimator.fit`` (reference:
    horovod/spark/keras/remote.py:31 ``RemoteTrainer``).

    Every rank runs the same number of optimizer steps per epoch (min
    shard size across ranks) so the gradient collectives stay in
    lockstep. Rank 0 writes the trained model to the store's checkpoint
    path. Returns the keras History dict.
    """
    from .. import keras as hvd
    from .data import ParquetShard, shard_files

    hvd.init()
    rank, size = hvd.rank(), hvd.size()

    store = Store.create(store_prefix)
    train_path = train_path or store.get_train_data_path()
    files = shard_files(store.list_parquet_files(train_path), rank, size)
    cols = list(feature_cols) + list(label_cols)
    shard = ParquetShard(store, files, cols)

    model = deserialize_model(model_bytes, custom_objects)
    import keras
    opt = keras.optimizers.get(optimizer or "adam")
    model.compile(
        optimizer=hvd.DistributedOptimizer(
            opt, compression=compression,
            backward_passes_per_step=backward_passes_per_step),
        loss=loss, metrics=list(metrics or []))

    val_rows = 0
    n_rows = shard.num_rows
    if validation is not None:
        # Only a float split fraction is supported (the reference also
        # accepts a 0/1 indicator column; fail loudly rather than train
        # silently without validation).
        if not (isinstance(validation, float) and 0.0 < validation < 1.0):
            raise ValueError(
                f"validation must be a float in (0, 1) (got "
                f"{validation!r}); indicator-column validation is not "
                "supported — pre-split the DataFrame instead")
        val_rows = max(1, int(n_rows * validation))
        n_rows -= val_rows

    val_batch = None
    if val_rows:
        # Carve validation rows OUT of the training shard (training on
        # them would optimistically bias val metrics and anything that
        # selects on them, e.g. EarlyStopping).
        order = np.random.RandomState(shuffle_seed).permutation(
            shard.num_rows)
        val_batch = {c: shard.columns[c][order[:val_rows]]
                     for c in cols}
        shard.columns = {c: shard.columns[c][order[val_rows:]]
                         for c in cols}
        shard.num_rows -= val_rows

    # Lockstep step count: min trainable rows across ranks.
    if size > 1:
        n_rows = int(np.min(keras.ops.convert_to_numpy(
            hvd.allgather(np.asarray([n_rows], np.int64)))))
    if n_rows == 0:
        # Raise on ALL ranks (the allgathered min is identical
        # everywhere): one rank raising alone would leave its peers
        # deadlocked in the first gradient allreduce.
        raise ValueError(
            "a rank has 0 training rows after the validation split; "
            "repartition the dataset or lower the validation fraction")
    steps = train_steps_per_epoch or max(1, n_rows // batch_size)

    def to_xy(batch):
        xs = [_stack_column(batch[c]) for c in feature_cols]
        ys = [_stack_column(batch[c]) for c in label_cols]
        return (xs[0] if len(xs) == 1 else tuple(xs),
                ys[0] if len(ys) == 1 else tuple(ys))

    # Async batch assembly overlapping fit steps (reference:
    # pytorch_data_loaders.py:71; see spark/data.py). Keras pulls one
    # continuous stream across epochs; +2 covers its lookahead prefetch.
    from .data import AsyncShardBatchLoader
    loader = AsyncShardBatchLoader(shard=shard, batch_size=batch_size,
                                   steps=steps * epochs + 2,
                                   transform=to_xy,
                                   seed=shuffle_seed + rank)

    fit_kwargs = {}
    if val_batch is not None:
        fit_kwargs["validation_data"] = to_xy(val_batch)

    cbs = [hvd.callbacks.BroadcastGlobalVariablesCallback(0),
           hvd.callbacks.MetricAverageCallback()]
    cbs += list(callbacks or [])

    try:
        history = model.fit(iter(loader), steps_per_epoch=steps,
                            epochs=epochs, callbacks=cbs, verbose=verbose,
                            **fit_kwargs)
    finally:
        loader.close()

    if rank == 0:
        store.write(store.get_checkpoint_path(run_id),
                    serialize_model(model))
    hvd.allreduce(np.zeros(1, np.float32), name="fit.final.barrier")
    return {k: [float(v) for v in vs] for k, vs in
            history.history.items()}


class KerasModel:
    """Trained-model transformer (reference:
    horovod/spark/keras/estimator.py KerasModel): holds the serialized
    model; ``transform`` adds a prediction column per output."""

    def __init__(self, model_bytes, feature_cols, label_cols,
                 custom_objects=None, output_cols=None):
        self.model_bytes = model_bytes
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.custom_objects = custom_objects
        self.output_cols = list(
            output_cols or [f"{c}__output" for c in label_cols])

    def keras_model(self):
        return deserialize_model(self.model_bytes, self.custom_objects)

    def predict(self, features):
        """Local numpy prediction (no Spark needed)."""
        xs = [_stack_column(np.asarray(f)) for f in features]
        preds = np.asarray(self.keras_model().predict(
            xs[0] if len(xs) == 1 else tuple(xs), verbose=0))
        check_output_width(preds.reshape(len(preds), -1),
                           self.output_cols)
        return preds

    def transform(self, df):
        """Append prediction columns to a Spark DataFrame via
        mapInPandas (executor-local inference)."""
        model_bytes = self.model_bytes
        custom_objects = self.custom_objects

        def make_predict():
            model = deserialize_model(model_bytes, custom_objects)
            return lambda feats: model.predict(
                feats[0] if len(feats) == 1 else tuple(feats), verbose=0)

        return transform_with(df, self.feature_cols, self.output_cols,
                              make_predict)


class KerasEstimator:
    """Fit a Keras model to a Spark DataFrame over the port's ranks
    (reference: horovod/spark/keras/estimator.py:88). Parameters follow
    the reference's core set; petastorm streaming knobs are absorbed by
    the in-memory shard reader (data.py)."""

    def __init__(self, model=None, store=None, optimizer=None, loss=None,
                 metrics=None, feature_cols=None, label_cols=None,
                 batch_size=32, epochs=1, num_proc=None, validation=None,
                 callbacks=None, custom_objects=None, run_id=None,
                 train_steps_per_epoch=None, verbose=1, compression=None,
                 backward_passes_per_step=1):
        if model is None or store is None:
            raise ValueError("KerasEstimator requires model= and store=")
        if not feature_cols or not label_cols:
            raise ValueError("feature_cols and label_cols are required")
        self.model = model
        self.store = (store if isinstance(store, Store)
                      else Store.create(store))
        self.optimizer = optimizer
        self.loss = loss
        self.metrics = metrics
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.batch_size = batch_size
        self.epochs = epochs
        self.num_proc = num_proc
        self.validation = validation
        self.callbacks = callbacks
        self.custom_objects = custom_objects
        self.run_id = run_id or f"run_{uuid.uuid4().hex[:8]}"
        self.train_steps_per_epoch = train_steps_per_epoch
        self.verbose = verbose
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step

    def fit(self, df):
        require_pyspark("KerasEstimator.fit")
        from . import run as spark_run
        from pyspark import SparkContext

        sc = SparkContext.getOrCreate()
        num_proc = self.num_proc or sc.defaultParallelism
        materialize_df(df, self.store, num_proc)

        spark_run(
            fit_on_parquet, kwargs=dict(
                store_prefix=self.store.prefix_path,
                run_id=self.run_id,
                model_bytes=serialize_model(self.model),
                feature_cols=self.feature_cols,
                label_cols=self.label_cols,
                batch_size=self.batch_size,
                epochs=self.epochs,
                optimizer=self.optimizer,
                loss=self.loss,
                metrics=self.metrics,
                custom_objects=self.custom_objects,
                validation=self.validation,
                callbacks=self.callbacks,
                train_steps_per_epoch=self.train_steps_per_epoch,
                verbose=self.verbose,
                compression=self.compression,
                backward_passes_per_step=self.backward_passes_per_step),
            num_proc=num_proc)
        return self.load(self.store, self.run_id,
                         feature_cols=self.feature_cols,
                         label_cols=self.label_cols,
                         custom_objects=self.custom_objects)

    @staticmethod
    def load(store, run_id, feature_cols, label_cols,
             custom_objects=None):
        """Rehydrate the trained transformer from a store checkpoint."""
        store = store if isinstance(store, Store) else Store.create(store)
        data = store.read(store.get_checkpoint_path(run_id))
        return KerasModel(data, feature_cols, label_cols,
                          custom_objects=custom_objects)

"""Parquet shard reading for estimator training (port of
``horovod_tpu/spark/data.py``; reference: horovod/spark/common/util.py's
DataFrame -> parquet preparation and the petastorm readers, redesigned
over pyarrow). pyarrow is imported when a shard is read, never at import.

The shard unit is the parquet part file: rank r trains on files
``files[r::size]``, deterministic and disjoint, with no Spark runtime.
``AsyncShardBatchLoader`` assembles batches (index, stack, conversion to
the framework's tensors) on a background thread with a bounded queue
(reference: horovod/spark/data_loaders/pytorch_data_loaders.py:71).
"""

import numpy as np

from ..data.data_loader_base import AsyncDataLoaderMixin, BaseDataLoader


def _parquet():
    try:
        import pyarrow.parquet as pq
        return pq
    except ImportError as e:
        raise ImportError(
            "reading parquet shards requires pyarrow, which is not "
            "installed in this environment") from e


def stack_column(col):
    """Parquet list columns come back as object arrays of arrays; stack them
    into one dense array."""
    if col.dtype == object:
        return np.stack([np.asarray(v) for v in col])
    return col


def shard_files(files, rank, size):
    """Round-robin file assignment; raises when there are fewer files than
    ranks (repartition the DataFrame to at least ``size`` partitions)."""
    files = sorted(files)
    if len(files) < size:
        raise ValueError(
            f"parquet dataset has {len(files)} part files but the job has "
            f"{size} ranks; repartition the DataFrame to >= {size}")
    return files[rank::size]


class ParquetShard:
    """One rank's slice of a parquet dataset, materialized to numpy:
    ``columns[name]`` is the whole shard as one array."""

    def __init__(self, store, files, columns):
        pq = _parquet()
        tables = []
        for f in files:
            with store.fs.open(f, "rb") as fh:
                tables.append(pq.read_table(fh, columns=list(columns)))
        if not tables:
            raise ValueError("empty shard: no parquet files assigned")
        self.columns = {}
        for name in columns:
            parts = [t.column(name).to_numpy(zero_copy_only=False)
                     for t in tables]
            self.columns[name] = np.concatenate(parts)
        self.num_rows = len(next(iter(self.columns.values())))

    def batches(self, batch_size, seed=0, shuffle=True):
        """Infinite batch generator, reshuffled every epoch, so that every
        rank can run the same number of steps whatever its shard's size
        (the collectives stay in lockstep)."""
        if self.num_rows == 0:
            # Empty batches would fail mid-job while peers block in the
            # gradient allreduce: fail now.
            raise ValueError(
                "shard has 0 training rows (empty part files, or a "
                "validation split consumed the whole shard); repartition "
                "the dataset or lower the validation fraction")
        rng = np.random.RandomState(seed)
        while True:
            order = (rng.permutation(self.num_rows) if shuffle
                     else np.arange(self.num_rows))
            for start in range(0, self.num_rows - batch_size + 1,
                               batch_size):
                idx = order[start:start + batch_size]
                yield {name: col[idx]
                       for name, col in self.columns.items()}
            if self.num_rows < batch_size:
                # Tiny shard: the whole shard rather than nothing.
                yield dict(self.columns)


class ShardBatchLoader(BaseDataLoader):
    """One epoch of transformed batches from a ParquetShard: exactly
    ``steps`` batches through ``transform``; the generator's position is
    kept across epochs so that data does not repeat."""

    def __init__(self, shard, batch_size, steps, transform=None, seed=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._gen = shard.batches(batch_size, seed=seed)
        self.steps = steps
        self.transform = transform or (lambda b: b)

    def __len__(self):
        return self.steps

    def __iter__(self):
        for _ in range(self.steps):
            yield self.transform(next(self._gen))


class AsyncShardBatchLoader(AsyncDataLoaderMixin, ShardBatchLoader):
    """Background-thread variant: each epoch's iteration starts a producer
    that prepares up to ``async_loader_queue_size`` transformed batches
    while the training step runs."""

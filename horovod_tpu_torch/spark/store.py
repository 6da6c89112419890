"""Run/data store for estimator-style training (port of
``horovod_tpu/spark/store.py``; reference: horovod/spark/common/store.py:
37-166 ``Store`` and its filesystem stores).

One fsspec-backed implementation covers local disk, HDFS, S3, GCS and DBFS
through one code path; ``Store.create`` picks the filesystem from the
path's protocol. fsspec is imported when a store is made.

Layout under ``prefix_path``::

    intermediate_train_data[.<idx>]/   parquet training shards
    intermediate_val_data[.<idx>]/     parquet validation shards
    runs/<run_id>/checkpoint.keras     model checkpoint
    runs/<run_id>/logs/                user logs
"""

import os


def _fsspec():
    try:
        import fsspec
        return fsspec
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark.Store requires fsspec, which is not "
            "installed in this environment") from e


class Store:
    """Abstracts reading/writing intermediate data and run results
    (reference: horovod/spark/common/store.py:37)."""

    def __init__(self, prefix_path):
        self.prefix_path = prefix_path.rstrip("/")
        self._fs, self._root = _fsspec().core.url_to_fs(self.prefix_path)

    # -- path layout -------------------------------------------------------

    def _join(self, *parts):
        return "/".join([self.prefix_path] + [p.strip("/") for p in parts])

    def get_train_data_path(self, idx=None):
        suffix = "" if idx is None else f".{idx}"
        return self._join(f"intermediate_train_data{suffix}")

    def get_val_data_path(self, idx=None):
        suffix = "" if idx is None else f".{idx}"
        return self._join(f"intermediate_val_data{suffix}")

    def get_runs_path(self):
        return self._join("runs")

    def get_run_path(self, run_id):
        return self._join("runs", run_id)

    def get_checkpoint_path(self, run_id):
        return self._join("runs", run_id, self.get_checkpoint_filename())

    def get_logs_path(self, run_id):
        return self._join("runs", run_id, "logs")

    def get_checkpoint_filename(self):
        return "checkpoint.keras"

    # -- filesystem ops ----------------------------------------------------

    def _strip(self, url):
        """fsspec filesystems address paths without the protocol scheme."""
        return _fsspec().core.url_to_fs(url)[1]

    def exists(self, path):
        return self._fs.exists(self._strip(path))

    def makedirs(self, path):
        self._fs.makedirs(self._strip(path), exist_ok=True)

    def read(self, path):
        with self._fs.open(self._strip(path), "rb") as f:
            return f.read()

    def write(self, path, data):
        p = self._strip(path)
        parent = p.rsplit("/", 1)[0]
        if parent:
            self._fs.makedirs(parent, exist_ok=True)
        with self._fs.open(p, "wb") as f:
            f.write(data)

    def write_text(self, path, text):
        self.write(path, text.encode("utf-8"))

    def read_text(self, path):
        return self.read(path).decode("utf-8")

    def is_parquet_dataset(self, path):
        p = self._strip(path)
        if not self._fs.exists(p):
            return False
        try:
            return any(f.endswith(".parquet")
                       for f in self._fs.ls(p, detail=False))
        except OSError:
            return False

    def list_parquet_files(self, path):
        """Sorted parquet part files of a dataset directory: the shard unit
        for rank assignment."""
        p = self._strip(path)
        return sorted(f for f in self._fs.ls(p, detail=False)
                      if f.endswith(".parquet"))

    def open(self, path, mode="rb"):
        return self._fs.open(self._strip(path), mode)

    @property
    def fs(self):
        return self._fs

    # -- factory -----------------------------------------------------------

    @staticmethod
    def create(prefix_path, **kwargs):
        """Store for any fsspec-resolvable path: plain paths and ``file://``
        map to local disk; ``hdfs://``, ``s3://``, ``gs://``, ``dbfs:/`` work
        when the matching fsspec backend is installed (reference:
        store.py:157 ``Store.create``)."""
        if prefix_path.startswith("dbfs:/"):
            prefix_path = "file:///dbfs/" + prefix_path[len("dbfs:/"):]
        return Store(prefix_path, **kwargs)


class LocalStore(Store):
    """Local-disk store (reference: LocalFSStore); a plain ``Store`` over a
    local path behaves the same."""

    def __init__(self, prefix_path):
        super().__init__(os.path.abspath(prefix_path))

"""The Spark integration on the port (``horovod_tpu_torch/spark/``) against
the JAX package's (``horovod_tpu/spark/``): the cases of
tests/test_spark_estimator.py and the pyspark gate of
tests/test_cluster.py, the Spark-free parts run through both packages on
the same inputs.

The np = 2 executor bodies (torch, the Lightning protocol, keras) run as
two-rank jobs of tests/torch_port_spark_worker.py, the port's (its
delegated plane over gloo) beside the JAX package's (its TCP plane), on the
same parquet shards and starting weights. Their per-epoch histories agree
to 1e-4 relative for torch and Lightning (fp32 on the CPU; the planes sum
two ranks' gradients in other orders) and to 2e-3 for keras (the port's
keras runs the torch backend, the JAX package's tensorflow, with bf16
compression on the wire).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu.spark as jspark
import horovod_tpu_torch.spark as tspark
import torch_port_launch
from torch_port_spark_worker import write_parquet_dataset
from horovod_tpu.spark import data as jdata
from horovod_tpu.spark import store as jstore
from horovod_tpu_torch.spark import data as tdata
from horovod_tpu_torch.spark import store as tstore

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_spark_worker.py")
PACKAGES = ("horovod_tpu_torch", "horovod_tpu")
JOB_TIMEOUT = 300


@pytest.mark.parametrize("spark", [jspark, tspark], ids=["jax", "port"])
def test_elastic_loop_relaunches_at_current_capacity(spark):
    """Between-stage elasticity (reference: horovod/spark/runner.py:309):
    a failed stage relaunches at the cluster's current parallelism bounded
    to [min_np, max_np]; the same calls in both packages."""
    calls = []
    capacity = iter([8, 5, 4])

    def run_stage(n):
        calls.append(n)
        if len(calls) < 3:
            raise RuntimeError("executor lost")
        return [f"ok@{n}"]

    out = spark._elastic_loop(run_stage, lambda: next(capacity),
                              max_np=6, min_np=3, stage_retries=3)
    assert calls == [6, 5, 4]
    assert out == ["ok@4"]


def test_elastic_loop_aborts_below_min_np_and_caps_retries():
    def boom(n):
        raise RuntimeError("persistent failure")

    capacity = iter([4, 2])
    with pytest.raises(RuntimeError, match="min_np"):
        tspark._elastic_loop(boom, lambda: next(capacity), min_np=3,
                             stage_retries=5)
    with pytest.raises(RuntimeError, match="persistent"):
        tspark._elastic_loop(boom, lambda: 4, stage_retries=2)


def test_run_and_run_elastic_gate_without_pyspark():
    try:
        import pyspark  # noqa: F401
        pytest.skip("pyspark installed; gate not applicable")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="pyspark"):
        tspark.run(lambda: None, num_proc=1)
    with pytest.raises(ImportError, match="pyspark"):
        tspark.run_elastic(lambda: None, num_proc=2)


def test_store_layout_equals_the_jax_packages(tmp_path):
    stores = [m.Store.create(str(tmp_path)) for m in (jstore, tstore)]
    for fn in ("get_train_data_path", "get_val_data_path"):
        assert getattr(stores[1], fn)() == getattr(stores[0], fn)()
        assert getattr(stores[1], fn)(2) == getattr(stores[0], fn)(2)
    for fn in ("get_run_path", "get_checkpoint_path", "get_logs_path"):
        assert getattr(stores[1], fn)("r1") == getattr(stores[0], fn)("r1")
    assert stores[1].get_checkpoint_path("r1").endswith(
        "runs/r1/checkpoint.keras")


def test_store_read_write_roundtrip(tmp_path):
    store = tstore.Store.create(str(tmp_path))
    p = store.get_checkpoint_path("abc")
    assert not store.exists(p)
    store.write(p, b"\x00weights\x01")
    assert store.exists(p)
    assert store.read(p) == b"\x00weights\x01"
    # the JAX package's store reads what the port's wrote
    assert jstore.Store.create(str(tmp_path)).read(p) == b"\x00weights\x01"
    store.write_text(store.get_logs_path("abc") + "/note.txt", "hi")
    assert store.read_text(store.get_logs_path("abc") + "/note.txt") == "hi"


def test_store_file_url_and_dbfs_rewrite(tmp_path):
    s = tstore.Store.create(f"file://{tmp_path}")
    s.write_text(s.get_run_path("x") + "/a.txt", "ok")
    assert (tmp_path / "runs" / "x" / "a.txt").read_text() == "ok"
    d = tstore.Store.create("dbfs:/foo/bar")
    assert d.prefix_path == "file:///dbfs/foo/bar" == \
        jstore.Store.create("dbfs:/foo/bar").prefix_path


def test_shard_files_disjoint_cover_equal_the_jax_packages():
    files = [f"f{i}.parquet" for i in range(7)]
    shards = [tdata.shard_files(files, r, 3) for r in range(3)]
    assert shards == [jdata.shard_files(files, r, 3) for r in range(3)]
    assert sorted(f for s in shards for f in s) == sorted(files)
    with pytest.raises(ValueError):
        tdata.shard_files(files[:2], 0, 3)


def test_parquet_shard_batches_equal_the_jax_packages(tmp_path):
    pytest.importorskip("pyarrow")
    store = tstore.LocalStore(str(tmp_path))
    data_path = store.get_train_data_path()
    write_parquet_dataset(data_path, n_files=3, rows_per_file=10)
    files = store.list_parquet_files(data_path)
    assert len(files) == 3
    shard = tdata.ParquetShard(store, files[:2], ["features", "label"])
    ref = jdata.ParquetShard(jstore.LocalStore(str(tmp_path)), files[:2],
                             ["features", "label"])
    assert shard.num_rows == ref.num_rows == 20
    gen, jgen = shard.batches(8, seed=1), ref.batches(8, seed=1)
    for _ in range(4):
        b, jb = next(gen), next(jgen)
        np.testing.assert_array_equal(b["label"], jb["label"])
        feats = tdata.stack_column(b["features"])
        assert feats.shape == (8, 4)
        np.testing.assert_array_equal(feats,
                                      jdata.stack_column(jb["features"]))


def test_parquet_shard_smaller_than_a_batch_cycles_whole(tmp_path):
    pytest.importorskip("pyarrow")
    store = tstore.LocalStore(str(tmp_path))
    data_path = store.get_train_data_path()
    write_parquet_dataset(data_path, n_files=1, rows_per_file=5)
    shard = tdata.ParquetShard(store, store.list_parquet_files(data_path),
                               ["label"])
    gen = shard.batches(16, seed=0)
    b1, b2 = next(gen), next(gen)
    assert len(b1["label"]) == 5 and len(b2["label"]) == 5


def test_zero_row_shard_fails_loudly(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    store = tstore.LocalStore(str(tmp_path))
    path = store.get_train_data_path()
    os.makedirs(path, exist_ok=True)
    pq.write_table(pa.table({"label": pa.array([], type=pa.float64())}),
                   os.path.join(path, "part-0.parquet"))
    shard = tdata.ParquetShard(store, store.list_parquet_files(path),
                               ["label"])
    with pytest.raises(ValueError, match="0 training rows"):
        next(shard.batches(8))


def test_output_width_mismatch_raises():
    from horovod_tpu_torch.spark._transform import check_output_width
    check_output_width(np.zeros((4, 1)), ["a"])
    check_output_width(np.zeros((4, 3)), ["a", "b", "c"])
    with pytest.raises(ValueError, match="output components"):
        check_output_width(np.zeros((4, 10)), ["a"])


def test_multi_param_group_optimizer_rejected():
    from horovod_tpu_torch.spark.torch import _optimizer_spec
    m = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD([
        {"params": [m.weight], "lr": 0.1},
        {"params": [m.bias], "lr": 0.01},
    ])
    with pytest.raises(ValueError, match="param-group"):
        _optimizer_spec(opt)
    cls, defaults = _optimizer_spec(torch.optim.SGD(m.parameters(), lr=0.1))
    assert cls is torch.optim.SGD and defaults["lr"] == 0.1


def test_lightning_resolve_optimizer_shapes():
    from horovod_tpu_torch.spark.lightning import _resolve_optimizers

    class M(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.lin = torch.nn.Linear(2, 2)
            self._cfg = cfg

        def configure_optimizers(self):
            return self._cfg(self)

    opt = lambda m: torch.optim.SGD(m.parameters(), lr=0.1)  # noqa: E731
    o, s = _resolve_optimizers(M(opt))
    assert isinstance(o, torch.optim.SGD) and s == []
    o, s = _resolve_optimizers(M(lambda m: [opt(m)]))
    assert isinstance(o, torch.optim.SGD)
    o, s = _resolve_optimizers(M(
        lambda m: ([opt(m)], [torch.optim.lr_scheduler.StepLR(opt(m), 1)])))
    assert len(s) == 1
    o, s = _resolve_optimizers(M(lambda m: {"optimizer": opt(m)}))
    assert isinstance(o, torch.optim.SGD)
    with pytest.raises(ValueError, match="exactly one optimizer"):
        _resolve_optimizers(M(lambda m: [opt(m), opt(m)]))


def test_lightning_estimator_rejects_non_protocol_model(tmp_path):
    from horovod_tpu_torch.spark.lightning import LightningEstimator
    with pytest.raises(ValueError, match="LightningModule protocol"):
        LightningEstimator(model=torch.nn.Linear(2, 2), store=str(tmp_path),
                           feature_cols=["f"], label_cols=["l"])


def test_async_shard_batch_loader_matches_sync_and_the_jax_packages(
        tmp_path):
    """AsyncShardBatchLoader yields the same transformed batches as direct
    iteration (same seed) and as the JAX package's loader, per epoch;
    exceptions in the transform surface on the consumer."""
    pytest.importorskip("pyarrow")
    store = tstore.LocalStore(str(tmp_path))
    write_parquet_dataset(store.get_train_data_path(), n_files=2,
                           rows_per_file=32)
    files = store.list_parquet_files(store.get_train_data_path())

    def mk(mod, cls, **kw):
        return getattr(mod, cls)(
            shard=mod.ParquetShard(store, files, ["features", "label"]),
            batch_size=16, steps=3, transform=lambda b: b["label"].sum(),
            seed=7, **kw)

    sync = list(mk(tdata, "ShardBatchLoader"))
    a = mk(tdata, "AsyncShardBatchLoader")
    async_1, async_2 = list(a), list(a)
    j = mk(jdata, "AsyncShardBatchLoader")
    jax_1, jax_2 = list(j), list(j)
    assert len(sync) == len(async_1) == len(async_2) == 3
    np.testing.assert_array_equal(async_1, sync)
    np.testing.assert_array_equal(async_1, jax_1)
    np.testing.assert_array_equal(async_2, jax_2)
    assert not np.allclose(async_2, async_1)
    a.close()
    j.close()

    def boom(b):
        raise RuntimeError("transform failed")

    bad = tdata.AsyncShardBatchLoader(
        shard=tdata.ParquetShard(store, files, ["label"]), batch_size=16,
        steps=2, transform=boom)
    with pytest.raises(RuntimeError, match="transform failed"):
        list(bad)
    bad.close()


# -- the np = 2 executor bodies, both packages --------------------------------

def _env(pkg, store):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_",
                                "KERAS_BACKEND"))}
    env.pop("XLA_FLAGS", None)
    env.update(JAX_PLATFORMS="cpu", SPARK_PKG=pkg, STORE_PREFIX=str(store),
               OMP_NUM_THREADS="2")
    if pkg == "horovod_tpu_torch":
        env["HVDTPU_CPU_OPERATIONS"] = "nccl"
    return env


def run_pair(mode, root):
    """Both packages' two-rank jobs of ``mode`` on one dataset, each with
    its own store; {package: (exit codes, logs, per-rank results, store)}."""
    torch_port_launch.build_jax_native_library()
    torch_port_launch.build_port_core()
    data = root / "data"
    write_parquet_dataset(str(data), n_files=4, rows_per_file=64)
    started = {}
    for pkg in PACKAGES:
        out = root / pkg
        store = out / "store"
        shutil.copytree(data, tstore.Store.create(str(store))
                        .get_train_data_path())
        (out / "rdv").mkdir()
        port = torch_port_launch.free_port()
        procs = []
        for rank in range(2):
            log = open(out / f"log{rank}.txt", "w")
            procs.append((subprocess.Popen(
                [sys.executable, WORKER, mode, str(rank), "2",
                 str(out / "rdv"), str(port), str(out)],
                env=_env(pkg, store), stdout=log, stderr=subprocess.STDOUT),
                log))
        started[pkg] = (out, store, procs)
    jobs = {}
    for pkg, (out, store, procs) in started.items():
        codes = []
        for p, log in procs:
            try:
                codes.append(p.wait(timeout=JOB_TIMEOUT))
            except subprocess.TimeoutExpired:
                for q, _ in procs:
                    q.kill()
                codes.append(f"timeout after {JOB_TIMEOUT} s")
                p.wait(timeout=60)
            log.close()
        logs = [(out / f"log{r}.txt").read_text() for r in range(2)]
        res = [json.loads((out / f"r{r}.json").read_text())
               for r in range(2) if (out / f"r{r}.json").exists()]
        jobs[pkg] = (codes, logs, res, store)
    for pkg, (codes, logs, res, _) in jobs.items():
        assert codes == [0, 0], f"{pkg}: {codes}\n" + "\n".join(
            log[-3000:] for log in logs)
    return jobs


def _check_histories(jobs, key, rtol):
    port = [r[key] for r in jobs["horovod_tpu_torch"][2]]
    ref = [r[key] for r in jobs["horovod_tpu"][2]]
    for hist in port:
        assert hist["loss"][-1] < hist["loss"][0], hist
        assert "val_loss" in hist
        # the metric average: every rank reports the same history
        np.testing.assert_allclose(hist["loss"], port[0]["loss"], rtol=1e-6)
    for k in port[0]:
        np.testing.assert_allclose(port[0][k], ref[0][k], rtol=rtol)


def test_fit_on_parquet_torch_np2_equals_the_jax_packages(tmp_path):
    """The torch estimator body at np = 2: grad-hook DistributedOptimizer,
    broadcast init from rank-shifted weights, lockstep steps, averaged
    history, checkpoint; the aggregated bf16 run too."""
    jobs = run_pair("torch", tmp_path)
    _check_histories(jobs, "history", 1e-4)
    port, ref = (jobs[p][2][0]["history_agg"] for p in PACKAGES)
    assert port["loss"][-1] < port["loss"][0]
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-4)
    assert all(r["computed_on"] == ["cpu"] and r["backend_plane"] == "gloo"
               for r in jobs["horovod_tpu_torch"][2])
    store = tstore.Store.create(str(jobs["horovod_tpu_torch"][3]))
    tm = tspark.TorchEstimator.load(store, "torchrun",
                                    feature_cols=["features"],
                                    label_cols=["label"])
    assert store.exists(store.get_checkpoint_path("torchrun"))
    preds = tm.predict([np.zeros((3, 4))])
    assert preds.shape == (3, 1)


def test_fit_on_parquet_lightning_np2_equals_the_jax_packages(tmp_path):
    """The Lightning protocol body at np = 2: configure_optimizers on the
    worker, a scheduler stepped per epoch, validation_step's val_loss."""
    jobs = run_pair("lightning", tmp_path)
    _check_histories(jobs, "history", 1e-4)
    store = tstore.Store.create(str(jobs["horovod_tpu_torch"][3]))
    lm = tspark.LightningEstimator.load(store, "plrun",
                                        feature_cols=["features"],
                                        label_cols=["label"])
    import __main__
    import torch_port_spark_worker
    __main__.LinearLightning = torch_port_spark_worker.LinearLightning
    assert lm.predict([np.zeros((3, 4))]).shape == (3, 1)


def test_fit_on_parquet_keras_np2_equals_the_jax_packages(tmp_path):
    """The keras estimator body at np = 2, the port's under
    KERAS_BACKEND=torch; its restored transformer predicts."""
    jobs = run_pair("keras", tmp_path)
    assert {r["backend"] for r in jobs["horovod_tpu_torch"][2]} == {"torch"}
    _check_histories(jobs, "history", 2e-3)
    store = str(jobs["horovod_tpu_torch"][3])
    code = (f"import sys; sys.path.insert(0, {os.path.dirname(HERE)!r})\n"
            "import numpy as np\n"
            "from horovod_tpu_torch.spark.keras import KerasEstimator\n"
            f"km = KerasEstimator.load({store!r}, 'testrun', "
            "feature_cols=['features'], label_cols=['label'])\n"
            "print('PRED', km.predict([np.zeros((3, 4))]).shape)\n")
    env = {k: v for k, v in os.environ.items() if k != "KERAS_BACKEND"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(env, KERAS_BACKEND="torch"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PRED (3, 1)" in out.stdout

"""Spark integration on the port's runtime (port of
``horovod_tpu/spark/__init__.py``): run a training function inside Spark
executors as one job (reference: horovod/spark/runner.py:197
``horovod.spark.run``), plus the ML estimator layer (``Store``, the Keras,
Torch and Lightning estimators, reference:
horovod/spark/keras/estimator.py:88 and common/store.py).

Spark provides placement and the barrier stage; rendezvous and topology are
the port's cluster core (``runner/cluster.py``). The estimators' training
loops (``fit_on_parquet*``) are Spark-free: they read parquet shards and
train on each rank's device, under Spark barrier tasks, the port's launcher
or a test harness alike. Only DataFrame materialization, ``transform`` and
``run``/``run_elastic`` need pyspark, and they raise ``ImportError`` at the
use when it is missing; pyspark (and pyarrow, fsspec, keras) are imported
there, never at import.

    import horovod_tpu_torch.spark as hvd_spark
    results = hvd_spark.run(train_fn, args=(lr,), num_proc=4)
"""

from ..runner.cluster import ClusterJob, cluster_task_bootstrap


def _pyspark():
    try:
        import pyspark
        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark, which is not "
            "installed in this environment. `pip install pyspark` on a Spark "
            "cluster to use this integration.") from e


def run(fn, args=(), kwargs=None, num_proc=None, start_timeout=120,
        extra_env=None, verbose=True):
    """Run ``fn(*args, **kwargs)`` on ``num_proc`` Spark executors as one
    job; returns per-rank results ordered by rank (reference:
    horovod/spark/runner.py:197 ``run``)."""
    _pyspark()
    from pyspark import BarrierTaskContext, SparkContext

    kwargs = kwargs or {}
    sc = SparkContext.getOrCreate()
    if num_proc is None:
        num_proc = sc.defaultParallelism
    if verbose:
        from ..utils.logging_util import get_logger
        get_logger().info("spark: launching %d-task barrier job", num_proc)
    job = ClusterJob(num_proc, start_timeout=start_timeout)
    task_args = job.task_args()
    env = dict(extra_env or {})

    def _task(_):
        import os
        os.environ.update(env)
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        n, addr, port, token, timeout = task_args
        cluster_task_bootstrap(rank, n, addr, port, token, timeout)
        result = fn(*args, **kwargs)
        return [(rank, result)]

    try:
        pairs = (sc.parallelize(range(num_proc), num_proc)
                 .barrier()
                 .mapPartitions(_task)
                 .collect())
    finally:
        job.shutdown()
    return [r for _, r in sorted(pairs)]


def _elastic_loop(run_stage, parallelism, num_proc=None, min_np=None,
                  max_np=None, stage_retries=3, log=None):
    """Between-stage elasticity engine (pyspark-free): ``run_stage(n)``
    launches one barrier stage at n workers; ``parallelism()`` reports the
    cluster's current capacity. A failed stage is relaunched at the new
    capacity, bounded to [min_np, max_np]; capacity below min_np aborts
    (reference: horovod/spark/runner.py:309 run_elastic)."""
    attempts = 0
    while True:
        avail = parallelism()
        n = min(x for x in (num_proc, max_np, avail) if x is not None)
        if min_np is not None and n < min_np:
            raise RuntimeError(
                f"cluster parallelism {avail} fell below min_np="
                f"{min_np}; aborting elastic job")
        try:
            return run_stage(n)
        except Exception as e:  # noqa: BLE001 — stage failure is the signal
            attempts += 1
            if attempts > stage_retries:
                raise
            if log is not None:
                log.warning(
                    "spark elastic: stage failed (%s); relaunching "
                    "(attempt %d/%d)", e, attempts, stage_retries)


def run_elastic(fn, args=(), kwargs=None, num_proc=None, min_np=None,
                max_np=None, start_timeout=120, extra_env=None,
                stage_retries=3, verbose=True):
    """Elastic analog of :func:`run` (reference: horovod/spark/runner.py:309
    ``run_elastic``): in-stage failures restore through
    ``horovod_tpu_torch.elastic.run`` inside ``fn``; a failed stage is
    relaunched at the cluster's current parallelism, bounded to [min_np,
    max_np]."""
    _pyspark()
    from pyspark import SparkContext

    log = None
    if verbose:
        from ..utils.logging_util import get_logger
        log = get_logger()

    def parallelism():
        return SparkContext.getOrCreate().defaultParallelism

    def run_stage(n):
        return run(fn, args=args, kwargs=kwargs, num_proc=n,
                   start_timeout=start_timeout, extra_env=extra_env,
                   verbose=verbose)

    return _elastic_loop(run_stage, parallelism, num_proc=num_proc,
                         min_np=min_np, max_np=max_np,
                         stage_retries=stage_retries, log=log)


__all__ = ["run", "run_elastic", "ClusterJob", "cluster_task_bootstrap",
           "Store", "LocalStore", "KerasEstimator", "KerasModel",
           "fit_on_parquet", "TorchEstimator", "TorchModel",
           "fit_on_parquet_torch", "LightningEstimator", "LightningModel",
           "fit_on_parquet_lightning"]

_LAZY = {"Store": "store", "LocalStore": "store",
         "KerasEstimator": "keras", "KerasModel": "keras",
         "fit_on_parquet": "keras", "TorchEstimator": "torch",
         "TorchModel": "torch", "fit_on_parquet_torch": "torch",
         "LightningEstimator": "lightning", "LightningModel": "lightning",
         "fit_on_parquet_lightning": "lightning"}


def __getattr__(name):
    # The estimators and the store load on use: the plain run() path needs
    # none of their dependencies.
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)

"""Ray integration on the port: actor-based jobs (port of
``horovod_tpu/ray/__init__.py``; reference: horovod/ray/runner.py:168
``RayExecutor``).

Thin by design: Ray provides placement (actors); rendezvous and topology
ride the port's cluster core (``runner/cluster.py``). ray is imported at
the use; without it ``start()`` raises ``ImportError``.

    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=4)
    ex.start()
    results = ex.run(train_fn, args=(lr,))
    ex.shutdown()
"""

from ..runner.cluster import ClusterJob, cluster_task_bootstrap


def _ray():
    try:
        import ray
        return ray
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.ray requires ray, which is not installed in "
            "this environment. `pip install ray` on a Ray cluster to use "
            "this integration.") from e


class RayExecutor:
    """Reference API shape: start() places workers, run() executes the
    training function on all of them, shutdown() tears down."""

    def __init__(self, num_workers=1, cpus_per_worker=1,
                 resources_per_worker=None, start_timeout=120,
                 extra_env=None):
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self.resources_per_worker = resources_per_worker or {}
        self.start_timeout = start_timeout
        self.extra_env = dict(extra_env or {})
        self._workers = None
        self._job = None

    def start(self):
        ray = _ray()

        @ray.remote
        class _Worker:
            def bootstrap(self, rank, task_args, extra_env):
                import os

                from horovod_tpu_torch.utils import envparse
                os.environ.update(extra_env)
                n, addr, port, token, timeout = task_args
                cluster_task_bootstrap(rank, n, addr, port, token, timeout)
                return envparse.get_str(envparse.RANK)

            def execute(self, fn, args, kwargs):
                return fn(*args, **kwargs)

        self._job = ClusterJob(self.num_workers,
                               start_timeout=self.start_timeout)
        worker_cls = _Worker.options(num_cpus=self.cpus_per_worker,
                                     resources=self.resources_per_worker)
        self._workers = [worker_cls.remote()
                         for _ in range(self.num_workers)]
        ray.get([w.bootstrap.remote(i, self._job.task_args(),
                                    self.extra_env)
                 for i, w in enumerate(self._workers)])

    def run(self, fn, args=(), kwargs=None):
        """Execute fn on every worker; per-rank results ordered by rank."""
        ray = _ray()
        if self._workers is None:
            raise RuntimeError("call start() before run()")
        return ray.get([w.execute.remote(fn, args, kwargs or {})
                        for w in self._workers])

    def execute_single(self, fn, args=(), kwargs=None, rank=0):
        ray = _ray()
        if self._workers is None:
            raise RuntimeError("call start() before run()")
        return ray.get(self._workers[rank].execute.remote(
            fn, args, kwargs or {}))

    def shutdown(self):
        ray = _ray()
        if self._workers:
            for w in self._workers:
                ray.kill(w)
            self._workers = None
        if self._job is not None:
            self._job.shutdown()
            self._job = None


def __getattr__(name):
    # Lazy: the elastic executor and strategies import ray only on use.
    if name in ("ElasticRayExecutor", "RayHostDiscovery"):
        from . import elastic
        return getattr(elastic, name)
    if name in ("PlacementStrategy", "ColocatedStrategy", "SpreadStrategy",
                "strategy_for"):
        from . import strategy
        return getattr(strategy, name)
    raise AttributeError(name)


__all__ = ["RayExecutor", "ElasticRayExecutor", "RayHostDiscovery",
           "ClusterJob", "cluster_task_bootstrap", "ColocatedStrategy",
           "SpreadStrategy", "strategy_for"]

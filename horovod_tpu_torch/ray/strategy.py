"""Placement strategies for Ray workers (port of
``horovod_tpu/ray/strategy.py``; reference: horovod/ray/strategy.py:139
``ColocatedStrategy``/``PGStrategy``).

A strategy turns (num_workers, per-worker resources) into a Ray
placement-group request: the bundle list plus the Ray scheduling strategy
string. Bundle math is pure Python (tested without ray); only
``create_placement_group`` touches the ray API, through the adapter's
lazy import.

GPU note: colocation bundles ("pack") put one bundle per host with all
that host's workers (and their ``GPU`` resources) inside, the layout that
keeps NCCL's intra-host NVLink traffic off the data-center network.
"""


class PlacementStrategy:
    """Base: subclasses define the bundle layout."""

    def __init__(self, num_workers, cpus_per_worker=1, gpus_per_worker=0,
                 resources_per_worker=None):
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self.gpus_per_worker = gpus_per_worker
        self.resources_per_worker = dict(resources_per_worker or {})

    def _worker_resources(self):
        res = {"CPU": self.cpus_per_worker}
        if self.gpus_per_worker:
            res["GPU"] = self.gpus_per_worker
        res.update(self.resources_per_worker)
        return res

    def bundles(self):
        raise NotImplementedError

    def ray_strategy(self):
        raise NotImplementedError

    def bundle_index_for_worker(self, worker_index):
        """Which bundle a given worker rank is scheduled into."""
        raise NotImplementedError

    def create_placement_group(self, timeout=100):
        """Reserve the group; returns the ray PlacementGroup handle."""
        import ray
        pg = ray.util.placement_group(self.bundles(),
                                      strategy=self.ray_strategy())
        ray.get(pg.ready(), timeout=timeout)
        return pg


class ColocatedStrategy(PlacementStrategy):
    """One bundle per host holding that host's workers' combined
    resources; STRICT_PACK keeps each bundle on one node (reference:
    strategy.py ColocatedStrategy — equal-distribution layout).

    ``workers_by_host`` allows uneven layouts (e.g. 7 workers on 2
    hosts as 4+3); by default workers spread evenly."""

    def __init__(self, num_hosts, workers_per_host=None, cpus_per_worker=1,
                 gpus_per_worker=0, resources_per_worker=None,
                 workers_by_host=None):
        if workers_by_host is None:
            workers_by_host = [workers_per_host] * num_hosts
        super().__init__(sum(workers_by_host), cpus_per_worker,
                         gpus_per_worker, resources_per_worker)
        self.num_hosts = num_hosts
        self.workers_per_host = workers_per_host
        self.workers_by_host = list(workers_by_host)

    def bundles(self):
        per = self._worker_resources()
        return [{k: v * count for k, v in per.items()}
                for count in self.workers_by_host]

    def ray_strategy(self):
        return "STRICT_PACK" if self.num_hosts == 1 else "PACK"

    def bundle_index_for_worker(self, worker_index):
        for i, count in enumerate(self.workers_by_host):
            if worker_index < count:
                return i
            worker_index -= count
        raise IndexError("worker_index beyond num_workers")


class SpreadStrategy(PlacementStrategy):
    """One bundle per worker, SPREAD across the cluster — maximizes
    host-failure independence at the cost of cross-host traffic
    (reference: strategy.py PGStrategy/pack=False)."""

    def bundles(self):
        return [self._worker_resources()
                for _ in range(self.num_workers)]

    def ray_strategy(self):
        return "SPREAD"

    def bundle_index_for_worker(self, worker_index):
        return worker_index


def strategy_for(pack, num_workers, num_hosts=None, cpus_per_worker=1,
                 gpus_per_worker=0, resources_per_worker=None):
    """Reference-flag adapter: ``use_current_placement_group``/``pack``
    style booleans to a strategy object. Pack layouts split uneven
    worker counts as evenly as possible (ceil on the first remainder
    hosts) — elastic jobs have dynamic host counts, so divisibility
    must not be a startup requirement."""
    if pack:
        hosts = min(num_hosts or 1, num_workers)
        base, rem = divmod(num_workers, hosts)
        by_host = [base + (1 if i < rem else 0) for i in range(hosts)]
        return ColocatedStrategy(hosts, cpus_per_worker=cpus_per_worker,
                                 gpus_per_worker=gpus_per_worker,
                                 resources_per_worker=resources_per_worker,
                                 workers_by_host=by_host)
    return SpreadStrategy(num_workers, cpus_per_worker, gpus_per_worker,
                          resources_per_worker)


__all__ = ["PlacementStrategy", "ColocatedStrategy", "SpreadStrategy",
           "strategy_for"]

"""Elastic Ray executor on the port: actor-based fault-tolerant jobs (port
of ``horovod_tpu/ray/elastic.py``; reference: horovod/ray/elastic.py:149
``ElasticRayExecutor`` and elastic_v2.py).

Design: the port's elastic driver (``runner/elastic_driver.py``) owns the
hard parts (versioned re-rendezvous, stable rank order, blacklist, quorum,
straggler reaping). This module subclasses it and swaps the two Ray-shaped
pieces in:

- **membership** comes from the Ray cluster (``RayHostDiscovery`` polls
  ``ray.nodes()`` instead of running a discovery script), and
- **workers** are Ray actors (``_ActorProcess`` adapts an actor + its
  running ObjectRef to the SlotProcess poll/wait/terminate/kill surface
  the driver manages).

A worker actor sets the elastic HVDTPU_* env (same contract as a spawned
process: worker id, rendezvous addr/port/token) and calls the user
function; inside it, ``horovod_tpu_torch.elastic.run``-wrapped state works
unchanged. Per-worker results of the succeeding cohort come back from
``run()`` ordered by final rank.
"""

import time
from types import SimpleNamespace

from . import _ray
from .strategy import strategy_for
from ..runner.elastic_driver import ElasticDriver, ElasticSettings
from ..runner.hosts import HostInfo
from ..utils.logging_util import get_logger


class RayHostDiscovery:
    """Cluster membership from ray.nodes() (reference: elastic.py:44
    RayHostDiscovery): alive nodes with enough resources become
    ``host:slots`` entries; a dead/preempted node simply drops out, which
    is the signal the elastic driver reacts to."""

    def __init__(self, cpus_per_worker=1, gpus_per_worker=0,
                 use_gpu=False, max_np=None):
        self.cpus_per_worker = cpus_per_worker
        self.gpus_per_worker = gpus_per_worker or (1 if use_gpu else 0)
        self.max_np = max_np

    def find_available_hosts(self):
        # No max_np capping HERE: the elastic driver caps at max_np
        # AFTER blacklist filtering (_discover_targets) — a discovery-
        # side budget would let a blacklisted host starve healthy
        # replacements of slots. ``max_np`` is kept only as metadata.
        ray = _ray()
        hosts = []
        for node in ray.nodes():
            if not node.get("Alive"):
                continue
            res = node.get("Resources", {})
            slots = int(res.get("CPU", 0) // self.cpus_per_worker)
            if self.gpus_per_worker:
                slots = min(slots, int(res.get("GPU", 0)
                                       // self.gpus_per_worker))
            if slots <= 0:
                continue
            hosts.append(HostInfo(node["NodeManagerAddress"], slots))
        return hosts


def _make_worker_cls(ray):
    @ray.remote
    class ElasticWorker:
        """One rank: applies the elastic env contract, runs the user fn."""

        def run(self, fn, env, args, kwargs):
            import os
            os.environ.update(env)
            return fn(*(args or ()), **(kwargs or {}))

    return ElasticWorker


class _ActorProcess:
    """Adapt (actor, in-flight ObjectRef) to the SlotProcess surface
    ElasticDriver drives: poll() -> rc|None, wait(), terminate(), kill().
    Success/failure maps to rc 0/1; the result value is kept for
    ElasticRayExecutor.run()."""

    def __init__(self, actor, ref):
        self.actor = actor
        self.ref = ref
        self._rc = None
        self.result = None
        self.error = None

    def poll(self):
        if self._rc is not None:
            return self._rc
        ray = _ray()
        done, _ = ray.wait([self.ref], timeout=0)
        if not done:
            return None
        try:
            self.result = ray.get(self.ref)
            self._rc = 0
        except Exception as e:  # noqa: BLE001 — actor death/user error
            self.error = e
            self._rc = 1
        return self._rc

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("actor still running")
            time.sleep(0.05)
        return self._rc

    def terminate(self):
        self.kill()

    def kill(self):
        if self._rc is None:
            try:
                _ray().kill(self.actor)
            except Exception:  # noqa: BLE001 — already dead
                pass


class _RayElasticDriver(ElasticDriver):
    """ElasticDriver whose workers are Ray actors."""

    def __init__(self, elastic, fn, fn_args, fn_kwargs, discovery,
                 worker_env, placement=None):
        super().__init__(elastic, command=None, discovery=discovery)
        self._fn = fn
        self._fn_args = fn_args
        self._fn_kwargs = fn_kwargs
        self._worker_env = worker_env
        self._placement = placement
        self._worker_cls = None
        self.results = {}          # worker_id -> return value
        self.final_rank = {}       # worker_id -> rank at completion

    def _spawn(self, worker_id, host, slot_index):
        ray = _ray()
        if self._worker_cls is None:
            self._worker_cls = _make_worker_cls(ray)
        env = dict(self._worker_env)
        env.update({
            "HVDTPU_ELASTIC": "1",
            "HVDTPU_WORKER_ID": worker_id,
            "HVDTPU_RENDEZVOUS_ADDR": self.addr,
            "HVDTPU_RENDEZVOUS_PORT": str(self.port),
            "HVDTPU_JOB_TOKEN": self.token,
            "HVDTPU_START_TIMEOUT": str(self.elastic.base.start_timeout),
        })
        opts = {"num_cpus": self.elastic.base.cpus_per_worker}
        if getattr(self.elastic.base, "gpus_per_worker", 0):
            opts["num_gpus"] = self.elastic.base.gpus_per_worker
        if self._placement is not None:
            opts["placement_group"] = self._placement
        # Soft host affinity: prefer the discovered node so slot math
        # (local/cross ranks) reflects physical placement.
        try:
            opts["resources"] = {f"node:{host}": 0.001}
        except Exception:  # noqa: BLE001
            pass
        actor = self._worker_cls.options(**opts).remote()
        ref = actor.run.remote(self._fn, env, self._fn_args,
                               self._fn_kwargs)
        proc = _ActorProcess(actor, ref)
        from ..runner.elastic_driver import _Worker
        self.workers[worker_id] = _Worker(worker_id, host, slot_index,
                                          proc)

    def _sweep_exits(self):
        # Capture results AND final ranks of workers finishing this sweep
        # (the base class pops successes from both self.workers and
        # self.rank_order, so snapshot the order first).
        before = {wid: w.proc for wid, w in self.workers.items()}
        order_before = list(self.rank_order)
        changed = super()._sweep_exits()
        for wid in self.succeeded:
            proc = before.get(wid)
            if proc is not None and wid not in self.results:
                self.results[wid] = proc.result
                if wid in order_before:
                    self.final_rank[wid] = order_before.index(wid)
        return changed


class ElasticRayExecutor:
    """Reference API shape (horovod/ray/elastic.py:149): construct with
    elastic bounds, ``start()``, ``run(fn)`` retries/rescales through
    membership changes, results come from the cohort that finished.

        ex = ElasticRayExecutor(min_np=2, max_np=8, cpus_per_worker=1)
        ex.start()
        results = ex.run(train_fn)
        ex.shutdown()
    """

    def __init__(self, min_np=1, max_np=None, cpus_per_worker=1,
                 gpus_per_worker=0, use_gpu=False, env_vars=None,
                 override_discovery=None, reset_limit=None,
                 host_fail_limit=3, discovery_interval=1.0,
                 start_timeout=120, pack=False, use_placement_group=False,
                 verbose=False):
        base = SimpleNamespace(
            env={}, verbose=verbose, start_timeout=start_timeout,
            prefix_output=False, output_filename=None,
            rendezvous_addr=None, cpus_per_worker=cpus_per_worker,
            gpus_per_worker=gpus_per_worker or (1 if use_gpu else 0),
            resolve_hosts=lambda: [])
        self.elastic = ElasticSettings(
            base, discovery_script=None, min_np=min_np, max_np=max_np,
            reset_limit=reset_limit, host_fail_limit=host_fail_limit,
            discovery_interval=discovery_interval)
        self.discovery = override_discovery or RayHostDiscovery(
            cpus_per_worker=cpus_per_worker,
            gpus_per_worker=base.gpus_per_worker, max_np=max_np)
        self.env_vars = dict(env_vars or {})
        self.pack = pack
        self.use_placement_group = use_placement_group
        self._pg = None
        self._started = False
        self.log = get_logger()

    def start(self):
        """Validate the cluster is reachable and (optionally) reserve a
        placement group sized for max_np."""
        ray = _ray()
        if not ray.is_initialized():
            raise RuntimeError(
                "ray.init() must be called before ElasticRayExecutor."
                "start()")
        if self.use_placement_group:
            n = self.elastic.max_np or self.elastic.min_np
            hosts = len(self.discovery.find_available_hosts()) or 1
            # Uneven pack splits are handled by strategy_for (elastic
            # host counts are dynamic; divisibility is not required).
            strat = strategy_for(
                self.pack, n, num_hosts=hosts,
                cpus_per_worker=self.elastic.base.cpus_per_worker,
                gpus_per_worker=self.elastic.base.gpus_per_worker)
            self._pg = strat.create_placement_group(
                timeout=self.elastic.base.start_timeout)
        self._started = True

    def run(self, fn, args=None, kwargs=None):
        """Drive the elastic loop until a cohort finishes; returns the
        succeeded workers' results in final rank order."""
        if not self._started:
            raise RuntimeError("call start() before run()")
        driver = _RayElasticDriver(
            self.elastic, fn, args, kwargs, self.discovery,
            worker_env=self.env_vars, placement=self._pg)
        rc = driver.run()
        if rc != 0:
            raise RuntimeError(
                "elastic ray job failed (no worker cohort succeeded)")
        # Final rank order as recorded at each worker's completion (the
        # driver removes finished workers from its live rank_order, so
        # the order must come from the completion-time snapshot).
        ordered = sorted(driver.results,
                         key=lambda w: driver.final_rank.get(w, 1 << 30))
        return [driver.results[wid] for wid in ordered]

    def shutdown(self):
        if self._pg is not None:
            try:
                _ray().util.remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001
                pass
            self._pg = None
        self._started = False


__all__ = ["ElasticRayExecutor", "RayHostDiscovery"]

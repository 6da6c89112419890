"""The Ray integration on the port (``horovod_tpu_torch/ray/``) against the
JAX package's (``horovod_tpu/ray/``): the cases of tests/test_ray_elastic.py
and the ray gate of tests/test_cluster.py.

Ray is installed neither here nor on the GPU machines, so these tests
inject the in-process fake of the ray surface that tests/test_ray_elastic.py
uses (copied below: remote actors as threads, wait/get/kill, nodes()). The
elastic state machine under test is the port's own ``ElasticDriver`` with
actor-backed workers; only the Ray RPC layer is faked. Placement bundles
and discovered hosts equal the JAX package's on the same inputs.
"""

import os
import sys
import threading
import time
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Minimal fake ray
# ---------------------------------------------------------------------------

class _Future:
    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None

    def done(self):
        return self.event.is_set()


class _ActorHandle:
    def __init__(self, fake, cls, opts):
        self._fake = fake
        self._cls = cls
        self._opts = opts
        self._killed = False
        self._methods = {}
        for name in dir(cls):
            if not name.startswith("_") and callable(getattr(cls, name)):
                self._methods[name] = self._make_method(name)

    def __getattr__(self, name):
        try:
            return self._methods[name]
        except KeyError:
            raise AttributeError(name)

    def _make_method(self, name):
        handle = self

        class _Remote:
            def remote(self, *args, **kwargs):
                fut = _Future()
                inst = handle._cls()

                def run():
                    try:
                        fut.value = getattr(inst, name)(*args, **kwargs)
                    except BaseException as e:  # noqa: BLE001
                        fut.error = e
                    finally:
                        fut.event.set()

                t = threading.Thread(target=run, daemon=True)
                handle._fake._futures[id(fut)] = (fut, handle)
                t.start()
                return fut

        return _Remote()


class _RemoteClass:
    def __init__(self, fake, cls):
        self._fake = fake
        self._cls = cls

    def options(self, **opts):
        fake, cls = self._fake, self._cls

        class _Opted:
            @staticmethod
            def remote(*a, **k):
                return _ActorHandle(fake, cls, opts)

        return _Opted()

    def remote(self, *a, **k):
        return _ActorHandle(self._fake, self._cls, {})


class FakeRay(types.ModuleType):
    def __init__(self):
        super().__init__("ray")
        self._futures = {}
        self._nodes = []
        self.util = types.SimpleNamespace(
            placement_group=self._placement_group,
            remove_placement_group=lambda pg: None)

    # -- the surface the Ray integration uses ----------------------------
    def remote(self, cls=None, **kwargs):
        if cls is None:
            return lambda c: _RemoteClass(self, c)
        return _RemoteClass(self, cls)

    def wait(self, refs, timeout=None, num_returns=1):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            done = [r for r in refs if r.done()]
            if len(done) >= num_returns or (
                    deadline is not None
                    and time.monotonic() >= deadline):
                pending = [r for r in refs if r not in done]
                return done, pending
            time.sleep(0.01)

    def get(self, ref, timeout=None):
        if isinstance(ref, list):
            return [self.get(r, timeout) for r in ref]
        if not ref.event.wait(timeout):
            raise TimeoutError
        if ref.error is not None:
            raise ref.error
        return ref.value

    def kill(self, actor):
        actor._killed = True
        for fut, handle in self._futures.values():
            if handle is actor and not fut.done():
                fut.error = RuntimeError("ActorDiedError (fake)")
                fut.event.set()

    def nodes(self):
        return self._nodes

    def is_initialized(self):
        return True

    def _placement_group(self, bundles, strategy=None):
        pg = types.SimpleNamespace(bundles=bundles, strategy=strategy)
        fut = _Future()
        fut.value = None
        fut.event.set()
        pg.ready = lambda: fut
        return pg


@pytest.fixture(autouse=True)
def _env_guard():
    """Fake actors run as THREADS, so the worker's os.environ.update
    (correct behavior in a real ray actor process) lands in the pytest
    process; restore the environment afterwards or every launcher test
    that runs later inherits HVDTPU_ELASTIC + a dead rendezvous addr."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture()
def fake_ray(monkeypatch):
    fake = FakeRay()
    fake._nodes = [{"Alive": True, "NodeManagerAddress": "127.0.0.1",
                    "Resources": {"CPU": 2.0}}]
    monkeypatch.setitem(sys.modules, "ray", fake)
    return fake


@pytest.fixture(autouse=True)
def _env_guard():
    """Fake actors run as threads, so a worker's os.environ.update lands in
    the pytest process: restore the environment afterwards."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture()
def fake_ray(monkeypatch):
    fake = FakeRay()
    fake._nodes = [{"Alive": True, "NodeManagerAddress": "127.0.0.1",
                    "Resources": {"CPU": 2.0}}]
    monkeypatch.setitem(sys.modules, "ray", fake)
    return fake


def _strategies():
    from horovod_tpu.ray import strategy as jax_strategy
    from horovod_tpu_torch.ray import strategy as port_strategy
    return jax_strategy, port_strategy


def _layout(s, n):
    return (s.bundles(), s.ray_strategy(),
            [s.bundle_index_for_worker(i) for i in range(n)])


def test_ray_adapter_gates_without_ray():
    try:
        import ray  # noqa: F401
        pytest.skip("ray installed; gate not applicable")
    except ImportError:
        pass
    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=1)
    with pytest.raises(ImportError, match="ray"):
        ex.start()
    with pytest.raises(ImportError, match="ray"):
        ex.run(lambda: None)


def test_colocated_strategy_bundles():
    j, p = _strategies()
    kw = dict(num_hosts=2, workers_per_host=4, cpus_per_worker=2,
              gpus_per_worker=1)
    s = p.ColocatedStrategy(**kw)
    assert s.bundles() == [{"CPU": 8, "GPU": 4}, {"CPU": 8, "GPU": 4}]
    assert s.ray_strategy() == "PACK"
    assert _layout(s, 8) == _layout(j.ColocatedStrategy(**kw), 8)


def test_colocated_single_host_is_strict():
    _, p = _strategies()
    s = p.ColocatedStrategy(num_hosts=1, workers_per_host=2)
    assert s.ray_strategy() == "STRICT_PACK"


def test_spread_strategy_bundles():
    j, p = _strategies()
    kw = dict(num_workers=3, cpus_per_worker=1,
              resources_per_worker={"GPU": 1})
    s = p.SpreadStrategy(**kw)
    assert s.bundles() == [{"CPU": 1, "GPU": 1}] * 3
    assert s.ray_strategy() == "SPREAD"
    assert _layout(s, 3) == _layout(j.SpreadStrategy(**kw), 3)


@pytest.mark.parametrize("pack,n,hosts", [(True, 5, 2), (True, 4, 2),
                                          (True, 2, 4), (False, 3, 2)])
def test_strategy_for_splits_as_the_jax_package(pack, n, hosts):
    j, p = _strategies()
    s = p.strategy_for(pack, n, num_hosts=hosts, cpus_per_worker=2)
    assert _layout(s, n) == _layout(j.strategy_for(
        pack, n, num_hosts=hosts, cpus_per_worker=2), n)
    if pack and (n, hosts) == (5, 2):
        assert s.workers_by_host == [3, 2]
        assert s.bundles() == [{"CPU": 6}, {"CPU": 4}]


def _hosts(mod, fake_ray, **kw):
    return [(h.hostname, h.slots)
            for h in mod.RayHostDiscovery(**kw).find_available_hosts()]


def test_ray_host_discovery(fake_ray):
    from horovod_tpu.ray import elastic as jax_elastic
    from horovod_tpu_torch.ray import elastic as port_elastic
    fake_ray._nodes = [
        {"Alive": True, "NodeManagerAddress": "10.0.0.1",
         "Resources": {"CPU": 4.0}},
        {"Alive": False, "NodeManagerAddress": "10.0.0.2",
         "Resources": {"CPU": 4.0}},
        {"Alive": True, "NodeManagerAddress": "10.0.0.3",
         "Resources": {"CPU": 1.0}},
    ]
    hosts = _hosts(port_elastic, fake_ray, cpus_per_worker=2)
    assert hosts == [("10.0.0.1", 2)]
    assert hosts == _hosts(jax_elastic, fake_ray, cpus_per_worker=2)


def test_ray_host_discovery_gpu_bound(fake_ray):
    from horovod_tpu_torch.ray.elastic import RayHostDiscovery
    fake_ray._nodes = [{"Alive": True, "NodeManagerAddress": "10.0.0.1",
                        "Resources": {"CPU": 8.0, "GPU": 2.0}}]
    hosts = RayHostDiscovery(cpus_per_worker=1,
                             use_gpu=True).find_available_hosts()
    assert [(h.hostname, h.slots) for h in hosts] == [("10.0.0.1", 2)]


def _executor(**kw):
    from horovod_tpu_torch.ray.elastic import ElasticRayExecutor
    kw.setdefault("min_np", 2)
    kw.setdefault("max_np", 2)
    kw.setdefault("discovery_interval", 0.1)
    kw.setdefault("start_timeout", 15)
    ex = ElasticRayExecutor(**kw)
    ex.start()
    return ex


def test_elastic_driver_is_the_ports():
    from horovod_tpu_torch.ray.elastic import _RayElasticDriver
    from horovod_tpu_torch.runner.elastic_driver import ElasticDriver
    assert issubclass(_RayElasticDriver, ElasticDriver)


def test_elastic_run_happy_path(fake_ray):
    ex = _executor()

    def fn():
        import os
        return ("ok", os.environ.get("HVDTPU_WORKER_ID"))

    results = ex.run(fn)
    assert len(results) == 2
    assert {r[0] for r in results} == {"ok"}
    assert {r[1] for r in results} == {"127.0.0.1:0", "127.0.0.1:1"}
    ex.shutdown()


def test_elastic_worker_death_respawns_and_completes(fake_ray, tmp_path):
    """A worker dies mid-run; the driver respawns it (same slot, new actor)
    and the job still succeeds."""
    marker = tmp_path / "died_once"
    ex = _executor()

    def fn():
        import os
        wid = os.environ.get("HVDTPU_WORKER_ID")
        if wid == "127.0.0.1:0" and not os.path.exists(str(marker)):
            open(str(marker), "w").close()
            raise RuntimeError("simulated actor death")
        time.sleep(0.3)
        return ("ok", wid)

    results = ex.run(fn)
    assert marker.exists()
    assert len(results) == 2
    assert {r[0] for r in results} == {"ok"}
    ex.shutdown()


def test_elastic_below_quorum_fails(fake_ray):
    fake_ray._nodes = [{"Alive": True, "NodeManagerAddress": "127.0.0.1",
                        "Resources": {"CPU": 1.0}}]
    ex = _executor(min_np=2, max_np=2, start_timeout=1)
    with pytest.raises(RuntimeError):
        ex.run(lambda: "ok")
    ex.shutdown()


def test_placement_group_reserved_on_start(fake_ray):
    ex = _executor(use_placement_group=True, pack=True)
    assert ex._pg is not None
    assert ex._pg.strategy in ("PACK", "STRICT_PACK")
    assert sum(b.get("CPU", 0) for b in ex._pg.bundles) == 2
    ex.shutdown()

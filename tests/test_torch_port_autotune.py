"""The port's autotuner (``horovod_tpu_torch/autotune/``, the prior in
``analysis/costmodel.py``) against the JAX package's: two
``ParameterManager``s over the same fake runtime, fed the same cycles and
window scores, give identical ``applied`` sequences, winners, histories and
store entries, with and without the cost-model prior and with every arm the
fake runtime opens; each package warm-starts from the other's store file;
``window_stats`` and ``rank_candidates`` agree. Then the port on a real
runtime: a single-process sweep, its warm-start rerun, the ZeRO bucket
overlay re-planning the shards mid-run, and a 2-rank ``--autotune``
launcher job on the native TCP plane whose ranks apply one identical
sequence and converge to rank 0's winner, then warm-start from its store
(worker: tests/torch_port_autotune_worker.py)."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
WORKER = os.path.join(HERE, "torch_port_autotune_worker.py")
MIB = 1 << 20

import torch_port_launch  # noqa: E402


def _pkg(name):
    if name == "jax":
        from horovod_tpu import autotune, basics
        from horovod_tpu.autotune import core, overlay, score, store
        from horovod_tpu.analysis import costmodel
    else:
        from horovod_tpu_torch import autotune, basics
        from horovod_tpu_torch.autotune import core, overlay, score, store
        from horovod_tpu_torch.analysis import costmodel
    return types.SimpleNamespace(autotune=autotune, basics=basics,
                                 core=core, overlay=overlay, score=score,
                                 store=store, costmodel=costmodel)


class _Clock:
    """A monotonic clock that moves one second per call: a cycle's rate
    is then its byte delta, the same in both packages."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 1.0
        return self.t

    def time(self):
        return 1.7e9


class _FakeCore:
    def __init__(self):
        self.thresholds = []

    def set_fusion_threshold(self, v):
        self.thresholds.append(v)


def _rt(p, compression=False, min_bucket=None):
    coord = types.SimpleNamespace(bytes_processed=0, fusion_threshold=0,
                                  cycle_time_s=0.001)
    if compression:
        coord._compression = types.SimpleNamespace(
            policy=types.SimpleNamespace(rules=[("*", "int8")],
                                         threshold=1024),
            _delegated=False)
    backend = types.SimpleNamespace(core=_FakeCore())
    if min_bucket is not None:
        backend.min_bucket = min_bucket
        backend._buckets = []
        backend.set_min_bucket = backend._buckets.append
    return types.SimpleNamespace(
        mode=p.basics.MODE_SINGLE, coordinator=coord, backend=backend,
        topology=types.SimpleNamespace(rank=0, size=4), size=4,
        device=torch.device("cpu"))


def _rate(pm):
    """Bytes of the next cycle: a function of the applied knobs only."""
    c = pm.runtime.coordinator
    comp = getattr(c, "_compression", None)
    codec = comp.policy.rules[0][1] if comp and comp.policy.rules else "-"
    zb = pm._current.get("zero_bucket_bytes") or 0
    mb = pm._current.get("min_bucket") or 0
    return (1000 + (c.fusion_threshold // MIB) * 37
            + int(c.cycle_time_s * 1e4) % 97 + len(codec) * 11
            + (zb // MIB) % 13 + mb % 7)


def _sweep(name, monkeypatch, tmp_path, env, **rt_kw):
    p = _pkg(name)
    clock = _Clock()
    monkeypatch.setattr(p.core, "time", clock)
    monkeypatch.setattr(p.store, "time", clock)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cache = tmp_path / f"{name}.json"
    monkeypatch.setenv("HVDTPU_AUTOTUNE_CACHE", str(cache))
    p.overlay.clear()
    rt = _rt(p, **rt_kw)
    pm = p.autotune.ParameterManager(rt)
    for _ in range(5000):
        rt.coordinator.bytes_processed += _rate(pm)
        pm.record_cycle()
        if not pm.enabled:
            break
    assert not pm.enabled
    entries = json.loads(cache.read_text())["entries"]
    p.overlay.clear()
    return {"applied": pm.applied, "best": pm.best,
            "best_config": pm.best_config, "history": pm._history,
            "thresholds": rt.backend.core.thresholds,
            "buckets": getattr(rt.backend, "_buckets", None),
            "entries": entries, "arms": [a.name for a in pm._arms]}


GRID = {"HVDTPU_AUTOTUNE_FUSION_CANDIDATES_MIB": "0,1,4,32",
        "HVDTPU_AUTOTUNE_CYCLE_CANDIDATES_MS": "0.5,5",
        "HVDTPU_AUTOTUNE_WARMUP_CYCLES": "3",
        "HVDTPU_AUTOTUNE_CYCLES_PER_CANDIDATE": "8",
        "HVDTPU_AUTOTUNE_SIGNATURE": "sig", "HVDTPU_AUTOTUNE_SCORE": "bytes"}


@pytest.mark.parametrize("case", ["host", "prior", "arms"])
def test_sweeps_equal_the_jax_package(monkeypatch, tmp_path, case):
    env = dict(GRID)
    kw = {}
    if case == "prior":
        env["HVDTPU_COSTMODEL"] = "1"
    if case == "arms":
        env.update({"HVDTPU_ZERO": "1",
                    "HVDTPU_AUTOTUNE_COMPRESSION_CANDIDATES": "int8,bf16,none",
                    "HVDTPU_AUTOTUNE_BUCKET_CANDIDATES": "256,4096"})
        kw = {"compression": True, "min_bucket": 256}
    got = _sweep("port", monkeypatch, tmp_path, env, **kw)
    want = _sweep("jax", monkeypatch, tmp_path, env, **kw)
    assert got == want
    assert len(got["applied"]) > 8
    if case == "arms":
        assert got["arms"] == ["host", "compression", "zero"]


def test_the_prior_orders_as_the_jax_package():
    t, j = _pkg("port").costmodel, _pkg("jax").costmodel
    arms = {"host": [(f * MIB, c, b) for f in (0, 1, 8, 128)
                     for c in (0.1, 2.5) for b in (None, 4096)],
            "zero": [4 * MIB, 16 * MIB, 64 * MIB],
            "overlap": [MIB, 64 * MIB],
            "compression": [("none", 1024), ("int8", 0), ("bf16", 9)]}
    for world in (1, 2, 8, 64):
        for arm, cands in arms.items():
            assert t.rank_candidates(arm, cands, world) == \
                j.rank_candidates(arm, cands, world)
            assert [t.predicted_cost(arm, c, world) for c in cands] == \
                [j.predicted_cost(arm, c, world) for c in cands]


def test_cost_table_file_resolves_as_the_jax_package(monkeypatch,
                                                     tmp_path):
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"kinds": {"allreduce": {
        "alpha_s": 3e-5, "byte_s": 2e-10}}, "step_bytes": 12345}))
    monkeypatch.setenv("HVDTPU_COSTMODEL_TABLE", str(path))
    assert _pkg("port").costmodel.resolve_table() == \
        _pkg("jax").costmodel.resolve_table()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_warm_starts_from_the_other_s_store(
        monkeypatch, tmp_path, writer, reader):
    w = _sweep(writer, monkeypatch, tmp_path, GRID)
    p = _pkg(reader)
    os.replace(tmp_path / f"{writer}.json", tmp_path / f"{reader}.json")
    monkeypatch.setenv("HVDTPU_AUTOTUNE_CACHE",
                       str(tmp_path / f"{reader}.json"))
    assert p.store.load(str(tmp_path / f"{reader}.json")) == w["entries"]
    rt = _rt(p)
    pm = p.autotune.ParameterManager(rt)
    for _ in range(3):
        rt.coordinator.bytes_processed += 10
        pm.record_cycle()
    assert not pm.enabled and pm._history == []
    assert pm.applied == [w["applied"][-1]]
    assert rt.coordinator.fusion_threshold == w["best"][0]


def _events(seed):
    rng = np.random.RandomState(seed)
    ev, t = [], 0.0
    for occ in range(1, 8):
        names = [f"g{i}" for i in range(rng.randint(1, 5))]
        open_ = []
        for n in names:
            t += rng.rand()
            ev.append({"e": "sub", "t": t, "n": n, "o": occ})
            open_.append(n)
        for n in open_:
            if rng.rand() < 0.1:
                continue
            t += rng.rand()
            rec = {"e": "fin", "t": t, "n": n, "o": occ}
            if rng.rand() < 0.05:
                rec["err"] = 1
            ev.append(rec)
    return ev, t


@pytest.mark.parametrize("seed", range(6))
def test_window_stats_equal_the_jax_package(seed):
    ev, end = _events(seed)
    for t0, t1 in ((0.0, end), (end / 3, end), (0.0, end / 2)):
        assert _pkg("port").score.window_stats(ev, t0, t1) == \
            _pkg("jax").score.window_stats(ev, t0, t1)


def test_store_and_overlay_helpers_equal_the_jax_package(tmp_path):
    t, j = _pkg("port"), _pkg("jax")
    names = ["b", "hvdlint.x", "a", "a", ""]
    assert t.store.model_signature(names) == j.store.model_signature(names)
    assert t.store.CONFIG_KEYS == j.store.CONFIG_KEYS
    assert t.store.FORMAT == j.store.FORMAT
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for p in (t, j):
        with pytest.raises(p.store.StoreError):
            p.store.load(str(bad))
        p.overlay.clear()
        p.overlay.set_int("ZERO_BUCKET_BYTES", 3)
        assert p.overlay.resolve_int("ZERO_BUCKET_BYTES", 9) == 3
        p.overlay.clear()


# -- the port on a real runtime -------------------------------------------

@pytest.fixture
def fresh(monkeypatch):
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    yield hvd
    hvd.shutdown()
    _pkg("port").overlay.clear()


def _small_grid(monkeypatch, cache):
    for k, v in {"HVDTPU_AUTOTUNE": "1", "HVDTPU_AUTOTUNE_CACHE": cache,
                 "HVDTPU_AUTOTUNE_FUSION_CANDIDATES_MIB": "0,1",
                 "HVDTPU_AUTOTUNE_CYCLE_CANDIDATES_MS": "0.1,0.5",
                 "HVDTPU_AUTOTUNE_WARMUP_CYCLES": "2",
                 "HVDTPU_AUTOTUNE_CYCLES_PER_CANDIDATE": "4"}.items():
        monkeypatch.setenv(k, v)


def test_single_process_sweep_then_warm_start(fresh, monkeypatch, tmp_path):
    hvd = fresh
    from horovod_tpu_torch import basics
    cache = str(tmp_path / "cache.json")
    _small_grid(monkeypatch, cache)
    hvd.init(device="cpu")
    tuner = basics.runtime().autotuner
    for i in range(200):
        out = hvd.allreduce(torch.ones(300), name=f"g{i % 3}")
        assert float(out[0]) == 1.0
        if not tuner.enabled:
            break
    assert not tuner.enabled and tuner._history
    best = tuner.best
    coord = basics.runtime().coordinator
    assert (coord.fusion_threshold, coord.cycle_time_s * 1e3) == \
        (max(best[0], 1), pytest.approx(best[1]))
    hvd.shutdown()
    hvd.init(device="cpu")
    tuner = basics.runtime().autotuner
    for i in range(20):
        hvd.allreduce(torch.ones(300), name=f"g{i % 3}")
        if not tuner.enabled:
            break
    assert not tuner.enabled and tuner._history == []
    # The store holds the applied threshold (0 MiB is applied as 1 byte).
    assert tuner.best == (max(best[0], 1),) + best[1:]
    assert len(tuner.applied) == 1
    hvd.shutdown()
    monkeypatch.delenv("HVDTPU_AUTOTUNE")
    _pkg("port").overlay.set_int("ZERO_BUCKET_BYTES", 5)
    hvd.init(device="cpu")
    assert basics.runtime().autotuner is None
    assert _pkg("port").overlay.snapshot() == {}


def _zero_run(overlay_at):
    from horovod_tpu_torch import train
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.ReLU(),
                                torch.nn.Linear(64, 8))
    opt = train.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2), zero=True)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
    step = train.make_train_step(
        lambda m, b: m(b).square().mean(), opt)
    losses, plans = [], []
    for s in range(4):
        if s == overlay_at:
            _pkg("port").overlay.set_int("ZERO_BUCKET_BYTES", 4096)
        losses.append(float(step(model, x)))
        plans.append(len(opt._zero_rt.plan.buckets))
    return losses, plans


def test_zero_bucket_overlay_replans_the_shards(fresh, monkeypatch):
    fresh.init(device="cpu")
    ref, ref_plans = _zero_run(None)
    _pkg("port").overlay.clear()
    got, plans = _zero_run(2)
    assert plans[:2] == ref_plans[:2] and plans[2] > ref_plans[2]
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _job(tmp_path, name, cache, plane="tcp"):
    out = str(tmp_path / name)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HVDTPU_CPU_OPERATIONS=plane,
               # The derived key hashes the names the flight ring holds when
               # the warm-up ends, which depends on timing.
               HVDTPU_AUTOTUNE_SIGNATURE="autotune-worker",
               HVDTPU_AUTOTUNE_CACHE=cache,
               HVDTPU_AUTOTUNE_FUSION_CANDIDATES_MIB="0,1",
               HVDTPU_AUTOTUNE_CYCLE_CANDIDATES_MS="0.5,2",
               HVDTPU_AUTOTUNE_WARMUP_CYCLES="3",
               HVDTPU_AUTOTUNE_CYCLES_PER_CANDIDATE="4")
    rc, text = torch_port_launch.run_launcher(
        ["-np", "2", "--start-timeout", "60", "--autotune",
         "--autotune-log-file", str(tmp_path / f"{name}.csv"),
         sys.executable, WORKER, out], REPO, env, 180)
    assert rc == 0, text[-5000:]
    return [json.loads(open(f"{out}.r{r}.json").read()) for r in range(2)]


@pytest.mark.parametrize("plane,backend", [("tcp", "tcp-native"),
                                           ("nccl", "gloo-global")])
def test_two_rank_launcher_sweep_agrees_then_warm_starts(tmp_path, plane,
                                                         backend):
    """On the native TCP plane the core counts the bytes; on the delegated
    plane (gloo here, NCCL on the card) the backend adds the bytes it
    handed to ``torch.distributed``, so the tuner's cycles move there too."""
    torch_port_launch.build_port_core()
    cache = str(tmp_path / "cache.json")
    runs = _job(tmp_path, "sweep", cache, plane)
    assert runs[0]["applied"] == runs[1]["applied"]
    assert runs[0]["best"] == runs[1]["best"] and not runs[0]["enabled"]
    assert runs[0]["history"] > 0 and runs[1]["history"] > 0
    assert all(r["last"] == [3.0, 3.0, 3.0] for r in runs)
    assert all(r["backend"] == backend for r in runs)
    assert (tmp_path / "sweep.csv").read_text().count("*") >= 1
    if plane != "tcp":
        return
    warm = _job(tmp_path, "warm", cache, plane)
    for r in warm:
        assert r["history"] == 0 and len(r["applied"]) == 1
        # The store holds the applied threshold (0 MiB is applied as 1).
        assert r["best"] == [max(runs[0]["best"][0], 1)] + \
            runs[0]["best"][1:]

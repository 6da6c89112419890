"""The port's serving plane in process (``horovod_tpu_torch/serving/``)
against the JAX package's (``horovod_tpu/serving/``), on the CPU
(``device="cpu"``), same seeded numpy inputs, exact unless said:

- the page pool: allocation order, watermark decisions, gathers;
- ToyLM: prefill, batched decode, the oracle;
- the scheduler stepped in lockstep with the JAX one under a tight pool
  that forces preemption: each step's batch composition, the stats other
  than latency, every stream;
- ``stats()`` answering during a slow decode (the scheduler releases its
  lock around ``model.decode``; the JAX one holds it);
- the router in process (re-route, 429, 400, 503, drain), the autoscaler,
  the knobs and the metric families;
- ``plan_inference_ranges`` on the flagship's leaf shapes at small widths
  and on ``toy_params``, ``load_from_shards``, ``load_for_inference``.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.ops import zero as jzero
from horovod_tpu.serving import autoscale as jautoscale
from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu.serving import model as jmodel
from horovod_tpu.serving import scheduler as jsched
from horovod_tpu.serving import state as jstate
from horovod_tpu_torch.ops import zero as tzero
from horovod_tpu_torch.serving import autoscale as tautoscale
from horovod_tpu_torch.serving import kv_cache as tkv
from horovod_tpu_torch.serving import model as tmodel
from horovod_tpu_torch.serving import scheduler as tsched
from horovod_tpu_torch.serving import state as tstate
from horovod_tpu_torch.serving.router import InProcClient, Router
from horovod_tpu_torch.serving.worker import ServingWorker

CPU = "cpu"


def _requests(seed, n, max_prompt=8, max_new=12):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 200, size=int(rng.integers(1, max_prompt + 1)))
             .tolist(), int(rng.integers(1, max_new + 1)))
            for _ in range(n)]


# -- KV cache ----------------------------------------------------------------

def _pool_trace(mod, **dev):
    pool = mod.PagePool(10, 3, kv_dim=4, watermark=2, **dev)
    rng = np.random.default_rng(3)
    trace, tables = [], []
    for step in range(12):
        table = mod.PageTable(pool)
        n = int(rng.integers(1, 9))
        trace.append(("admit", n, pool.can_admit(n)))
        try:
            table.append(rng.integers(0, 97, size=(n, 4)).astype(
                np.float32))
            tables.append(table)
        except mod.PoolExhausted:
            trace.append("exhausted")
        if step % 3 == 2 and tables:
            tables.pop(0).release()
        trace.append((pool.free_pages, [list(t.pages) for t in tables]))
    gathers = [np.asarray(t.gather()) for t in tables]
    return trace, gathers


def test_page_pool_allocation_watermark_and_gathers_match_jax():
    got, got_g = _pool_trace(tkv, device=CPU)
    want, want_g = _pool_trace(jkv)
    assert got == want
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        np.testing.assert_array_equal(g, w)


def test_page_pool_validates_and_alloc_is_all_or_nothing():
    with pytest.raises(ValueError):
        tkv.PagePool(0, 4, device=CPU)
    with pytest.raises(ValueError):
        tkv.PagePool(4, 4, watermark=4, device=CPU)
    pool = tkv.PagePool(4, 2, watermark=1, device=CPU)
    with pytest.raises(tkv.PoolExhausted):
        pool.alloc(5)
    assert pool.free_pages == 4
    assert pool.data is None
    with pytest.raises(ValueError, match="no KV payload"):
        tkv.PageTable(pool).gather()


def test_pool_and_model_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tkv.PagePool(4, 2),
                 lambda: tmodel.ToyLM(),
                 lambda: ServingWorker()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert ServingWorker(device=CPU).device == torch.device(CPU)


# -- ToyLM -------------------------------------------------------------------

def test_toylm_prefill_decode_and_oracle_match_jax():
    t, j = tmodel.ToyLM(device=CPU), jmodel.ToyLM()
    rng = np.random.default_rng(11)
    for prompt, n in _requests(5, 20, max_prompt=40, max_new=30):
        assert t.reference_completion(prompt, n) == \
            j.reference_completion(prompt, n)
        np.testing.assert_array_equal(t.prefill(prompt).numpy(),
                                      j.prefill(prompt))
    contexts = [j.prefill(rng.integers(0, 500, size=k).tolist())
                for k in (0, 1, 5, 64, 3)]
    jt, jk = j.decode(contexts)
    tt, tk = t.decode([torch.as_tensor(c) for c in contexts])
    assert tt == jt
    np.testing.assert_array_equal(tk.numpy(), np.stack(jk))
    assert t.decode([]) == ([], [])


def test_toylm_takes_tensor_params_and_eos():
    params = {k: torch.as_tensor(v) for k, v in
              tmodel.toy_params(vocab=53, kv_dim=3).items()}
    t = tmodel.ToyLM(params, eos_id=5, device=CPU)
    j = jmodel.ToyLM(jmodel.toy_params(vocab=53, kv_dim=3), eos_id=5)
    assert (t.vocab, t.kv_dim) == (53, 3)
    for prompt, n in _requests(8, 10, max_new=40):
        assert t.reference_completion(prompt, n) == \
            j.reference_completion(prompt, n)


# -- the scheduler in lockstep with the JAX one -------------------------------

SCHED_CASES = {
    "tight": dict(kw=dict(max_batch_tokens=32, queue_limit=16,
                          num_pages=12, page_size=2, watermark=1),
                  n=12, seed=0),
    "budget": dict(kw=dict(max_batch_tokens=12, queue_limit=32,
                           num_pages=40, page_size=4),
                   n=20, seed=1),
    "eos": dict(kw=dict(max_batch_tokens=24, queue_limit=8, num_pages=9,
                        page_size=3, watermark=1),
                n=8, seed=2, eos=13),
}


def _stats(s):
    out = s.stats()
    out.pop("p99_latency")
    return out


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_scheduler_steps_in_lockstep_with_jax(case):
    c = SCHED_CASES[case]
    tm = tmodel.ToyLM(eos_id=c.get("eos"), device=CPU)
    jm = jmodel.ToyLM(eos_id=c.get("eos"))
    ts, js = tsched.Scheduler(tm, **c["kw"]), jsched.Scheduler(jm, **c["kw"])
    reqs = _requests(c["seed"], c["n"])
    tres = [ts.submit(tsched.Request(f"q{i}", p, n))
            for i, (p, n) in enumerate(reqs)]
    jres = [js.submit(jsched.Request(f"q{i}", p, n))
            for i, (p, n) in enumerate(reqs)]
    assert [r is None for r in tres] == [r is None for r in jres]
    for step in range(2000):
        assert ts.step() == js.step(), step
        assert _stats(ts) == _stats(js), step
        if all(r is None or r.done.is_set() for r in jres):
            break
    assert ts.idle() and js.idle()
    for tr, jr, (p, n) in zip(tres, jres, reqs):
        if jr is None:
            continue
        assert tr.tokens(timeout=1) == jr.tokens(timeout=1) == \
            jm.reference_completion(p, n)
        assert tr.summary["state"] == jr.summary["state"]
        assert tr.summary["preempts"] == jr.summary["preempts"]
    if case == "tight":
        assert ts.preemptions > 0 and ts.admission_blocked > 0
    assert list(ts.step_log) == list(js.step_log)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_scheduler_refusals_match(pkg):
    sched, model, dev = ((tsched, tmodel, {"device": CPU}) if pkg == "port"
                         else (jsched, jmodel, {}))
    s = sched.Scheduler(model.ToyLM(**dev), max_batch_tokens=8,
                        queue_limit=1, num_pages=8, page_size=2)
    too_long = s.submit(sched.Request("a", list(range(9)), 2))
    too_large = s.submit(sched.Request("b", [1], 40))
    assert too_long.summary["reason"] == too_large.summary["reason"] == \
        "too_large"
    assert s.submit(sched.Request("c", [1], 2)) is not None
    assert s.submit(sched.Request("d", [1], 2)) is None   # queue full
    s.drain()
    assert s.submit(sched.Request("e", [1], 2)) is None
    with pytest.raises(ValueError):
        sched.Request("f", [], 2)
    with pytest.raises(ValueError):
        sched.Request("g", [1], 0)


class _SlowLM(tmodel.ToyLM):
    """A ToyLM whose decode sleeps: the scheduler must answer meanwhile."""

    def __init__(self, sleep_s, **kw):
        super().__init__(**kw)
        self.sleep_s = sleep_s
        self.decoding = threading.Event()

    def decode(self, contexts):
        self.decoding.set()
        time.sleep(self.sleep_s)
        return super().decode(contexts)


def test_stats_answer_during_a_slow_decode():
    # The JAX scheduler holds its lock across model.decode, so stats()
    # waits out the whole decode there (ROADMAP queue C).
    m = _SlowLM(2.0, device=CPU)
    s = tsched.Scheduler(m, max_batch_tokens=16, queue_limit=4,
                         num_pages=16, page_size=2)
    r = s.submit(tsched.Request("slow", [4, 2], 1))
    stepper = threading.Thread(target=s.step)
    stepper.start()
    try:
        assert m.decoding.wait(10)
        t0 = time.monotonic()
        stats = s.stats()
        answered = time.monotonic() - t0
        assert answered < 0.5, answered
        assert stats["running"] == 1 and stats["steps"] == 0
        assert s.submit(tsched.Request("more", [1], 1)) is not None
    finally:
        stepper.join(10)
    assert r.tokens(timeout=1) == m.reference_completion([4, 2], 1)


def test_a_sequence_migrated_during_the_decode_is_skipped():
    m = _SlowLM(0.5, device=CPU)
    s = tsched.Scheduler(m, max_batch_tokens=16, queue_limit=4,
                         num_pages=16, page_size=2)
    moved = []

    class _Taker:
        def migrate_seq(self, record):
            moved.append(record)
            return {"url": "inproc", "wid": 1, "id": "x", "cohort": "c0"}

    r = s.submit(tsched.Request("m", [4, 2], 5))
    s.step()                   # admitted, one token generated
    stepper = threading.Thread(target=s.step)
    stepper.start()
    assert m.decoding.wait(10)
    m.decoding.clear()
    s.migrator = _Taker()
    assert s.migrate_all_out() == 1
    stepper.join(10)
    assert r.summary["state"] == "migrated"
    assert moved[0]["generated"] == r.summary["tokens"]
    assert len(moved[0]["generated"]) == 1
    assert s.tokens_out == 1 and s.idle()


def test_an_import_does_not_wait_for_the_schedulers_lock():
    # A peer's loop thread migrates here while it holds its own lock; if
    # the import waited for this scheduler's lock, two workers shedding
    # to each other at once would each wait out the transfer's timeout
    # (the JAX scheduler takes its lock in import_remote).
    src = tsched.Scheduler(tmodel.ToyLM(device=CPU), max_batch_tokens=16,
                           queue_limit=4, num_pages=16, page_size=2)
    src.submit(tsched.Request("a", [4, 2], 6))
    src.step()
    record = src._export_record(next(iter(src._running.values())))
    dst = tsched.Scheduler(tmodel.ToyLM(device=CPU), max_batch_tokens=16,
                           queue_limit=4, num_pages=16, page_size=2)
    done = {}
    with dst._lock:            # dst's loop thread is mid-step
        t = threading.Thread(target=lambda: done.update(
            out=dst.import_remote(record)))
        t.start()
        t.join(5)
        assert "out" in done, "import_remote waited for the lock"
    rid, result = done["out"]
    assert dst.stats()["running"] == 1 and dst.migrated_in == 1
    while not result.done.is_set():
        dst.step()
    assert result.tokens(timeout=1) == \
        jmodel.ToyLM().reference_completion([4, 2], 6)


# -- router and worker, in process --------------------------------------------

class _DeadClient:
    base_url = "inproc:dead"

    def generate(self, payload):
        raise ConnectionRefusedError("worker gone")

    def stats(self):
        raise ConnectionRefusedError("worker gone")

    def drain(self):
        raise ConnectionRefusedError("worker gone")


def _worker(**kw):
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 4)
    kw.setdefault("queue_limit", 8)
    return ServingWorker(device=CPU, **kw)


def test_router_reroutes_backpressures_and_drains_in_process():
    w = _worker().start()
    try:
        router = Router(members={"c0": [_DeadClient(), InProcClient(w)]})
        status, body = router.generate({"prompt": [2, 7],
                                        "max_new_tokens": 4})
        assert status == 200
        assert body["tokens"] == \
            jmodel.ToyLM().reference_completion([2, 7], 4)
        assert (router.rerouted, router.completed) == (1, 1)
        assert router.generate({"prompt": [],
                                "max_new_tokens": 2})[0] == 400
        stats = router.stats()
        assert stats["source"] == "local" and "c0" in stats["cohorts"]
        assert router.drain_cohort("c0")["acks"] == {"0": False, "1": True}
        status, body = router.generate({"prompt": [1],
                                        "max_new_tokens": 2})
        assert status == 503 and "draining" in body["error"]
    finally:
        w.stop()
    assert Router(members={}).generate({"prompt": [1]})[0] == 503
    parked = _worker(queue_limit=1)
    assert parked.scheduler.submit(tsched.Request("p", [1], 2)) is not None
    router = Router(members={"c0": [InProcClient(parked)]})
    status, body = router.generate({"id": "r9", "prompt": [1],
                                    "max_new_tokens": 2})
    assert status == 429 and body["retry_after"] > 0
    assert router.rejected == 1


def test_worker_p99_and_too_large_413():
    w = _worker().start()
    try:
        for _ in range(3):
            assert w.handle_generate({"prompt": [2, 7],
                                      "max_new_tokens": 3})[0] == 200
        assert 0.0 < w.scheduler.stats()["p99_latency"] < 60.0
        status, body = w.handle_generate({"prompt": [1],
                                          "max_new_tokens": 10 ** 4})
        assert status == 413 and body["state"] == "failed"
        assert w.handle_generate([1, 2])[0] == 400
    finally:
        w.stop()


# -- autoscaler --------------------------------------------------------------

def _autoscale_trace(mod):
    events = []
    a = mod.Autoscaler(lambda: events.append("up"),
                       scale_down=lambda c: events.append(("down", c)),
                       drain=lambda c: events.append(("drain", c)),
                       scale_up_depth=10, window=2, cooldown_s=3.0,
                       idle_s=2.0, drain_timeout=4.0, slo_p99=0.5)
    ticks = [{"c0": {"queue_depth": 8, "running": 4},
              "c1": {"queue_depth": 0, "running": 0}},
             {"c0": {"queue_depth": 9, "running": 4},
              "c1": {"queue_depth": 0, "running": 0}},
             {"c0": {"queue_depth": 0, "running": 1, "p99_latency": 0.9},
              "c1": {"queue_depth": 0, "running": 0}},
             {"c0": {"queue_depth": 0, "running": 1, "p99_latency": 0.9},
              "c1": {"queue_depth": 0, "running": 2}},
             {"c0": {"queue_depth": 0, "running": 1, "p99_latency": 0.9},
              "c1": {"queue_depth": 0, "running": 0}}] * 3
    for t, tick in enumerate(ticks):
        events.append(a.observe(tick, now=float(t)))
    return events, a.events


def test_autoscaler_matches_jax():
    assert _autoscale_trace(tautoscale) == _autoscale_trace(jautoscale)


def test_write_target_is_atomic_and_the_discovery_script_reads_it(
        tmp_path):
    import subprocess
    target = tmp_path / "targets"
    tautoscale.write_target(str(target), ["localhost:4"])
    tautoscale.write_target(str(target), ["localhost:2", "other:2"])
    assert os.listdir(tmp_path) == ["targets"]
    assert tautoscale.discovery_script_lines(str(target)) == \
        jautoscale.discovery_script_lines(str(target))
    path = tmp_path / "discover.sh"
    path.write_text("\n".join(
        tautoscale.discovery_script_lines(str(target))) + "\n")
    path.chmod(0o755)
    out = subprocess.run([str(path)], capture_output=True, text=True,
                         timeout=30)
    assert out.stdout.splitlines() == ["localhost:2", "other:2"]


# -- knobs and metrics ---------------------------------------------------------

def test_serving_knobs_and_defaults_follow_jax(monkeypatch):
    from horovod_tpu.serving import migration as jmig
    from horovod_tpu.serving import worker as jworker
    from horovod_tpu_torch.serving import migration as tmig
    from horovod_tpu_torch.serving import worker as tworker
    assert tworker.knob_defaults() == jworker.knob_defaults()
    assert tmig.knobs() == jmig.knobs()
    assert tautoscale.scale_knobs() == jautoscale.scale_knobs()
    monkeypatch.setenv("HVDTPU_SERVING_KV_PAGES", "32")
    monkeypatch.setenv("HVDTPU_SERVING_MIGRATE_RETRIES", "7")
    monkeypatch.setenv("HVDTPU_SERVING_SLO_P99", "1.5")
    assert tworker.knob_defaults() == jworker.knob_defaults()
    assert tworker.knob_defaults()["num_pages"] == 32
    assert tmig.knobs() == jmig.knobs()
    assert tautoscale.scale_knobs() == jautoscale.scale_knobs()


def _families(sched, model, worker_mod, dev, monkeypatch, telemetry):
    monkeypatch.setenv("HOROVOD_TPU_METRICS", "1")
    telemetry.reset()
    try:
        w = worker_mod.ServingWorker(model.ToyLM(**dev), num_pages=16,
                                     page_size=2, queue_limit=1)
        assert w.scheduler.submit(sched.Request("a", [1, 2], 3))
        assert w.handle_generate({"prompt": [1],
                                  "max_new_tokens": 2})[0] == 429
        while not w.scheduler.idle():
            w.scheduler.step()
        fams = telemetry.registry().snapshot()["families"]
        return {name: (f.get("type"), f.get("help"),
                       sorted(tuple(sorted(s.get("labels", {}).items()))
                              for s in f["samples"]))
                for name, f in fams.items() if name.startswith("hvd_serving")}
    finally:
        telemetry.reset()


def test_serving_metric_families_match_jax(monkeypatch):
    from horovod_tpu.serving import worker as jworker
    from horovod_tpu.telemetry import core as jtel
    from horovod_tpu_torch.serving import worker as tworker
    from horovod_tpu_torch.telemetry import core as ttel
    got = _families(tsched, tmodel, tworker, {"device": CPU}, monkeypatch,
                    ttel)
    want = _families(jsched, jmodel, jworker, {}, monkeypatch, jtel)
    assert set(got) >= {"hvd_serving_latency_seconds",
                        "hvd_serving_tokens_total",
                        "hvd_serving_kv_pages_free",
                        "hvd_serving_queue_depth",
                        "hvd_serving_rejected_total"}
    assert got == want


# -- train -> serve state -----------------------------------------------------

def _flagship_small_shapes():
    from horovod_tpu_torch import models
    cfg = models.TransformerConfig(vocab_size=96, hidden=32, layers=2,
                                   heads=2, max_len=16, causal=True,
                                   use_rope=True)
    m = models.TransformerLM(cfg, device=CPU,
                             generator=torch.Generator().manual_seed(0))
    return [tuple(p.shape) for p in m.parameters()]


def _ranges_as_tuples(ranges):
    return [[[(r.bucket, r.src_rank, r.src_offset, r.length, r.dst_offset)
              for r in leaf] for leaf in host] for host in ranges]


@pytest.mark.parametrize("tree", ["flagship", "toy"])
@pytest.mark.parametrize("layout", ["replicated", "rows"])
def test_plan_inference_ranges_match_jax(tree, layout):
    if tree == "flagship":
        shapes, bucket = _flagship_small_shapes(), 4096
    else:
        shapes = [v.shape for v in jmodel.toy_params().values()]
        bucket = 512
    tleaves = [torch.empty(s, device="meta") for s in shapes]
    jleaves = [np.zeros(s, np.float32) for s in shapes]
    for n in (1, 2, 4):
        tplan = tzero.plan_zero(tleaves, n, bucket_bytes=bucket)
        jplan = jzero.plan_zero(jleaves, n, bucket_bytes=bucket)
        assert tplan.signature() == jplan.signature()
        for world in (1, 2, 3, 4):
            got = tstate.plan_inference_ranges(tplan, world, layout)
            want = jstate.plan_inference_ranges(jplan, world, layout)
            assert _ranges_as_tuples(got[0]) == _ranges_as_tuples(want[0])
            assert got[1] == want[1]


def _bucket_shards(leaves, plan):
    """Per-rank flat bucket shards as the ZeRO pack lays them out."""
    shards = {r: [] for r in range(plan.n)}
    for b, s in zip(plan.buckets, plan.shards):
        buf = np.zeros((s.padded,), np.float32)
        off = 0
        for i in b.indices:
            arr = np.ravel(leaves[i])
            buf[off:off + arr.size] = arr
            off += arr.size
        for r in range(plan.n):
            shards[r].append(buf[r * s.shard_len:(r + 1) * s.shard_len])
    return shards


def test_load_from_shards_matches_jax_and_round_trips():
    from horovod_tpu_torch.utils import tree as ttree
    params = tmodel.toy_params()
    leaves = ttree.leaves(params)
    tplan = tzero.plan_zero([torch.as_tensor(x) for x in leaves], 4,
                            bucket_bytes=512)
    jplan = jzero.plan_zero(leaves, 4, bucket_bytes=512)
    jshards = _bucket_shards(leaves, jplan)
    tshards = {r: [torch.as_tensor(x) for x in v] for r, v in
               jshards.items()}
    tree_, rep = tstate.load_from_shards(tshards, tplan,
                                         treedef=ttree.structure(params))
    for k in params:
        np.testing.assert_array_equal(tree_[k].numpy(), params[k])
    assert rep["total_leaves"] == 2
    for world in (1, 2, 3):
        per_leaf = {}
        for host in range(world):
            got, grep = tstate.load_from_shards(
                tshards, tplan, serving_world=world, serving_rank=host,
                layout=tstate.ROWS)
            want, wrep = jstate.load_from_shards(
                jshards, jplan, serving_world=world, serving_rank=host,
                layout=jstate.ROWS)
            assert grep == wrep
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(g.numpy(), w)
                per_leaf.setdefault(i, []).append(g)
        for i, leaf in enumerate(leaves):
            np.testing.assert_array_equal(
                torch.cat(per_leaf[i]).numpy(), leaf)
    del tshards[2]
    with pytest.raises(KeyError, match="rank"):
        tstate.load_from_shards(tshards, tplan)


def test_load_for_inference_returns_views_on_the_device():
    params = {k: torch.as_tensor(v) for k, v in
              tmodel.toy_params().items()}
    full = tstate.load_for_inference(params)
    assert full["emb"].data_ptr() == params["emb"].data_ptr()
    half = tstate.load_for_inference(params, serving_world=2,
                                     serving_rank=1, layout=tstate.ROWS)
    want = jstate.load_for_inference(tmodel.toy_params(), serving_world=2,
                                     serving_rank=1, layout=jstate.ROWS)
    for k in params:
        np.testing.assert_array_equal(half[k].numpy(), want[k])
    assert half["emb"]._base is not None   # a view, not a copy
    m0 = tmodel.ToyLM(tstate.load_for_inference(params), device=CPU)
    assert m0.reference_completion([4, 4], 5) == \
        jmodel.ToyLM().reference_completion([4, 4], 5)
    with pytest.raises(ValueError):
        tstate.load_for_inference(params, layout="diagonal")
    with pytest.raises(ValueError):
        tstate.load_for_inference(params, serving_world=2, serving_rank=2)
    from horovod_tpu_torch import serving
    assert serving.load_for_inference(params)["proj"] is not None

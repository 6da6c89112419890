"""The port's KV-cache live migration (``horovod_tpu_torch/serving/
kv_cache.py``, ``migration.py``, the worker's ``migrate_in`` route) against
the JAX package's, on the CPU (``device="cpu"``):

- records exported by the port import into the JAX pool and the other way
  round, bit-exact, with equal digests; refusals (digest, geometry,
  headroom) are all-or-nothing in both;
- a pool-exhausted scheduler migrates its victim to a peer scheduler of
  either package instead of preempting, and every stream equals the
  oracle; a refused migration falls back to recompute;
- the ``migrate_out`` and ``migrate_in`` chaos points fire: a failed chunk
  is retried, a corrupted one is refused and the source recomputes;
- two HTTP workers behind a router shed a sequence by migration with no
  recompute (source and target in either package), and a drain migrates
  a direct client's stream mid-flight.

Waits are on events or polls with deadlines; no latency bar.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu.serving import migration as jmig
from horovod_tpu.serving import model as jmodel
from horovod_tpu.serving import scheduler as jsched
from horovod_tpu.serving import worker as jworker
from horovod_tpu_torch import chaos
from horovod_tpu_torch.runner.http_server import (AUTH_HEADER,
                                                  KVStoreServer,
                                                  new_job_token)
from horovod_tpu_torch.serving import kv_cache as tkv
from horovod_tpu_torch.serving import migration as tmig
from horovod_tpu_torch.serving import model as tmodel
from horovod_tpu_torch.serving import scheduler as tsched
from horovod_tpu_torch.serving import worker as tworker
from horovod_tpu_torch.serving.router import Router

CPU = {"device": "cpu"}
PKGS = {"port": (tkv, tsched, tmodel, tworker, tmig, CPU),
        "jax": (jkv, jsched, jmodel, jworker, jmig, {})}
ORACLE = jmodel.ToyLM()


def _filled(kv, dev, n_tokens, seed=7, **pool_kw):
    pool = kv.PagePool(8, 4, kv_dim=3, watermark=1, **dev, **pool_kw)
    table = kv.PageTable(pool)
    table.append(np.random.default_rng(seed).standard_normal(
        (n_tokens, 3)).astype(np.float32))
    return pool, table


@pytest.mark.parametrize("src,dst", [("port", "jax"), ("jax", "port")])
def test_records_cross_packages_bit_exact(src, dst):
    skv, sdev = PKGS[src][0], PKGS[src][5]
    dkv, ddev = PKGS[dst][0], PKGS[dst][5]
    pool, table = _filled(skv, sdev, 10)
    rec = pool.export_sequence(table)
    # the same data exports the same record in both packages
    other_pool, other_table = _filled(dkv, ddev, 10)
    assert other_pool.export_sequence(other_table) == rec
    target = dkv.PagePool(8, 4, kv_dim=3, watermark=1, **ddev)
    got = target.import_sequence(rec)
    assert got.num_tokens == 10 and len(got.pages) == 3
    np.testing.assert_array_equal(np.asarray(got.gather()),
                                  np.asarray(table.gather()))
    assert target.export_sequence(got)["pages"] == rec["pages"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_import_refusals_leave_the_pool_untouched(pkg):
    kv, dev = PKGS[pkg][0], PKGS[pkg][5]
    pool, table = _filled(kv, dev, 10)
    rec = pool.export_sequence(table)
    target = kv.PagePool(8, 4, kv_dim=3, watermark=1, **dev)
    bad = json.loads(json.dumps(rec))
    jmig._corrupt_payload(bad["pages"])
    outcomes = []
    for record in (bad, dict(rec, page_size=2), dict(rec, kv_dim=4),
                   dict(rec, num_tokens=20)):
        with pytest.raises(kv.MigrationError) as err:
            target.import_sequence(record)
        outcomes.append(type(err.value).__name__)
        assert target.free_pages == 8
    small = kv.PagePool(4, 4, kv_dim=3, watermark=2, **dev)
    with pytest.raises(kv.NoHeadroom):
        small.import_sequence(rec)
    assert small.free_pages == 4
    assert outcomes == ["DigestMismatch", "GeometryMismatch",
                        "GeometryMismatch", "GeometryMismatch"]


class _LocalMigrator:
    """Imports straight into a target scheduler (no HTTP)."""

    def __init__(self, target):
        self.target = target
        self.moved = {}

    def migrate_seq(self, record):
        try:
            rid, result = self.target.import_remote(
                json.loads(json.dumps(record)))
        except Exception:
            return None
        self.moved[record["id"]] = result
        return {"url": "inproc", "wid": 1, "id": rid, "cohort": "c0"}


def _drive(scheduler, results, max_steps=500):
    for _ in range(max_steps):
        scheduler.step()
        if all(r.done.is_set() for r in results):
            return
    raise AssertionError(f"not done after {max_steps} steps: "
                         f"{scheduler.stats()}")


@pytest.mark.parametrize("dst", ["port", "jax"])
def test_scheduler_migrates_instead_of_preempting(dst):
    _, dsched, dmodel, _, _, ddev = PKGS[dst]
    src = tsched.Scheduler(tmodel.ToyLM(**CPU), max_batch_tokens=32,
                           queue_limit=8, num_pages=6, page_size=2,
                           watermark=1)
    target = dsched.Scheduler(dmodel.ToyLM(**ddev), max_batch_tokens=32,
                              queue_limit=8, num_pages=64, page_size=2)
    src.migrator = _LocalMigrator(target)
    reqs = [([i + 1, 2], 5) for i in range(4)]
    results = [src.submit(tsched.Request(f"q{i}", p, n))
               for i, (p, n) in enumerate(reqs)]
    for _ in range(500):
        src.step()
        target.step()
        if all(r.done.is_set() for r in results):
            break
    _drive(target, list(src.migrator.moved.values()))
    assert src.migrated_out >= 1 and src.preemptions == 0
    for (p, n), r in zip(reqs, results):
        if r.summary["state"] == "migrated":
            tgt = src.migrator.moved[r.summary["id"]]
            assert tgt.tokens(timeout=5) == ORACLE.reference_completion(p, n)
        else:
            assert r.tokens(timeout=5) == ORACLE.reference_completion(p, n)
    assert target.preemptions == 0
    assert target.migrated_in == src.migrated_out


def test_migrate_all_out_moves_hot_and_cold_and_refusal_recomputes():
    m = tmodel.ToyLM(**CPU)
    src = tsched.Scheduler(m, max_batch_tokens=32, queue_limit=8,
                           num_pages=16, page_size=2)
    dst = tsched.Scheduler(tmodel.ToyLM(**CPU), max_batch_tokens=32,
                           queue_limit=8, num_pages=64, page_size=2)
    reqs = [([9, i + 1], 8) for i in range(3)]
    results = [src.submit(tsched.Request(f"d{i}", p, n))
               for i, (p, n) in enumerate(reqs)]
    for _ in range(3):
        src.step()
    with src._lock:
        src._preempt_lru(exclude_id=None)     # a cold record in the mix
    src.migrator = _LocalMigrator(dst)
    assert src.migrate_all_out() == 3 and src.idle()
    for (p, n), r in zip(reqs, results):
        tgt = src.migrator.moved[r.summary["id"]]
        _drive(dst, [tgt])
        assert tgt.tokens(timeout=5) == ORACLE.reference_completion(p, n)

    class _Refusing:
        def migrate_seq(self, record):
            return None

    s = tsched.Scheduler(m, max_batch_tokens=32, queue_limit=8,
                         num_pages=6, page_size=2, watermark=1)
    s.migrator = _Refusing()
    reqs = [([i + 1, 2], 5) for i in range(4)]
    results = [s.submit(tsched.Request(f"f{i}", p, n))
               for i, (p, n) in enumerate(reqs)]
    _drive(s, results)
    assert s.preemptions > 0 and s.migrate_failed > 0
    for (p, n), r in zip(reqs, results):
        assert r.tokens(timeout=5) == ORACLE.reference_completion(p, n)
    assert tmig.Migrator("c0", 0, peers=[]).migrate_seq(
        {"id": "x", "pages": []}) is None


# -- over HTTP ---------------------------------------------------------------

def _post(port, path, payload, token=""):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(), method="POST")
    if token:
        req.add_header(AUTH_HEADER, token)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else {})


def _export_from(pkg, prompt, n_steps, version="0", **pool_kw):
    """A hot record: a real scheduler of ``pkg`` a few steps in."""
    _, sched, model, _, _, dev = PKGS[pkg]
    s = sched.Scheduler(model.ToyLM(**dev), max_batch_tokens=64,
                        queue_limit=4, **pool_kw)
    s.elastic_version = version
    s.submit(sched.Request("src", prompt, 8))
    for _ in range(n_steps):
        s.step()
    return s._export_record(next(iter(s._running.values())))


def _chunk(rec, mid):
    return {"mid": mid, "chunk": 0, "total": 1, "pages": rec["pages"],
            "meta": {k: v for k, v in rec.items() if k != "pages"},
            "commit": True}


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_http_migrate_in_commits_and_fences_across_packages(src, dst):
    token = new_job_token()
    _, _, dmodel, dworker, _, ddev = PKGS[dst]
    w = dworker.ServingWorker(dmodel.ToyLM(**ddev), cohort="c0", wid=1,
                              num_pages=64, page_size=4).start()
    try:
        port = w.serve_http(addr="127.0.0.1", token=token)
        rec = _export_from(src, [4, 2], 3, num_pages=64, page_size=4)
        assert _post(port, tmig.MIGRATE_PATH, _chunk(rec, "g"))[0] == 403
        status, out = _post(port, tmig.MIGRATE_PATH, _chunk(rec, "g"),
                            token=token)
        assert status == 200 and out["state"] == "imported"
        status, final = _post(port, "/v1/generate", {"attach": out["id"]},
                              token=token)
        assert status == 200
        assert final["tokens"] == ORACLE.reference_completion([4, 2], 8)
        assert w.scheduler.preemptions == 0
        fenced = _export_from(src, [4, 2], 3, version="9", num_pages=64,
                              page_size=4)
        status, out = _post(port, tmig.MIGRATE_PATH, _chunk(fenced, "f"),
                            token=token)
        assert (status, out["error"], out["record_version"]) == \
            (409, "version_fenced", "9")
        bad = _export_from(src, [4, 2], 3, num_pages=64, page_size=4)
        tmig._corrupt_payload(bad["pages"])
        free = w.scheduler.pool.free_pages
        status, out = _post(port, tmig.MIGRATE_PATH, _chunk(bad, "b"),
                            token=token)
        assert (status, out["error"]) == (422, "digest_mismatch")
        assert w.scheduler.pool.free_pages == free
        w.scheduler.drain()
        status, out = _post(port, tmig.MIGRATE_PATH, _chunk(bad, "d"),
                            token=token)
        assert (status, out["error"]) == (409, "draining")
        assert w.scheduler.migrated_in == 1
    finally:
        w.stop()


@pytest.fixture
def chaos_spec(monkeypatch, tmp_path):
    """Sets ``HVDTPU_CHAOS``; returns a reader of the firings logged."""
    log = tmp_path / "chaos.log"
    monkeypatch.setenv("HVDTPU_CHAOS_LOG", str(log))

    def set_spec(spec):
        monkeypatch.setenv("HVDTPU_CHAOS", spec)
        chaos.reset()
        return lambda: [line.split()[1:3] for line in
                        (log.read_text().splitlines() if log.exists()
                         else [])]
    yield set_spec
    monkeypatch.delenv("HVDTPU_CHAOS", raising=False)
    chaos.reset()


def test_migrate_out_chaos_fail_is_retried_across_chunks(chaos_spec):
    token = new_job_token()
    target = jworker.ServingWorker(jmodel.ToyLM(), cohort="c0", wid=1,
                                   num_pages=64, page_size=2).start()
    fired = chaos_spec("migrate_out:fail:n=1")
    try:
        port = target.serve_http(addr="127.0.0.1", token=token)
        rec = _export_from("port", [4, 2, 7], 4, num_pages=64, page_size=2)
        assert len(rec["pages"]) >= 2
        body = tmig.migrate_out(
            f"http://127.0.0.1:{port}", rec, token=token, retries=3,
            deadline=5.0, max_bytes=len(rec["pages"][0]["payload"]) + 256)
        assert body["state"] == "imported"
        with target._attached_lock:
            res = target._attached[body["id"]]
        assert res.tokens(timeout=10) == \
            ORACLE.reference_completion([4, 2, 7], 8)
        assert fired() == [["migrate_out", "fail"]]
    finally:
        target.stop()


@pytest.mark.parametrize("spec", ["migrate_out:corrupt",
                                  "migrate_in:corrupt",
                                  "migrate_in:fail"])
def test_chaos_at_either_end_falls_back_to_recompute(chaos_spec, spec,
                                                     monkeypatch):
    token = new_job_token()
    target = tworker.ServingWorker(cohort="c0", wid=1, num_pages=64,
                                   page_size=2, **CPU).start()
    fired = chaos_spec(spec)
    # a failed chunk answers a retryable 503: one retry, then fall back
    monkeypatch.setenv("HVDTPU_SERVING_MIGRATE_RETRIES", "1")
    monkeypatch.setenv("HVDTPU_SERVING_MIGRATE_DEADLINE", "1")
    try:
        port = target.serve_http(addr="127.0.0.1", token=token)
        src = tsched.Scheduler(tmodel.ToyLM(**CPU), max_batch_tokens=32,
                               queue_limit=8, num_pages=6, page_size=2,
                               watermark=1)
        src.migrator = tmig.Migrator(
            "c0", 0, token=token, peers=[(1, f"http://127.0.0.1:{port}")])
        reqs = [([i + 1, 2], 5) for i in range(4)]
        results = [src.submit(tsched.Request(f"c{i}", p, n))
                   for i, (p, n) in enumerate(reqs)]
        _drive(src, results)
        assert fired() and all(f == spec.split(":") for f in fired())
        assert src.migrated_out == 0
        assert src.migrate_failed > 0 and src.preemptions > 0
        assert target.scheduler.migrated_in == 0
        for (p, n), r in zip(reqs, results):
            assert r.tokens(timeout=5) == ORACLE.reference_completion(p, n)
    finally:
        target.stop()


class _SlowLM(tmodel.ToyLM):
    """A per-step delay, so that streams overlap."""

    def __init__(self, delay_s=0.003, **kw):
        super().__init__(**kw)
        self.delay_s = delay_s

    def decode(self, contexts):
        time.sleep(self.delay_s)
        return super().decode(contexts)


class _JaxSlowLM(jmodel.ToyLM):
    def decode(self, contexts):
        time.sleep(0.003)
        return super().decode(contexts)


def _slow_worker(pkg, wid, **kw):
    if pkg == "port":
        return tworker.ServingWorker(_SlowLM(**CPU), cohort="c0", wid=wid,
                                     **kw)
    return jworker.ServingWorker(_JaxSlowLM(), cohort="c0", wid=wid, **kw)


@pytest.mark.parametrize("src,dst", [("port", "port"), ("port", "jax"),
                                     ("jax", "port")])
def test_two_workers_shed_by_migration_with_no_recompute(src, dst):
    token = new_job_token()
    kv = KVStoreServer(job_token=token, addr="127.0.0.1")
    kv_port = kv.start()
    # 8 pages at watermark 2: one 17-token stream needs 5 of the 6 usable
    # pages, so overlapping streams must shed one.
    w0 = _slow_worker(src, 0, num_pages=8, page_size=4, watermark=2,
                      max_batch_tokens=64)
    w1 = _slow_worker(dst, 1, num_pages=128, page_size=4,
                      max_batch_tokens=64)
    try:
        for w in (w0, w1):
            port = w.serve_http(addr="127.0.0.1", token=token)
            w.register("127.0.0.1", kv_port, token,
                       advertise=f"127.0.0.1:{port}")
        router = Router(kv=("127.0.0.1", kv_port, token))
        assert router.refresh_from_kv(["c0"]) == {"c0": 2}
        specs = [([i + 1, 3, 5], 14) for i in range(6)]
        out = [None] * len(specs)

        def gen(i, p, n):
            out[i] = router.generate({"id": f"e2e-{i}", "prompt": p,
                                      "max_new_tokens": n})

        threads = [threading.Thread(target=gen, args=(i, p, n))
                   for i, (p, n) in enumerate(specs)]
        for t in threads:
            t.start()
        # the loops start once every request is queued: the streams
        # overlap on worker 0 however loaded the machine is
        deadline = time.monotonic() + 60
        while sum(w.scheduler.stats()["queue_depth"]
                  for w in (w0, w1)) < len(specs):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        w0.start()
        w1.start()
        for t in threads:
            t.join(timeout=60)
        for i, (p, n) in enumerate(specs):
            assert out[i][0] == 200, (i, out[i])
            assert out[i][1]["tokens"] == ORACLE.reference_completion(p, n)
        assert w0.scheduler.migrated_out >= 1
        assert w1.scheduler.migrated_in == w0.scheduler.migrated_out
        assert w0.scheduler.preemptions == w1.scheduler.preemptions == 0
        assert router.handoffs >= 1 and router.rerouted == 0
    finally:
        w0.stop()
        w1.stop()
        kv.stop()


def test_a_drain_migrates_a_direct_clients_stream_mid_flight():
    token = new_job_token()
    kv = KVStoreServer(job_token=token, addr="127.0.0.1")
    kv_port = kv.start()
    w0 = tworker.ServingWorker(_SlowLM(0.05, **CPU), cohort="c0", wid=0,
                               num_pages=64, page_size=4).start()
    w1 = tworker.ServingWorker(cohort="c0", wid=1, num_pages=128,
                               page_size=4, **CPU).start()
    try:
        ports = [w.serve_http(addr="127.0.0.1", token=token)
                 for w in (w0, w1)]
        for w, port in zip((w0, w1), ports):
            w.register("127.0.0.1", kv_port, token,
                       advertise=f"127.0.0.1:{port}")
        out = {}

        def gen():
            out["r"] = _post(ports[0], "/v1/generate",
                             {"id": "direct", "prompt": [2, 6],
                              "max_new_tokens": 40}, token=token)

        t = threading.Thread(target=gen)
        t.start()
        deadline = time.monotonic() + 30
        while w0.scheduler.stats()["tokens_out"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        status, body = _post(ports[0], "/v1/serving/drain", {},
                             token=token)
        assert status == 200 and body["draining"]
        t.join(timeout=60)
        status, body = out["r"]
        assert status == 200, out["r"]
        assert body["tokens"] == ORACLE.reference_completion([2, 6], 40)
        assert (body["id"], body["worker"]) == ("direct", "c0.1")
        assert w0.scheduler.migrated_out == 1
        assert w1.scheduler.migrated_in == 1
        assert w0.scheduler.preemptions == w1.scheduler.preemptions == 0
    finally:
        w0.stop()
        w1.stop()
        kv.stop()

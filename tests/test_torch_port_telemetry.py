"""The port's metrics plane against the JAX package's, on the CPU.

Everything compared here is exact: both packages run the same pure-Python
arithmetic on the same inputs, so snapshots (less their time stamps),
Prometheus text, roll-ups and CLI output are equal, not close. The
launcher side is the port's own KV store: a rank's pusher feeds it, and
its token-gated ``/metrics``, ``/metrics.json`` and ``/clock`` routes
serve the roll-up.
"""

import io
import json
import os
import re
import sys
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.telemetry import aggregate as jagg
from horovod_tpu.telemetry import cli as jcli
from horovod_tpu.telemetry import core as jcore
from horovod_tpu.telemetry import exposition as jexp
from horovod_tpu_torch.runner import http_server
from horovod_tpu_torch.telemetry import aggregate as tagg
from horovod_tpu_torch.telemetry import cli as tcli
from horovod_tpu_torch.telemetry import core as tcore
from horovod_tpu_torch.telemetry import exposition as texp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive(core, seed=0):
    """One sequence of metric operations on a fresh registry of ``core``,
    drawn from ``seed``: counters with and without labels, a gauge, and
    latency and byte histograms (values on bucket edges included)."""
    reg = core.Registry()
    rng = np.random.RandomState(seed)
    ops = reg.counter("hvd_test_ops_total", "Operations", ("kind",))
    plain = reg.counter("hvd_test_plain_total", "No labels")
    depth = reg.gauge("hvd_test_depth", "A gauge")
    lat = reg.histogram("hvd_test_seconds", "Latency", ("kind",))
    size = reg.histogram("hvd_test_bytes", "Bytes",
                         buckets=core.BYTES_BUCKETS)
    esc = reg.gauge("hvd_test_escape", 'Labels with "quotes"', ("path",))
    for i in range(200):
        kind = ("allreduce", "allgather", "broadcast")[rng.randint(3)]
        ops.labels(kind=kind).inc(int(rng.randint(1, 4)))
        plain.inc()
        depth.set(float(rng.randint(0, 64)))
        lat.labels(kind=kind).observe(float(10 ** rng.uniform(-6, 2)))
        size.observe(float(2 ** rng.randint(4, 32)))
    lat.labels(kind="edge").observe(core.SECONDS_BUCKETS[3])
    depth.dec(2)
    esc.labels(path='a\\b"c\nd').set(1.5)
    return reg


def _strip_ts(snap):
    return {k: v for k, v in snap.items() if k != "ts"}


def test_same_operations_give_equal_snapshots_and_exposition():
    assert tcore.SECONDS_BUCKETS == jcore.SECONDS_BUCKETS
    assert tcore.BYTES_BUCKETS == jcore.BYTES_BUCKETS
    assert tcore.log_buckets(0.5, 100, 3) == jcore.log_buckets(0.5, 100, 3)
    for bad in ((0, 1), (1, 2, 1.0)):
        for core in (tcore, jcore):
            with pytest.raises(ValueError):
                core.log_buckets(*bad)
    tsnap, jsnap = _drive(tcore).snapshot(), _drive(jcore).snapshot()
    assert _strip_ts(tsnap) == _strip_ts(jsnap)
    text = texp.render_prometheus(tsnap)
    assert text == jexp.render_prometheus(jsnap)
    assert texp.parse_prometheus(text) == jexp.parse_prometheus(text)
    assert 'path="a\\\\b\\"c\\nd"' in text
    tsnap["ts"] = jsnap["ts"]
    assert texp.render_json(tsnap, indent=1) == \
        jexp.render_json(jsnap, indent=1)
    assert texp.PROMETHEUS_CONTENT_TYPE == jexp.PROMETHEUS_CONTENT_TYPE


def test_schema_conflicts_and_payload_bytes_match():
    for core in (tcore, jcore):
        reg = core.Registry()
        reg.counter("hvd_x_total", labelnames=("a",))
        with pytest.raises(ValueError, match="re-registered"):
            reg.gauge("hvd_x_total", labelnames=("a",))
        with pytest.raises(ValueError, match="expects labels"):
            reg.counter("hvd_x_total", labelnames=("a",)).labels(b=1)
    t = torch.zeros(3, 5, dtype=torch.bfloat16)
    assert tcore.payload_nbytes([t, [t, "x"]]) == 60
    a = np.zeros((3, 5), np.float32)
    assert tcore.payload_nbytes([a, None]) == \
        jcore.payload_nbytes([a, None]) == 60


@pytest.mark.parametrize("on", [False, True])
def test_factories_and_snapshot_follow_the_knob(on, monkeypatch):
    monkeypatch.setenv("HOROVOD_TPU_METRICS", "1" if on else "0")
    snaps = []
    for core in (tcore, jcore):
        monkeypatch.setattr(core, "_ENABLED", None)
        monkeypatch.setattr(core, "_FAMILIES", {}, raising=False)
        monkeypatch.setattr(core, "_REGISTRY", core.Registry()
                            if core is jcore else core._REGISTRY)
        c = core.counter("hvd_knob_total", "k", ("kind",))
        assert (c is core.NULL) is (not on)
        c.labels(kind="a").inc(3)
        core.histogram("hvd_knob_seconds").observe(0.5)
        snaps.append(_strip_ts(core.snapshot()))
    assert snaps[0] == snaps[1]
    assert bool(snaps[0]["families"]) is on


def _rank_snapshots(core):
    return {r: json.loads(jexp.render_json(_drive(core, seed=r).snapshot()))
            for r in range(3)}


def test_aggregate_of_rank_snapshots_equals_the_jax_package_s():
    tsnaps, jsnaps = _rank_snapshots(tcore), _rank_snapshots(jcore)
    tagged = tagg.aggregate(tsnaps)
    assert tagged["ranks"] == 3
    assert _strip_ts(tagged) == _strip_ts(jagg.aggregate(jsnaps))
    assert texp.render_prometheus(tagged) == \
        jexp.render_prometheus(jagg.aggregate(tsnaps))
    raw = {str(r): json.dumps(s) for r, s in tsnaps.items()}
    raw["junk"] = b"{not json"
    assert tagg.parse_rank_snapshots(raw) == jagg.parse_rank_snapshots(raw)
    buckets = tsnaps[0]["families"]["hvd_test_seconds"]["samples"][0][
        "buckets"]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert tagg.quantile_from_buckets(buckets, q) == \
            jagg.quantile_from_buckets(buckets, q)
    assert tagg.quantile_from_buckets([], 0.5) == 0.0


def _get(port, path, token):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if token:
        req.add_header(http_server.AUTH_HEADER, token)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.headers.get("Content-Type"), resp.read()


@pytest.fixture
def server():
    srv = http_server.KVStoreServer(job_token="tok", addr="127.0.0.1")
    srv.start()
    yield srv
    srv.stop()


def test_pusher_to_metrics_round_trip(server, monkeypatch):
    # Two ranks' pushers feed the launcher's store; /metrics serves the
    # launcher's own registry, then the roll-up of both ranks.
    monkeypatch.setenv("HOROVOD_TPU_METRICS", "1")
    monkeypatch.setattr(tcore, "_ENABLED", None)
    monkeypatch.setattr(tcore, "_FAMILIES", {})
    tcore.counter("hvd_local_total", "launcher-side").inc(7)
    pushers = []
    for rank in range(2):
        snap = json.loads(jexp.render_json(
            _drive(tcore, seed=rank).snapshot()))
        tagg.push_snapshot("127.0.0.1", server.port, "tok", rank, snap)
        pushers.append(snap)
    pusher = tagg.MetricsPusher("127.0.0.1", server.port, "tok", 5,
                                interval_s=0.5).start()
    pusher.stop()   # the final push of the process registry
    assert server.scope_keys(tagg.METRICS_SCOPE) == ["0", "1", "5"]
    ctype, body = _get(server.port, "/metrics", "tok")
    assert ctype == texp.PROMETHEUS_CONTENT_TYPE
    text = body.decode()
    snaps = tagg.store_snapshots(server)
    assert text == (texp.render_prometheus(tcore.snapshot())
                    + texp.render_prometheus(tagg.aggregate(snaps)))
    parsed = texp.parse_prometheus(text)
    assert parsed["hvd_local_total"][()] == 7.0
    assert ('stat="sum"',) in {k[-1:] for k in
                               parsed["hvd_test_plain_total_cluster"]}
    ctype, body = _get(server.port, "/metrics.json", "tok")
    payload = json.loads(body)
    assert ctype == "application/json"
    assert set(payload) == {"local", "ranks"}
    assert payload["ranks"]["1"]["families"] == pushers[1]["families"]
    t0 = time.time()
    _, body = _get(server.port, "/clock", "tok")
    assert abs(float(body) - t0) < 5.0
    for path in ("/metrics", "/metrics.json", "/clock"):
        with pytest.raises(urllib.error.HTTPError, match="403"):
            _get(server.port, path, "")


def test_init_pushes_and_shutdown_dumps(server, monkeypatch, tmp_path):
    # A process with the launcher's rendezvous and metrics on starts the
    # pusher at init(); shutdown() pushes once more and writes the dump.
    dump = tmp_path / "dump.json"
    for k, v in {"HOROVOD_TPU_METRICS": "1",
                 "HVDTPU_RENDEZVOUS_ADDR": "127.0.0.1",
                 "HVDTPU_RENDEZVOUS_PORT": str(server.port),
                 "HVDTPU_JOB_TOKEN": "tok",
                 "HVDTPU_METRICS_PUSH_INTERVAL": "60",
                 "HVDTPU_METRICS_DUMP": str(dump)}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tcore, "_ENABLED", None)
    monkeypatch.setattr(tcore, "_FAMILIES", {})
    thvd.shutdown()
    thvd.init(device="cpu")
    try:
        from horovod_tpu_torch import basics
        assert basics.runtime().metrics_pusher is not None
        thvd.allreduce(torch.ones(4), name="pushed")
        snap = thvd.metrics_snapshot()
    finally:
        thvd.shutdown()
    assert snap["rank"] == 0 and snap["mode"] == "single"
    ops = snap["families"]["hvd_coordinator_ops_total"]["samples"]
    assert ops == [{"labels": {"kind": "allreduce"}, "value": 1.0}]
    pushed = tagg.store_snapshots(server)[0]
    assert "hvd_coordinator_ops_total" in pushed["families"]
    dumped = json.loads(dump.read_text())
    assert dumped["families"]["hvd_coordinator_ops_total"] == \
        snap["families"]["hvd_coordinator_ops_total"]


def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_dump_and_diff_equal_the_jax_package_s(tmp_path, server):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(jexp.render_json(_drive(tcore, 0).snapshot()))
    b.write_text(jexp.render_json(_drive(tcore, 1).snapshot()))
    for argv in (["dump", str(a)], ["dump", str(a), "--format", "json"],
                 ["diff", str(a), str(b)]):
        assert _cli(tcli.main, argv) == _cli(jcli.main, argv)
    assert _cli(tcli.main, ["dump"])[0] == 2
    server.put(tagg.METRICS_SCOPE, "0", a.read_text())
    url = ["dump", "--url", f"http://127.0.0.1:{server.port}", "--token",
           "tok"]
    rc, out = _cli(tcli.main, url)
    assert rc == 0 and "hvd_test_ops_total_cluster" in out
    assert (rc, out) == _cli(jcli.main, url)


def test_archive_snapshot_writes_the_knob_s_path(tmp_path, monkeypatch):
    from horovod_tpu_torch import telemetry
    path = tmp_path / "bench.json"
    monkeypatch.setenv("HVDTPU_METRICS_SNAPSHOT", str(path))
    snap = _drive(tcore).snapshot()
    assert telemetry.archive_snapshot(snap) == str(path)
    assert json.loads(path.read_text()) == json.loads(
        jexp.render_json(snap))


def test_cli_runs_as_a_module(tmp_path):
    import subprocess
    a = tmp_path / "a.json"
    a.write_text(jexp.render_json(_drive(tcore, 0).snapshot()))
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.telemetry.cli", "dump",
         str(a)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == jexp.render_prometheus(json.loads(a.read_text()))


# Families of the JAX package's modules whose port registers none yet, and
# why (none left since control-plane HA was ported). Everything else a
# ported module's counterpart registers, the port registers under the same
# name.
NOT_YET = {}
_FAMILY = re.compile(r"\b(?:counter|gauge|histogram)\(\s*\"(hvd_[a-z0-9_]+)\"")


def _families(path):
    with open(path) as f:
        return set(_FAMILY.findall(f.read()))


def _module_pairs():
    pairs = []
    root = os.path.join(REPO, "horovod_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            port = os.path.join(d, f)
            ref = os.path.join(REPO, "horovod_tpu",
                               os.path.relpath(port, root))
            if f.endswith(".py") and os.path.exists(ref):
                pairs.append((ref, port))
    pairs.append((os.path.join(REPO, "horovod_tpu/backend/xla_global.py"),
                  os.path.join(root, "backend/nccl_global.py")))
    return sorted(pairs)


def test_ported_modules_register_the_jax_package_s_families():
    pairs = _module_pairs()
    rels = {os.path.relpath(p, REPO) for _, p in pairs}
    for mod in ("coordinator.py", "ops/zero.py", "basics.py",
                "ops/sparse.py", "compression/__init__.py", "guardian.py",
                "runner/http_client.py", "tracing/recorder.py",
                "tracing/analyze.py"):
        assert f"horovod_tpu_torch/{mod}" in rels, mod
    missing, seen = {}, set()
    for ref, port in pairs:
        want, got = _families(ref), _families(port)
        seen |= want
        gap = want - got - set(NOT_YET)
        if gap:
            missing[os.path.relpath(port, REPO)] = sorted(gap)
    assert missing == {}
    # The written exceptions are real gaps, not stale entries.
    assert set(NOT_YET) <= seen
    assert len(seen) >= 40

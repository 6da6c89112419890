"""The port's trace plane against the JAX package's, on the CPU.

- Shards are interchangeable: the port's recorder writes the JAX
  package's records (the same keys per record kind and in the meta
  header), and each package's ``merge`` and ``analyze`` give equal output
  on either package's shards (exactly: the same pure-Python arithmetic).
- Synthetic skewed shards with a known straggler give equal reports.
- The clock offset against the port's ``/clock`` route recovers an
  injected skew to within the round trip of its best sample.
- A 2-rank gloo-delegated launcher job records correlated spans.
- The watchdog's abort and the consistency check's mismatch dump the
  flight recorder to a postmortem shard; the disabled plane writes no
  file.
"""

import io
import json
import os
import subprocess
import sys
import time
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu import tracing as jtracing
from horovod_tpu.tracing import analyze as janalyze
from horovod_tpu.tracing import cli as jcli
from horovod_tpu.tracing import clock as jclock
from horovod_tpu.tracing import merge as jmerge
from horovod_tpu.tracing import recorder as jrec
from horovod_tpu_torch import tracing as ttracing
from horovod_tpu_torch.runner import http_server
from horovod_tpu_torch.tracing import analyze as tanalyze
from horovod_tpu_torch.tracing import cli as tcli
from horovod_tpu_torch.tracing import clock as tclock
from horovod_tpu_torch.tracing import merge as tmerge
from horovod_tpu_torch.tracing import recorder as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_tracing_worker.py")


class _Entry:
    """What the tracer reads of a submission: name, kind, payload (the
    port's ``tensors``, the JAX package's ``arrays``)."""

    def __init__(self, name, kind, data):
        self.name, self.kind = name, kind
        self.tensors = [torch.as_tensor(d) for d in data]
        self.arrays = list(data)


def _record(rec_mod, path, rank, size, steps=3):
    """A shard of ``steps`` steps of two collectives and an event,
    written by ``rec_mod``'s Tracer with a flight ring; the postmortem is
    dumped next to it."""
    meta = {"e": "meta", "kind": "shard", "rank": rank, "size": size,
            "ver": 0, "pid": os.getpid(), "off": 0.0, "rtt": None,
            "host": "h", "t": time.time()}
    tracer = rec_mod.Tracer(rank, size, 0,
                            shard_writer=rec_mod.ShardWriter(str(path),
                                                             meta),
                            flight=rec_mod.FlightRecorder(64),
                            trace_dir=str(path.parent))
    data = [np.ones((4, 8), np.float32)]
    for _ in range(steps):
        for name, kind in (("grad.w", "allreduce"), ("gather", "allgather")):
            e = _Entry(name, kind, data)
            tracer.on_submit(e)
            tracer.event("neg", name, o=e.corr)
            tracer.on_complete(e, ok=name != "gather" or rank == 0)
    post = tracer.dump_postmortem("test")
    tracer.close()
    return post


def _shards(tmp_path, rec_mod, tag, size=2):
    d = tmp_path / tag
    d.mkdir()
    for r in range(size):
        _record(rec_mod, d / f"shard.r{r}.p1.v0.jsonl", r, size)
    return d


def _keys_by_kind(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            kind = rec["e"] if rec["e"] != "fin" else \
                "fin" + ("_err" if "err" in rec else "")
            out.setdefault(kind, set()).update(rec)
    return out


def test_the_port_writes_the_jax_package_s_records(tmp_path):
    tdir, jdir = _shards(tmp_path, trec, "port"), _shards(tmp_path, jrec,
                                                          "jax")
    for name in ("shard.r0.p1.v0.jsonl", "shard.r1.p1.v0.jsonl"):
        assert _keys_by_kind(tdir / name) == _keys_by_kind(jdir / name)
    tkeys = _keys_by_kind(tdir / "shard.r1.p1.v0.jsonl")
    assert tkeys["sub"] == {"e", "t", "n", "k", "o", "b"}
    assert tkeys["fin_err"] == {"e", "t", "n", "o", "err"}
    assert tkeys["ev"] == {"e", "t", "cat", "n", "o"}
    post = sorted(p.name for p in tdir.iterdir()
                  if p.name.startswith("postmortem."))
    assert post == sorted(p.name for p in jdir.iterdir()
                          if p.name.startswith("postmortem."))
    assert trec.DEFAULT_FLIGHT_EVENTS == jrec.DEFAULT_FLIGHT_EVENTS
    assert trec.trace_scope(3) == jrec.trace_scope(3) == "trace.3"


def _strip_paths(shards):
    return [{k: v for k, v in s.items() if k != "path"} for s in shards]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_merge_and_analyze_are_equal_on_either_package_s_shards(
        tmp_path, writer):
    d = _shards(tmp_path, trec if writer == "port" else jrec, writer)
    tsh, jsh = tmerge.load_paths([str(d)]), jmerge.load_paths([str(d)])
    assert _strip_paths(tsh) == _strip_paths(jsh)
    assert len(tsh) == 4   # two shards, two postmortems
    for align in (True, False):
        assert tmerge.merge_shards(tsh, align) == \
            jmerge.merge_shards(jsh, align)
    shards = tmerge.load_paths([str(d)], kinds=(tmerge.SHARD_PREFIX,))
    rep = tanalyze.analyze(shards)
    assert rep == janalyze.analyze(shards)
    assert tanalyze.render_report(rep) == janalyze.render_report(rep)
    assert [len(s["critical_path"]) > 0 for s in rep["steps"]] == [True] * 3
    assert tmerge.bundle_by_rank(tsh) == jmerge.bundle_by_rank(tsh)


def _synthetic(tmp_path, late_rank=2, delay=0.05, size=4, steps=4):
    """Shards written by hand: every rank submits three collectives per
    step, ``late_rank`` ``delay`` seconds after the others; each completes
    1 ms after the last submission. Rank 1's clock runs 20 ms ahead (its
    meta header says so)."""
    d = tmp_path / "skewed"
    d.mkdir()
    for r in range(size):
        off = 0.02 if r == 1 else 0.0
        lines = [{"e": "meta", "kind": "shard", "rank": r, "size": size,
                  "ver": 0, "pid": 1, "off": off, "rtt": 0.0004,
                  "host": "h", "t": 100.0}]
        for s in range(steps):
            for i, name in enumerate(("grad.a", "grad.b", "grad.c")):
                t = 100.0 + s * 0.5 + i * 0.1
                sub = t + (delay if r == late_rank else 0.0)
                lines.append({"e": "sub", "t": sub + off, "n": name,
                              "k": "allreduce", "o": s + 1, "b": 4096})
                lines.append({"e": "fin", "t": t + delay + 0.001 + off,
                              "n": name, "o": s + 1})
        with open(d / f"shard.r{r}.p1.v0.jsonl", "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return d


def test_a_known_straggler_gives_equal_reports(tmp_path, monkeypatch):
    d = _synthetic(tmp_path)
    shards = tmerge.load_paths([str(d)])
    rep = tanalyze.analyze(shards)
    assert rep == janalyze.analyze(shards)
    text = tanalyze.render_report(rep)
    assert text == janalyze.render_report(rep)
    st = rep["stragglers"]
    assert st[2]["gated"] == 12 and all(st[r]["gated"] == 0
                                        for r in (0, 1, 3))
    assert abs(st[2]["delay_s"] - 12 * 0.05) < 1e-6
    assert all(s["gating_rank"] == 2 for s in rep["steps"])
    # Without the alignment rank 1's fast clock fabricates the skew.
    unaligned = tanalyze.analyze(shards, align=False)
    assert unaligned == janalyze.analyze(shards, align=False)
    from horovod_tpu_torch.telemetry import core as tcore
    monkeypatch.setattr(tcore, "_ENABLED", True)
    monkeypatch.setattr(tcore, "_FAMILIES", {})
    gauge = tanalyze.publish_metrics(rep)
    assert gauge.labels(rank="2").value == st[2]["delay_s"]
    assert gauge.labels(rank="0").value == 0.0


def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_equals_the_jax_package_s(tmp_path):
    d = _synthetic(tmp_path)
    assert _cli(tcli.main, ["report", str(d)]) == \
        _cli(jcli.main, ["report", str(d)])
    assert _cli(tcli.main, ["report", str(d), "--json"]) == \
        _cli(jcli.main, ["report", str(d), "--json"])
    outs = {}
    for tag, main in (("port", tcli.main), ("jax", jcli.main)):
        path = tmp_path / f"{tag}.json"
        rc, _ = _cli(main, ["merge", str(d), "--out", str(path)])
        assert rc == 0
        outs[tag] = json.loads(path.read_text())
    assert outs["port"] == outs["jax"]
    flows = [e for e in outs["port"]["traceEvents"] if e["ph"] == "s"]
    assert len(flows) == 12   # one per collective
    p = _shards(tmp_path, trec, "post")
    assert _cli(tcli.main, ["postmortem", str(p)]) == \
        _cli(jcli.main, ["postmortem", str(p)])
    assert _cli(tcli.main, ["report", str(tmp_path / "none")])[0] == 1
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tracing.cli", "report",
         str(d)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == _cli(jcli.main, ["report", str(d)])[1]


@pytest.fixture
def server():
    srv = http_server.KVStoreServer(job_token="tok", addr="127.0.0.1")
    srv.start()
    yield srv
    srv.stop()


def test_clock_offset_with_injected_skew(server, monkeypatch):
    # This process's clock made 250 ms fast against the launcher's
    # /clock: both packages' estimates find it within the best sample's
    # round trip.
    skew = 0.25
    real = time.time
    fast = types.SimpleNamespace(time=lambda: real() + skew)
    for mod in (tclock, jclock):
        monkeypatch.setattr(mod, "time", fast)
        off, rtt = mod.estimate_offset("127.0.0.1", server.port, "tok")
        assert rtt is not None and abs(off - skew) <= rtt / 2 + 1e-3, \
            (off, rtt)
    assert tclock.estimate_offset("127.0.0.1", server.port, "bad") == \
        (0.0, None)


def test_collect_shards_from_the_port_s_store(tmp_path, server):
    d = _shards(tmp_path, trec, "pushed")
    for r in range(2):
        server.put("trace.0", f"shard.{r}",
                   (d / f"shard.r{r}.p1.v0.jsonl").read_bytes())
    out = tmp_path / "collected"
    got = tmerge.collect_shards("127.0.0.1", server.port, "tok", 0,
                                str(out), max_ranks=4)
    assert [os.path.basename(p) for p in got] == \
        ["shard.r0.v0.jsonl", "shard.r1.v0.jsonl"]
    jgot = jmerge.collect_shards("127.0.0.1", server.port, "tok", 0,
                                 str(tmp_path / "jcollected"), max_ranks=4)
    assert [open(a, "rb").read() for a in got] == \
        [open(b, "rb").read() for b in jgot]


def test_a_gloo_delegated_job_records_correlated_spans(tmp_path):
    import torch_port_launch
    torch_port_launch.build_port_core()
    traces = tmp_path / "traces"
    job = _run_tracing_job(tmp_path / "job", traces)
    assert job["rc"] == 0, job["log"][-4000:]
    shards = tmerge.load_paths([str(traces)], kinds=(tmerge.SHARD_PREFIX,))
    assert sorted(s["meta"]["rank"] for s in shards) == [0, 1]
    for s in shards:
        spans = tmerge.collective_spans(s)
        names = {n for n, _ in spans}
        assert {"grad.a", "grad.b", "gather"} <= names
        for (name, occ), sp in spans.items():
            assert sp["sub"] is not None and sp["fin"] is not None, name
            assert not sp["err"] and occ >= 1
        negs = [r for r in s["events"] if r.get("cat") == "neg"]
        assert {r["n"] for r in negs} >= {"grad.a", "grad.b", "gather"}
    keys = [set(tmerge.collective_spans(s)) for s in shards]
    assert keys[0] == keys[1]
    assert {("grad.a", o) for o in (1, 2, 3)} <= keys[0]
    trace = tmerge.merge_shards(shards)
    assert trace == jmerge.merge_shards(shards)
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    assert names == {"rank 0", "rank 1"}
    flows = [e for e in trace["traceEvents"] if e["ph"] == "s"]
    assert len(flows) == len(keys[0])
    rep = tanalyze.analyze(shards)
    assert rep == janalyze.analyze(shards)
    assert rep["collectives"] == len(keys[0])


def _run_tracing_job(out, traces, size=2):
    from test_torch_port_guardian import _env
    out.mkdir(parents=True, exist_ok=True)
    env = _env({"HVDTPU_TRACE": "1", "HVDTPU_TRACE_DIR": str(traces),
                "HOROVOD_TPU_METRICS": "1"})
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(size), "--start-timeout", "120", sys.executable, WORKER,
         "cpu", str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    return {"rc": proc.returncode, "log": proc.stdout + proc.stderr}


@pytest.fixture
def port():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def test_watchdog_abort_dumps_the_flight_recorder(port, monkeypatch,
                                                  tmp_path):
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.coordinator import Coordinator, TensorEntry
    from horovod_tpu_torch.exceptions import CollectiveAbortError
    monkeypatch.setenv("HVDTPU_COLLECTIVE_TIMEOUT", "3")
    monkeypatch.setenv("HVDTPU_TRACE_DIR", str(tmp_path))
    active = ttracing.active()
    coord = Coordinator(basics.runtime())
    try:
        assert coord._tracer is not None and coord._tracer._writer is None
        coord._running = True   # driven by hand: no cycle thread
        e = TensorEntry("ghost", "allreduce", [torch.ones(2)],
                        thvd.global_process_set)
        coord.submit(e)
        assert e.corr == 1
        coord._check_stalls(now=e.enqueue_time + 3.5)
        with pytest.raises(CollectiveAbortError, match="ghost"):
            e.handle.wait(0)
    finally:
        ttracing._set_active(active)
    dumps = list(tmp_path.glob("postmortem.r0.*.jsonl"))
    assert len(dumps) == 1
    (shard,) = tmerge.load_paths([str(tmp_path)])
    assert shard == {**jmerge.load_shard(str(dumps[0])),
                     "path": str(dumps[0])}
    assert shard["meta"]["kind"] == "postmortem"
    assert shard["meta"]["reason"] == "collective_abort"
    evs = [(r["e"], r.get("cat"), r["n"]) for r in shard["events"]]
    assert ("sub", None, "ghost") in evs
    assert ("ev", "guardian", "abort") in evs


def test_a_mismatch_dumps_the_flight_recorder(port, monkeypatch, tmp_path):
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.coordinator import Coordinator, TensorEntry
    from horovod_tpu_torch.exceptions import CollectiveMismatchError
    monkeypatch.setenv("HVDTPU_TRACE_DIR", str(tmp_path))
    active = ttracing.active()
    coord = Coordinator(basics.runtime())
    try:
        e = TensorEntry("bad", "allreduce", [torch.ones(2)],
                        thvd.global_process_set)
        e.guard_token = ("bad", 1, "digest")

        class Guard:
            def verify(self, entry):
                raise CollectiveMismatchError("rank 1 sent float16")
        coord._guardian = Guard()
        assert coord._verify_consistency([e]) == []
        with pytest.raises(CollectiveMismatchError):
            e.handle.wait(0)
    finally:
        ttracing._set_active(active)
    (shard,) = tmerge.load_paths([str(tmp_path)])
    assert shard["meta"]["reason"] == "collective_mismatch"
    evs = [(r["e"], r.get("cat"), r["n"], r.get("err"))
           for r in shard["events"]]
    assert ("ev", "guardian", "mismatch", None) in evs
    # The failed entry's completion follows the dump, flagged.
    assert {"e": "fin", "n": "bad", "o": 0, "err": 1} in [
        {k: v for k, v in r.items() if k != "t"}
        for r in coord._tracer._flight.snapshot()]


@pytest.mark.parametrize("trace,flight", [("0", "0"), ("0", "1"),
                                          ("1", "1")])
def test_the_disabled_plane_writes_no_file(trace, flight, monkeypatch,
                                           tmp_path):
    monkeypatch.setenv("HVDTPU_TRACE", trace)
    monkeypatch.setenv("HVDTPU_FLIGHT_RECORDER", flight)
    monkeypatch.setenv("HVDTPU_TRACE_DIR", str(tmp_path / "traces"))
    thvd.shutdown()
    rt = thvd.init(device="cpu")
    try:
        tracer = rt.coordinator._tracer
        assert (tracer is None) == (trace == "0" and flight == "0")
        assert ttracing.active() is tracer
        thvd.allreduce(torch.ones(3), name="t")
        ttracing.trace_event("elastic", "hosts_updated")
        if tracer is not None:
            assert len(tracer._flight) == 3   # sub, fin, the event
    finally:
        thvd.shutdown()
    assert ttracing.active() is None and rt.tracer is None
    files = sorted(os.listdir(tmp_path / "traces")) \
        if (tmp_path / "traces").exists() else []
    if trace == "1":
        (name,) = files
        (shard,) = tmerge.load_paths([str(tmp_path / "traces")])
        assert [r["e"] for r in shard["events"]] == ["sub", "fin", "ev"]
    else:
        assert files == []


def test_make_tracer_follows_the_jax_package_s_knobs(monkeypatch):
    rt = types.SimpleNamespace(
        topology=types.SimpleNamespace(rank=1, size=4))
    for env, want in (({}, (None, 4096)),
                      ({"HVDTPU_FLIGHT_RECORDER_EVENTS": "8"}, (None, 8)),
                      ({"HVDTPU_FLIGHT_RECORDER": "0"}, None)):
        for k in ("HVDTPU_FLIGHT_RECORDER_EVENTS", "HVDTPU_FLIGHT_RECORDER",
                  "HVDTPU_TRACE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = []
        for mod in (ttracing, jtracing):
            tr = mod.make_tracer(rt)
            got.append(None if tr is None else
                       (tr._writer, tr._flight._ring.maxlen))
            assert (tr.rank, tr.size) == (1, 4) if tr else True
            mod._set_active(None)
        assert got == [want, want]

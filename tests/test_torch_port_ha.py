"""The port's control-plane HA (``runner/journal.py``, ``runner/standby.py``,
``analysis/protocol/journal_spec.py``, the term fence of
``runner/http_server.py`` and the failover of ``runner/http_client.py``)
against the JAX package's: the same journal entries give the same state
and ``state_digest``; each package replays the other's journal directory,
a torn final line included, and recovers a writer on it; the 409 fence
bodies are identical; the KV client fails over along the endpoint list.
Then two CPU launcher jobs of the port's elastic worker: a primary killed
by ``driver:kill`` whose warm standby promotes at term 2 and adopts the
running cohort (no respawn, no reset; the counterpart of
tests/test_chaos_matrix.py:637), and a partitioned primary that the
standby replaces and that, healed, is fenced and demotes (:764)."""

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from horovod_tpu.analysis.protocol import journal_spec as jspec
from horovod_tpu.runner import journal as jjournal
from horovod_tpu_torch.analysis.protocol import journal_spec as tspec
from horovod_tpu_torch.runner import http_client as thttp
from horovod_tpu_torch.runner import journal as tjournal

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
WORKER = os.path.join(HERE, "torch_port_elastic_worker.py")
JOB_TIMEOUT = 150

import torch_port_launch  # noqa: E402


def _entries(seed, count=40):
    """A seeded mix of every journal op the driver writes."""
    rng = np.random.RandomState(seed)
    out = []
    version = -1
    for i in range(count):
        op = rng.choice(["membership", "fail_count", "kv_put", "kv_delete",
                         "kv_clear", "term"], p=[.2, .15, .35, .15, .05,
                                                 .1])
        if op == "membership":
            version += 1
            wids = [f"h{j}:{rng.randint(4)}" for j in range(rng.randint(
                1, 4))]
            out.append({"op": op, "version": version, "rank_order": wids,
                        "workers": {w: {"host": w.split(":")[0],
                                        "slot": int(w.split(":")[1])}
                                    for w in wids},
                        "resets": int(rng.randint(5)),
                        "assign": {w: f"{r},{len(wids)},0,1,0,1"
                                   for r, w in enumerate(wids)}})
        elif op == "fail_count":
            out.append({"op": op, "host": f"h{rng.randint(3)}",
                        "count": int(rng.randint(1, 4)),
                        "blacklisted": bool(rng.randint(2))})
        elif op in ("kv_put", "kv_delete"):
            rec = {"op": op, "scope": str(rng.choice(
                list(tspec.DURABLE_SCOPES))), "key": f"k{rng.randint(4)}"}
            if op == "kv_put":
                rec["value"] = f"v{i}"
            out.append(rec)
        elif op == "kv_clear":
            out.append({"op": op, "scope": "elastic.state"})
        else:
            out.append({"op": op, "term": int(rng.randint(1, 4))})
    return out


def test_spec_equals_the_jax_package():
    assert tspec.DURABLE_SCOPES == jspec.DURABLE_SCOPES
    assert "torchdist" not in tspec.DURABLE_SCOPES
    for a in range(4):
        for b in range(4):
            assert tspec.term_fences(a, b) == jspec.term_fences(a, b)
    assert tspec.new_state() == jspec.new_state()
    for mod in (tspec, jspec):
        with pytest.raises(mod.JournalError, match="unknown op 'nope'"):
            mod.apply_entry(mod.new_state(), {"op": "nope", "seq": 3})


@pytest.mark.parametrize("seed", range(4))
def test_same_entries_give_the_same_state_and_digest(seed):
    ts, js = tspec.new_state(), jspec.new_state()
    for seq, e in enumerate(_entries(seed), 1):
        e = dict(e, seq=seq, term=1)
        tspec.apply_entry(ts, json.loads(json.dumps(e)))
        jspec.apply_entry(js, json.loads(json.dumps(e)))
        assert tspec.state_digest(ts) == jspec.state_digest(js)
    assert ts == js


def _write(mod, path, entries, snapshot_every):
    j = mod.DriverJournal(str(path), snapshot_every=snapshot_every)
    for e in entries:
        e = dict(e)
        j.record(e.pop("op"), **e)
    digest = j.digest()
    j.close()
    return digest


@pytest.mark.parametrize("writer,reader", [(jjournal, tjournal),
                                           (tjournal, jjournal)])
@pytest.mark.parametrize("snapshot_every", [7, 256])
def test_each_package_replays_the_other_s_journal(tmp_path, writer, reader,
                                                  snapshot_every):
    entries = _entries(11)
    d = tmp_path / "j"
    digest = _write(writer, d, entries[:30], snapshot_every)
    state, seq = reader.replay(str(d))
    assert reader.state_digest(state) == digest
    assert (state, seq) == writer.replay(str(d))
    # A crash mid-append leaves a torn final line: both replay the intact
    # prefix, and a writer of either package truncates it and goes on.
    with open(d / "journal.jsonl", "ab") as f:
        f.write(b'{"seq": 999, "op": "kv_put", "sco')
    assert reader.replay(str(d)) == writer.replay(str(d)) == (state, seq)
    digest2 = _write(reader, d, entries[30:], snapshot_every)
    assert writer.state_digest(writer.replay(str(d))[0]) == digest2
    assert reader.replay(str(d)) == writer.replay(str(d))


def test_replica_follows_the_other_package_s_sync_payloads(tmp_path):
    entries = _entries(5)
    for wmod, rmod in ((jjournal, tjournal), (tjournal, jjournal)):
        j = wmod.DriverJournal(str(tmp_path / wmod.__name__),
                               snapshot_every=6)
        rep = rmod.JournalReplica()
        for i, e in enumerate(entries):
            e = dict(e)
            j.record(e.pop("op"), **e)
            if i % 9 == 0:
                rep.apply_payload(json.loads(json.dumps(
                    j.sync_payload(rep.seq))))
        rep.apply_payload(json.loads(json.dumps(j.sync_payload(rep.seq))))
        assert rep.digest() == j.digest() and rep.seq == j.seq
        j.close()
    err = tjournal.StaleTermError("put a/b", 1, 2)
    assert str(err) == str(jjournal.StaleTermError("put a/b", 1, 2))


def _fence_reply(server_cls, term):
    srv = server_cls(job_token="tok", addr="127.0.0.1")
    port = srv.start()
    srv.set_term(term)
    try:
        out = []
        for method, hdr in (("PUT", "1"), ("DELETE", "0"), ("PUT", "9")):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/s/k", data=b"v"
                if method == "PUT" else None, method=method)
            req.add_header("X-Hvdtpu-Job-Token", "tok")
            req.add_header("X-Hvd-Term", hdr)
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    out.append((resp.status, resp.read(),
                                resp.headers.get("X-Hvd-Term")))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read()),
                            e.headers.get("X-Hvd-Term")))
        return out
    finally:
        srv.stop()


def test_term_fence_replies_equal_the_jax_server():
    from horovod_tpu.runner.http_server import KVStoreServer as J
    from horovod_tpu_torch.runner.http_server import KVStoreServer as T
    got = _fence_reply(T, 3)
    assert got == _fence_reply(J, 3)
    assert got[0] == (409, {"error": "term_fenced", "request_term": 1,
                            "server_term": 3}, "3")
    assert got[2][0] == 200 and got[2][2] == "9"   # a newer term adopted


def test_client_fails_over_and_refuses_a_fenced_write(monkeypatch):
    from horovod_tpu_torch.runner.http_server import KVStoreServer
    from horovod_tpu_torch.telemetry import core as telemetry
    a = KVStoreServer(job_token="t", addr="127.0.0.1")
    b = KVStoreServer(job_token="t", addr="127.0.0.1")
    pa, pb = a.start(), b.start()
    monkeypatch.setenv("HVDTPU_RENDEZVOUS_ADDRS",
                       f"127.0.0.1:{pa},127.0.0.1:{pb}")
    monkeypatch.setenv("HOROVOD_TPU_METRICS", "1")
    telemetry.reset()
    thttp.reset_failover()
    hooks = []
    try:
        assert thttp.parse_endpoints("a:1, b:2") == [("a", 1), ("b", 2)]
        thttp.on_new_primary("t", lambda: hooks.append(1))
        thttp.put_kv("127.0.0.1", pa, "s", "k", "1", token="t")
        assert a.get("s", "k") == b"1"
        a.stop()
        thttp.put_kv("127.0.0.1", pa, "s", "k", "2", token="t",
                     retries=1, backoff=0.001)
        assert b.get("s", "k") == b"2" and hooks == [1]
        assert thttp.active_endpoint("127.0.0.1", pa) == ("127.0.0.1", pb)
        fam = telemetry.snapshot()["families"][
            "hvd_kv_endpoint_failover_total"]
        assert fam["samples"][0]["value"] == 1
        # A writer that only lagged a takeover (a stale adopted term) is
        # fenced once, adopts the store's term from the 409 and succeeds.
        b.set_term(7)
        with thttp._STATE_LOCK:
            thttp._TERM = 2
        thttp.put_kv("127.0.0.1", pb, "s", "k", "4", token="t")
        assert thttp.known_term() == 7 and b.get("s", "k") == b"4"
        assert thttp.probe_term("127.0.0.1", pb, token="t") == 7
        assert issubclass(thttp.TermFencedError, thttp.KVFatalError)
    finally:
        b.stop()
        thttp.reset_failover()
        monkeypatch.delenv("HOROVOD_TPU_METRICS")
        telemetry.reset()


# -- whole jobs -----------------------------------------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job_env(log, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_",
                                "ELASTIC_TEST_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HVDTPU_HEARTBEAT_INTERVAL="0.25")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _wait_for(predicate, timeout, message):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(message)


def _standby(tmp_path, discovery, worker_env, primary, journal_dir="",
             lease_timeout=2.0):
    from horovod_tpu_torch.runner.elastic_driver import ElasticSettings
    from horovod_tpu_torch.runner.job import Settings
    from horovod_tpu_torch.runner.standby import StandbyController
    es = ElasticSettings(
        Settings(num_proc=2, start_timeout=60, env=worker_env,
                 rendezvous_addr="127.0.0.1"),
        discovery_script=discovery, min_np=1, max_np=8,
        discovery_interval=0.2, heartbeat_timeout=10.0,
        journal_dir=journal_dir, standby_addrs="", driver_port=0)
    return StandbyController(es, [sys.executable, WORKER, "epochs",
                                  worker_env["ELASTIC_TEST_LOG"]],
                             primary, advertise="127.0.0.1",
                             lease_interval=0.3, lease_timeout=lease_timeout)


def _check_untouched(log, epochs):
    from test_torch_port_elastic import _parse_log
    text = open(log).read()
    assert len([ln for ln in text.splitlines() if " DONE " in ln]) == 2, text
    entries = _parse_log(log)
    for wid in ("localhost:0", "localhost:1"):
        mine = [e for e in entries if e[0] == wid]
        # Zero process deaths, zero resets: one pid, version 0's size,
        # every epoch once and in order straight through the takeover.
        assert [e[1] for e in mine] == list(range(epochs)), text
        assert len({e[4] for e in mine}) == 1 and \
            {e[3] for e in mine} == {2}, text


def test_driver_kill_promotes_the_standby_and_the_workers_finish(
        tmp_path, monkeypatch):
    from horovod_tpu_torch.runner import journal
    from test_torch_port_elastic import _write_discovery
    torch_port_launch.build_port_core()
    token = "ha-port-token"
    phase = tmp_path / "phase"
    phase.write_text("0")
    discovery = _write_discovery(tmp_path, phase, [["localhost:2"]])
    log = str(tmp_path / "log")
    epochs = 10
    # The primary's kill fires once the worker removed its marker, after
    # epoch 3: mid-job whatever the start-up time.
    marker = tmp_path / "kill.marker"
    marker.write_text("")
    worker_env = {"ELASTIC_TEST_LOG": log, "ELASTIC_TEST_EPOCHS": epochs,
                  "ELASTIC_TEST_EPOCH_SLEEP": 0.2,
                  "ELASTIC_TEST_MARKER": str(marker),
                  "ELASTIC_TEST_MARKER_EPOCH": 3}
    monkeypatch.setenv("HVDTPU_JOB_TOKEN", token)
    thttp.reset_failover()
    p_port = _free_port()
    ctrl = _standby(tmp_path, discovery,
                    {k: str(v) for k, v in worker_env.items()},
                    f"127.0.0.1:{p_port}",
                    journal_dir=str(tmp_path / "standby_journal"))
    journal_dir = tmp_path / "journal"
    env = _job_env(log, HVDTPU_JOB_TOKEN=token,
                   HVDTPU_CHAOS=f"driver:kill:wid=primary:after=20:"
                                f"marker={marker}",
                   **worker_env)
    out = open(tmp_path / "primary.txt", "w")
    primary = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--min-np", "1", "--max-np", "8", "--host-discovery-script",
         discovery, "--journal-dir", str(journal_dir),
         "--standby-endpoints", f"127.0.0.1:{ctrl.port}", "--driver-port",
         str(p_port), sys.executable, WORKER, "epochs", log],
        cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    result = {}
    t = threading.Thread(target=lambda: result.update(rc=ctrl.run()),
                         daemon=True)
    t.start()
    try:
        primary.wait(timeout=JOB_TIMEOUT)
        assert primary.returncode == -signal.SIGKILL, \
            (tmp_path / "primary.txt").read_text()[-3000:]
        _wait_for(lambda: ctrl.promoted is not None, 60,
                  "the standby never promoted")
        state, _ = journal.replay(str(journal_dir))
        assert ctrl.promoted_digest == journal.state_digest(state)
        assert ctrl.promoted.term == 2
        _wait_for(lambda: len(ctrl.server.scope_keys("heartbeat")) == 2,
                  60, "heartbeats never failed over to the new primary")
        t.join(timeout=JOB_TIMEOUT)
        assert not t.is_alive(), "the adopted job never finished"
        assert result["rc"] == 0
        promoted = ctrl.promoted
        assert (promoted.version, promoted.resets, promoted.fail_counts,
                promoted.blacklist) == (0, 0, {}, set())
        _check_untouched(log, epochs)
    finally:
        out.close()
        if primary.poll() is None:
            primary.kill()
            primary.wait(timeout=10)
        if ctrl.promoted is None:
            ctrl.stop()
        elif ctrl.promoted.journal is not None:
            ctrl.promoted.journal.close()
        thttp.reset_failover()


class _Spy(logging.Handler):
    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_a_healed_partitioned_primary_is_term_fenced(tmp_path, monkeypatch):
    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.runner import journal, spawn
    from horovod_tpu_torch.runner.elastic_driver import (
        DEMOTED_RC, ElasticDriver, ElasticSettings)
    from horovod_tpu_torch.runner.job import Settings
    from horovod_tpu_torch.utils.logging_util import get_logger
    from test_torch_port_elastic import _write_discovery
    torch_port_launch.build_port_core()
    phase = tmp_path / "phase"
    phase.write_text("0")
    discovery = _write_discovery(tmp_path, phase, [["localhost:2"]])
    log = str(tmp_path / "log")
    epochs = 12
    marker = tmp_path / "partition.marker"
    marker.write_text("")
    worker_env = {k: str(v) for k, v in _job_env(
        log, ELASTIC_TEST_LOG=log, ELASTIC_TEST_EPOCHS=epochs,
        ELASTIC_TEST_EPOCH_SLEEP=0.3, ELASTIC_TEST_MARKER=marker,
        ELASTIC_TEST_MARKER_EPOCH=3).items()}
    monkeypatch.setenv("HVDTPU_JOB_TOKEN", "ha-port-token-b")
    monkeypatch.setenv("HVDTPU_CHAOS",
                       f"driver:partition:ms=4000:wid=primary:after=20:"
                       f"once:marker={marker}")
    chaos.reset()
    thttp.reset_failover()
    spawn.reset_capture_dir(None)
    ctrl = _standby(tmp_path, discovery, worker_env, "127.0.0.1:1",
                    lease_timeout=1.5)
    es = ElasticSettings(
        Settings(num_proc=2, start_timeout=60, env=worker_env,
                 rendezvous_addr="127.0.0.1"),
        discovery_script=discovery, min_np=1, max_np=8,
        discovery_interval=0.2, heartbeat_timeout=30.0,
        journal_dir=str(tmp_path / "journal"),
        standby_addrs=f"127.0.0.1:{ctrl.port}", driver_port=0)
    primary = ElasticDriver(es, [sys.executable, WORKER, "epochs", log])
    ctrl.primary = ("127.0.0.1", primary.port)
    spy = _Spy()
    get_logger().addHandler(spy)
    res = {}
    t_p = threading.Thread(target=lambda: res.update(p=primary.run()),
                           daemon=True)
    t_s = threading.Thread(target=lambda: res.update(s=ctrl.run()),
                           daemon=True)
    t_p.start()
    t_s.start()
    try:
        _wait_for(lambda: any(rs.fired for rs in chaos.plan()._by_point.get(
            "driver", ())), 90, "the partition never fired")
        _wait_for(lambda: ctrl.promoted is not None, 60,
                  "the standby never promoted during the partition")
        t_p.join(timeout=JOB_TIMEOUT)
        assert not t_p.is_alive(), "the stale primary never demoted"
        assert res["p"] == DEMOTED_RC
        fenced = [m for m in spy.messages if "STALE PRIMARY FENCED" in m]
        assert fenced and "term 1" in fenced[0] and "term 2" in fenced[0]
        t_s.join(timeout=JOB_TIMEOUT)
        assert not t_s.is_alive() and res["s"] == 0
        assert (ctrl.promoted.term, ctrl.promoted.resets) == (2, 0)
        state, _ = journal.replay(str(tmp_path / "journal"))
        assert ctrl.promoted_digest == journal.state_digest(state)
        _check_untouched(log, epochs)
    finally:
        get_logger().removeHandler(spy)
        monkeypatch.delenv("HVDTPU_CHAOS")
        chaos.reset()
        thttp.reset_failover()
        if primary.journal is not None:
            primary.journal.close()
        if ctrl.promoted is None:
            ctrl.stop()
        elif ctrl.promoted.journal is not None:
            ctrl.promoted.journal.close()

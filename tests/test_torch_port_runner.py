"""The port's launcher against the JAX package's (``horovod_tpu_torch/
runner/`` vs ``horovod_tpu/runner/``): host parsing and slot assignments on
the same inputs, the KV store's wire protocol in both directions, the
elastic driver's rank assignment, blacklist and ``max_np`` cap with fake
processes on both drivers side by side, the launcher's flags, and a static
launcher job on gloo that gathers its peers through the store."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_port_launch

from horovod_tpu.runner import elastic_driver as jdrv
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import http_client as jclient
from horovod_tpu.runner import http_server as jserver
from horovod_tpu.runner import job as jjob
from horovod_tpu_torch.runner import elastic_driver as tdrv
from horovod_tpu_torch.runner import hosts as thosts
from horovod_tpu_torch.runner import http_client as tclient
from horovod_tpu_torch.runner import http_server as tserver
from horovod_tpu_torch.runner import job as tjob
from horovod_tpu_torch.runner import launch as tlaunch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_port_elastic_worker.py")


# -- hosts ----------------------------------------------------------------

def _slots(mod, hosts, n):
    return [(s.hostname, s.rank, s.size, s.local_rank, s.local_size,
             s.cross_rank, s.cross_size, s.to_env())
            for s in mod.get_host_assignments(hosts, n)]


@settings(max_examples=60, deadline=None)
@given(slots=st.lists(st.integers(1, 5), min_size=1, max_size=5),
       data=st.data())
def test_host_assignments_equal_the_jax_package(slots, data):
    text = ",".join(f"h{i}:{s}" for i, s in enumerate(slots))
    n = data.draw(st.integers(1, sum(slots)))
    want = _slots(jhosts, jhosts.parse_hosts(text), n)
    assert _slots(thosts, thosts.parse_hosts(text), n) == want


@pytest.mark.parametrize("text", ["a:2,b:3", "a,b:1", " a:4 ,, b ",
                                  "x:1,x:2", "", "a:0", "a:b"])
def test_parse_hosts_equals_the_jax_package(text):
    def parse(mod):
        try:
            return [(h.hostname, h.slots) for h in mod.parse_hosts(text)]
        except ValueError as e:
            return type(e)
    assert parse(thosts) == parse(jhosts)


def test_parse_hostfile_and_oversubscription_equal_the_jax_package(
        tmp_path):
    path = tmp_path / "hostfile"
    path.write_text("# cluster\nnode1 slots=4\nnode2:2\n\nnode3\n")
    got = [(h.hostname, h.slots) for h in thosts.parse_hostfile(str(path))]
    assert got == [(h.hostname, h.slots)
                   for h in jhosts.parse_hostfile(str(path))]
    assert got == [("node1", 4), ("node2", 2), ("node3", 1)]
    hosts = thosts.parse_hosts("a:1")
    with pytest.raises(ValueError, match="only 1 slots"):
        thosts.get_host_assignments(hosts, 2)


# -- the KV store's wire protocol -------------------------------------------

PAIRS = {"port client, JAX server": (tclient, jserver),
         "JAX client, port server": (jclient, tserver)}


@pytest.fixture(params=list(PAIRS))
def store(request):
    client, server_mod = PAIRS[request.param]
    server = server_mod.KVStoreServer(job_token="tok", addr="127.0.0.1")
    port = server.start()
    yield client, server, port
    server.stop()


def test_kv_put_get_delete_wait_across_packages(store):
    client, server, port = store
    a = ("127.0.0.1", port)
    assert client.get_kv(*a, "s", "k", token="tok") is None
    client.put_kv(*a, "s", "k", "v1", token="tok")
    assert client.get_kv(*a, "s", "k", token="tok") == b"v1"
    assert server.get("s", "k") == b"v1"
    client.put_kv(*a, "s", "k2", b"\x00\xff", token="tok")
    assert client.wait_for_kv(*a, "s", "k2", token="tok",
                              deadline_s=5) == b"\x00\xff"
    client.delete_kv(*a, "s", "k", token="tok")
    assert client.get_kv(*a, "s", "k", token="tok") is None
    client.delete_kv(*a, "s", "_all", token="tok")
    assert client.get_kv(*a, "s", "k2", token="tok") is None
    with pytest.raises(TimeoutError, match="s/never"):
        client.wait_for_kv(*a, "s", "never", token="tok", deadline_s=0.3)


@pytest.mark.parametrize("token", ["wrong", ""])
def test_kv_refuses_a_bad_token_with_403_across_packages(store, token):
    client, server, port = store
    server.put("s", "k", "v")
    for call in (lambda: client.get_kv("127.0.0.1", port, "s", "k",
                                       token=token),
                 lambda: client.put_kv("127.0.0.1", port, "s", "k", "x",
                                       token=token),
                 lambda: client.delete_kv("127.0.0.1", port, "s", "k",
                                          token=token)):
        with pytest.raises(client.KVFatalError) as err:
            call()
        assert err.value.code == 403
        assert "s/k" in str(err.value)
    assert server.get("s", "k") == b"v"


def test_kv_client_gives_up_on_a_dead_store_with_a_timeout():
    with pytest.raises(TimeoutError, match="put s/k"):
        tclient.put_kv("127.0.0.1", 1, "s", "k", "v", retries=2,
                       backoff=0.01, deadline=1.0)


def test_rendezvous_server_publishes_slot_lines_like_the_jax_package():
    lines = []
    for srv_mod, hosts_mod in ((tserver, thosts), (jserver, jhosts)):
        srv = srv_mod.RendezvousServer(job_token="t", addr="127.0.0.1")
        srv.start()
        try:
            srv.publish_assignments(hosts_mod.get_host_assignments(
                hosts_mod.parse_hosts("a:2,b:2"), 3))
            lines.append({k: srv.get("slots", k)
                          for k in srv.scope_keys("slots")})
        finally:
            srv.stop()
    assert lines[0] == lines[1]
    assert lines[0]["2"] == b"b,2,3,0,1,1,2"


# -- the elastic driver, with fake processes ---------------------------------

DRIVERS = {"jax": (jdrv, jjob), "port": (tdrv, tjob)}


class _FakeProc:
    def __init__(self):
        self.terminated = False

    def poll(self):
        return None

    def wait(self, *a):
        return 0

    def terminate(self):
        self.terminated = True

    def kill(self):
        pass


def _fake_spawn(driver, mod):
    def spawn(worker_id, host, idx):
        driver.workers[worker_id] = mod._Worker(worker_id, host, idx,
                                                _FakeProc())
    return spawn


@pytest.mark.parametrize("pkg", DRIVERS)
def test_driver_stable_rank_assignment(monkeypatch, pkg):
    mod, job = DRIVERS[pkg]
    es = mod.ElasticSettings(job.Settings(num_proc=3), min_np=1)
    driver = mod.ElasticDriver(es, ["true"])
    try:
        monkeypatch.setattr(driver, "_spawn", _fake_spawn(driver, mod))
        driver.version = 0
        driver._reconcile(driver._discover_targets())
        driver._publish()
        assert driver.rank_order == ["localhost:0", "localhost:1",
                                     "localhost:2"]
        line = driver.server.get("assign.0", "localhost:1").decode()
        assert line == "1,3,1,3,0,1"

        # Worker 0 dies: survivors keep their relative order and take the
        # lowest ranks; the respawned worker appends at the end.
        driver.workers["localhost:0"].proc.poll = lambda: 17
        assert driver._sweep_exits()
        driver._reconcile(driver._discover_targets())
        driver.version = 1
        driver._publish()
        assert driver.rank_order == ["localhost:1", "localhost:2",
                                     "localhost:0"]
        assigned = {w: driver.server.get("assign.1", w).decode()
                    for w in driver.rank_order}
        assert assigned == {"localhost:1": "0,3,0,3,0,1",
                            "localhost:2": "1,3,1,3,0,1",
                            "localhost:0": "2,3,2,3,0,1"}
        assert driver.server.get("elastic", "version") == b"1"
    finally:
        driver.server.stop()


@pytest.mark.parametrize("pkg", DRIVERS)
def test_driver_blacklist(monkeypatch, pkg):
    mod, job = DRIVERS[pkg]
    es = mod.ElasticSettings(job.Settings(num_proc=2), min_np=1,
                             host_fail_limit=2)
    driver = mod.ElasticDriver(es, ["true"])
    try:
        monkeypatch.setattr(driver, "_spawn", _fake_spawn(driver, mod))
        driver._reconcile(driver._discover_targets())
        assert len(driver.workers) == 2
        driver.fail_counts["localhost"] = 1
        w = driver.workers["localhost:0"]
        w.proc.poll = lambda: 17
        assert driver._sweep_exits()
        assert "localhost" in driver.blacklist
        assert driver._discover_targets() == []
    finally:
        driver.server.stop()


@pytest.mark.parametrize("pkg", DRIVERS)
def test_driver_max_np_cap(pkg):
    mod, job = DRIVERS[pkg]
    es = mod.ElasticSettings(job.Settings(num_proc=2, hosts="a:4,b:4"),
                             min_np=1, max_np=3)
    driver = mod.ElasticDriver(es, ["true"])
    try:
        slots = driver._discover_targets()
        assert [s[0] for s in slots] == ["a:0", "a:1", "a:2"]
    finally:
        driver.server.stop()


def _driver_trace(mod, job, monkeypatch):
    """Assign lines and membership of a scripted history: 2 hosts, a
    worker failure, a rereq, a preempted and a restarted worker."""
    from horovod_tpu.exceptions import PREEMPT_EXIT_CODE, RESTART_EXIT_CODE
    es = mod.ElasticSettings(job.Settings(num_proc=4, hosts="a:2,b:2"),
                             min_np=1)
    driver = mod.ElasticDriver(es, ["true"])
    trace = []
    try:
        monkeypatch.setattr(driver, "_spawn", _fake_spawn(driver, mod))
        driver.version = 0
        driver._reconcile(driver._discover_targets())
        driver._publish()
        for rc in (17, PREEMPT_EXIT_CODE, RESTART_EXIT_CODE):
            victim = driver.rank_order[0]
            driver.workers[victim].proc.poll = lambda rc=rc: rc
            changed = driver._sweep_exits()
            driver._reconcile(driver._discover_targets())
            driver.version += 1
            driver._publish()
            trace.append((changed, list(driver.rank_order),
                          {w: driver.server.get(f"assign.{driver.version}",
                                                w)
                           for w in driver.rank_order},
                          dict(driver.fail_counts)))
        driver.server.put("elastic", "rereq.a:1", str(driver.version + 1))
        trace.append(driver._rereq_pending())
        driver.version += 1
        driver._clear_stale_rereqs()
        trace.append(driver.server.scope_keys("elastic"))
    finally:
        driver.server.stop()
    return trace


def test_driver_exit_codes_and_rereqs_follow_the_jax_driver(monkeypatch):
    from horovod_tpu_torch import exceptions as texc
    from horovod_tpu import exceptions as jexc
    assert (texc.RESTART_EXIT_CODE, texc.PREEMPT_EXIT_CODE) == \
        (jexc.RESTART_EXIT_CODE, jexc.PREEMPT_EXIT_CODE)
    assert _driver_trace(tdrv, tjob, monkeypatch) == \
        _driver_trace(jdrv, jjob, monkeypatch)


# -- the launcher's command line ----------------------------------------------

@pytest.mark.parametrize("flag", [["--journal-dir", "j"],
                                  ["--standby", "h:1"],
                                  ["--standby-endpoints", "h:1"],
                                  ["--driver-port", "7"], ["--autotune"],
                                  ["--autotune-log-file", "f"]])
def test_unported_launcher_flags_raise_with_their_roadmap_item(flag):
    # The HA and autotune flags are ported now (control-plane HA and
    # autotune/): each parses to the JAX launcher's value and knob env.
    from horovod_tpu.runner import launch as jlaunch
    argv = ["-np", "2", *flag, "python", "x.py"]
    got, want = tlaunch.parse_args(argv), jlaunch.parse_args(argv)
    for dest in ("journal_dir", "standby", "standby_endpoints",
                 "driver_port", "autotune", "autotune_log_file"):
        assert getattr(got, dest) == getattr(want, dest), dest
    assert tlaunch._knob_env(got) == jlaunch._knob_env(want)


def test_launcher_flags_become_the_jax_package_knob_env():
    from horovod_tpu.runner import launch as jlaunch
    argv = ["-np", "3", "--min-np", "1", "--max-np", "4",
            "--fusion-threshold-mb", "2", "--cycle-time-ms", "3.5",
            "--cache-capacity", "9", "--timeline-filename", "t.json",
            "--timeline-mark-cycles", "--hierarchical-threshold-mb", "0",
            "--log-level", "info", "--stall-check-disable",
            "--stall-check-time-seconds", "5",
            "--stall-shutdown-time-seconds", "7", "python", "x.py"]
    got, want = tlaunch.parse_args(argv), jlaunch.parse_args(argv)
    assert tlaunch._knob_env(got) == jlaunch._knob_env(want)
    assert (got.num_proc, got.min_np, got.max_np, got.command) == \
        (want.num_proc, want.min_np, want.max_np, want.command)


def test_launcher_prints_the_port_version():
    out = subprocess.run([sys.executable, "-m",
                          "horovod_tpu_torch.runner.launch", "--version"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    from horovod_tpu_torch.version import __version__
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == __version__


def test_static_job_gathers_its_peers_through_the_store(tmp_path):
    torch_port_launch.build_port_core()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HVDTPU_CPU_OPERATIONS="nccl")
    rc, out = torch_port_launch.run_launcher(
        ["-np", "2", "--start-timeout", "60", sys.executable, WORKER,
         "static", str(tmp_path)], REPO, env, 240)
    assert rc == 0, out[-5000:]
    want = sum(np.random.RandomState(r).randn(5).astype(np.float32)
               for r in range(2))
    for r in range(2):
        res = json.loads((tmp_path / f"r{r}.json").read_text())
        assert (res["rank"], res["size"]) == (r, 2)
        assert res["backend"] == "gloo-global"
        assert len(res["peers"].split(",")) == 2
        np.testing.assert_allclose(res["sum"], want, rtol=1e-6)

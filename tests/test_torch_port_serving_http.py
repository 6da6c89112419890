"""The port's serving plane over HTTP against the JAX package's, on the
CPU (``device="cpu"``): the port's router in front of a JAX worker and the
JAX router in front of a port worker give the same status codes and bodies
as each package alone (200, 400, 413, 429 with ``Retry-After``, 503); the
``/v1`` routes are token-gated; workers register and push stats on the KV
plane and take the drain flag there; the console client drives a worker.
Every server is stopped by its test; nothing here holds a latency bar.
"""

import json
import urllib.error
import urllib.request

import pytest

from horovod_tpu.runner import http_server as jserver
from horovod_tpu.serving import model as jmodel
from horovod_tpu.serving import router as jrouter
from horovod_tpu.serving import scheduler as jsched
from horovod_tpu.serving import worker as jworker
from horovod_tpu_torch.runner import http_server as tserver
from horovod_tpu_torch.serving import cli as tcli
from horovod_tpu_torch.serving import model as tmodel
from horovod_tpu_torch.serving import router as trouter
from horovod_tpu_torch.serving import scheduler as tsched
from horovod_tpu_torch.serving import worker as tworker

TOKEN = "serving-test-token"
PKGS = {"port": (tworker, tmodel, tsched, trouter, {"device": "cpu"}),
        "jax": (jworker, jmodel, jsched, jrouter, {})}


def _http(port, path, payload=None, token=TOKEN, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode() if payload is not None else None,
        method="POST" if payload is not None else "GET")
    if token:
        req.add_header(tserver.AUTH_HEADER, token)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Retry-After"), \
                json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, e.headers.get("Retry-After"), \
            (json.loads(raw) if raw else {})


class _Stack:
    """Workers of one package behind a router of another, every one on
    its own HTTP server; stops them all on exit."""

    def __init__(self, router_pkg, worker_pkg):
        self.wmod, self.mmod, self.smod, _, self.dev = PKGS[worker_pkg]
        self.rmod = PKGS[router_pkg][3]
        self.workers, self.routers = [], []

    def worker(self, start=True, **kw):
        kw.setdefault("num_pages", 64)
        kw.setdefault("page_size", 4)
        kw.setdefault("queue_limit", 8)
        w = self.wmod.ServingWorker(self.mmod.ToyLM(**self.dev), **kw)
        self.workers.append(w)
        port = w.serve_http(addr="127.0.0.1", token=TOKEN)
        if start:
            w.start()
        return w, f"http://127.0.0.1:{port}"

    def router(self, *urls):
        r = self.rmod.Router(members={"c0": [
            self.rmod.WorkerClient(u, token=TOKEN) for u in urls]})
        self.routers.append(r)
        return r.serve_http(addr="127.0.0.1", token=TOKEN)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for r in self.routers:
            r.stop_http()
        for w in self.workers:
            w.stop()


def _scenarios(router_pkg, worker_pkg):
    """``[(status, Retry-After, body without latency)]`` of one request
    per outcome, sent to the router over HTTP."""
    out = []

    def send(port, payload):
        status, retry, body = _http(port, "/v1/generate", payload)
        body.pop("latency", None)
        out.append((status, retry, body))

    with _Stack(router_pkg, worker_pkg) as st:
        _, url = st.worker()
        port = st.router(url)
        send(port, {"id": "ok", "prompt": [3, 1, 4], "max_new_tokens": 6})
        send(port, {"id": "empty", "prompt": [], "max_new_tokens": 2})
        send(port, {"id": "huge", "prompt": [1],
                    "max_new_tokens": 10 ** 4})
        send(port, {"id": "long", "prompt": list(range(300)),
                    "max_new_tokens": 2})
        out.append(_http(port, "/v1/generate", [1, 2]))
        parked, url = st.worker(start=False, queue_limit=1)
        assert parked.scheduler.submit(
            st.smod.Request("parked", [1], 2)) is not None
        send(st.router(url), {"id": "busy", "prompt": [1],
                              "max_new_tokens": 2})
        drained, url = st.worker()
        drained.scheduler.drain()
        send(st.router(url), {"id": "late", "prompt": [1],
                              "max_new_tokens": 2})
        st.routers.append(st.rmod.Router(members={}))
        send(st.routers[-1].serve_http(addr="127.0.0.1", token=TOKEN),
             {"prompt": [1]})
    return out


def test_routers_and_workers_interoperate_across_packages():
    want = _scenarios("jax", "jax")
    assert [s for s, _, _ in want] == [200, 400, 413, 413, 400, 429, 503,
                                       503]
    assert want[0][2]["tokens"] == \
        jmodel.ToyLM().reference_completion([3, 1, 4], 6)
    assert float(want[5][1]) > 0
    for pair in (("port", "jax"), ("jax", "port"), ("port", "port")):
        assert _scenarios(*pair) == want, pair


def _worker_routes(pkg):
    wmod, mmod, smod, _, dev = PKGS[pkg]
    w = wmod.ServingWorker(mmod.ToyLM(**dev), num_pages=16, page_size=2,
                           queue_limit=1)
    port = w.serve_http(addr="127.0.0.1", token=TOKEN)
    try:
        got = [_http(port, "/v1/serving/stats", token="")[0],
               _http(port, "/v1/generate", {"prompt": [1]}, token="")[0],
               _http(port, "/v1/unknown", {})[0]]
        assert w.scheduler.submit(smod.Request("p", [1], 2)) is not None
        got.append(_http(port, "/v1/generate", {"id": "q", "prompt": [1],
                                                "max_new_tokens": 2}))
        status, _, stats = _http(port, "/v1/serving/stats")
        got.append((status, sorted(stats), stats["queue_depth"]))
        got.append(_http(port, "/v1/serving/drain", {}))
        got.append(_http(port, "/v1/serving/migrate_in",
                         {"mid": "m", "chunk": 0, "total": 1}))
    finally:
        w.stop()
    return got


def test_worker_routes_gate_on_the_token_and_answer_alike():
    got = _worker_routes("port")
    assert got == _worker_routes("jax")
    assert got[:3] == [403, 403, 404]
    assert got[3][0] == 429 and float(got[3][1]) > 0
    assert got[5][0] == 200 and got[5][2]["draining"]
    assert got[6][:2] == (409, None)


def test_registration_stats_and_drain_ride_the_kv_plane():
    # A port worker registers with a JAX KV store; the port router and the
    # JAX router both discover it there, read its pushed stats and drain
    # it through the flag.
    kv = jserver.KVStoreServer(job_token=TOKEN, addr="127.0.0.1")
    kv_port = kv.start()
    w = tworker.ServingWorker(device="cpu", cohort="c7", wid=3,
                              num_pages=16, page_size=2).start()
    try:
        wport = w.serve_http(addr="127.0.0.1", token=TOKEN)
        w.register("127.0.0.1", kv_port, token=TOKEN,
                   advertise=f"127.0.0.1:{wport}")
        assert w.push_stats_once()
        for rmod in (trouter, jrouter):
            r = rmod.Router(kv=("127.0.0.1", kv_port, TOKEN))
            assert r.refresh_from_kv(["c7"]) == {"c7": 1}
            stats = r.stats()
            assert stats["source"] == "kv"
            assert stats["cohorts"]["c7"]["members"]["3"]["wid"] == 3
            status, body = r.generate({"prompt": [5, 5],
                                       "max_new_tokens": 3})
            assert status == 200 and body["worker"] == "c7.3"
            assert body["tokens"] == \
                jmodel.ToyLM().reference_completion([5, 5], 3)
        acks = trouter.Router(kv=("127.0.0.1", kv_port, TOKEN)) \
            .drain_cohort("c7")
        assert acks["acks"]["kv_flag"] is True
        assert w.push_stats_once()
        assert w.scheduler.draining
    finally:
        w.stop()
        kv.stop()


def test_the_console_client_drives_a_worker(capsys):
    w = tworker.ServingWorker(device="cpu", num_pages=16,
                              page_size=2).start()
    try:
        port = w.serve_http(addr="127.0.0.1", token=TOKEN)
        url = f"http://127.0.0.1:{port}"
        assert tcli.main(["stats", "--url", url, "--token", TOKEN,
                          "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["role"] == "worker"
        assert tcli.main(["drain", "c0", "--url", url, "--token",
                          TOKEN]) == 0
        assert json.loads(capsys.readouterr().out)["draining"] is True
        assert tcli.main(["stats", "--url", "http://127.0.0.1:1",
                          "--token", TOKEN]) == 2
        assert tcli.main(["route", "--kv", "127.0.0.1:1", "--token",
                          TOKEN]) == 2
    finally:
        w.stop()
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    assert "route" in capsys.readouterr().out

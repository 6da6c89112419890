"""In-driver HTTP key-value store + rendezvous server (port of
``horovod_tpu/runner/http_server.py``; reference:
horovod/runner/http/http_server.py:35-192, ``KVStoreHandler`` GET/PUT and
``RendezvousServer``).

The launcher runs one of these; workers discover each other through it
instead of receiving a hand-assembled peer list. The store is scoped
(``/scope/key``) and authenticated with a per-job token carried in a
header, the analog of the reference's HMAC-signed service messages
(horovod/runner/common/util/secret.py). The wire protocol is the JAX
package's: either package's client talks to either package's server.

Besides the store, behind the same token: ``/metrics`` (Prometheus text of
this process's registry and, once ranks have pushed their snapshots into
the ``metrics`` scope, their cluster roll-up), ``/metrics.json``
(``{"local": ..., "ranks": {rank: snapshot}}``) and ``/clock`` (this
process's wall clock, for the trace plane's offset estimate).

Not ported: the control-plane HA parts (term headers and fences, the
journal and its ``/journal`` route, the primary hint) and the serving
routes (ROADMAP queue A, item 13 and item 14).
"""

import json
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

AUTH_HEADER = "X-Hvdtpu-Job-Token"


def new_job_token():
    return secrets.token_hex(16)


class _KVStoreHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _split(self):
        parts = [p for p in self.path.split("/") if p]
        if len(parts) != 2:
            return None, None
        return parts[0], parts[1]

    def _authorized(self):
        token = self.server.job_token
        if token and self.headers.get(AUTH_HEADER) != token:
            self.send_response(403)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return False
        return True

    def do_GET(self):  # noqa: N802 (http.server API)
        if not self._authorized():
            return
        parts = [p for p in self.path.split("/") if p]
        if len(parts) == 1 and parts[0] in ("metrics", "metrics.json"):
            return self._serve_metrics(parts[0] == "metrics.json")
        if len(parts) == 1 and parts[0] == "clock":
            # The clock reference of the trace plane (tracing/clock.py).
            return self._reply(200, repr(time.time()).encode())
        scope, key = self._split()
        if scope is None:
            return self._reply(400, b"")
        with self.server.store_lock:
            value = self.server.store.get(scope, {}).get(key)
        if value is None:
            return self._reply(404, b"")
        self._reply(200, value)

    def do_PUT(self):  # noqa: N802
        if not self._authorized():
            return
        scope, key = self._split()
        if scope is None:
            return self._reply(400, b"")
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        with self.server.store_lock:
            self.server.store.setdefault(scope, {})[key] = value
        self._reply(200, b"")

    def do_DELETE(self):  # noqa: N802
        """Delete a key, or a whole scope when the path is ``/scope/_all``
        (the reference's scope-complete handling,
        horovod/runner/http/http_server.py:112-151)."""
        if not self._authorized():
            return
        scope, key = self._split()
        if scope is None:
            return self._reply(400, b"")
        with self.server.store_lock:
            if key == "_all":
                self.server.store.pop(scope, None)
            else:
                self.server.store.get(scope, {}).pop(key, None)
        self._reply(200, b"")

    def _serve_metrics(self, json_mode):
        """This process's registry as Prometheus v0.0.4 text, followed by
        the cluster roll-up of the ranks' pushed snapshots; or, for
        ``/metrics.json``, ``{"local": ..., "ranks": {rank: snapshot}}``."""
        from ..telemetry import (METRICS_SCOPE, PROMETHEUS_CONTENT_TYPE,
                                 aggregate_snapshots, parse_rank_snapshots,
                                 render_prometheus, snapshot)
        local = snapshot()
        with self.server.store_lock:
            raw = dict(self.server.store.get(METRICS_SCOPE, {}))
        snaps = parse_rank_snapshots(raw)
        if json_mode:
            body = json.dumps({"local": local, "ranks": snaps}).encode()
            ctype = "application/json"
        else:
            text = render_prometheus(local)
            if snaps:
                text += render_prometheus(aggregate_snapshots(snaps))
            body = text.encode()
            ctype = PROMETHEUS_CONTENT_TYPE
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply(self, code, body):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)


class KVStoreServer:
    """Threaded HTTP KV store; binds an ephemeral port on start()."""

    def __init__(self, job_token="", verbose=False, addr="0.0.0.0",
                 port=0):
        self._addr = addr
        self._port = port
        self._httpd = None
        self._thread = None
        self.job_token = job_token
        self.verbose = verbose

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    def start(self):
        self._httpd = ThreadingHTTPServer((self._addr, self._port),
                                          _KVStoreHandler)
        self._httpd.store = {}
        self._httpd.store_lock = threading.Lock()
        self._httpd.job_token = self.job_token
        self._httpd.verbose = self.verbose
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="hvdtpu-kvstore")
        self._thread.start()
        return self.port

    def get(self, scope, key):
        with self._httpd.store_lock:
            return self._httpd.store.get(scope, {}).get(key)

    def put(self, scope, key, value):
        if isinstance(value, str):
            value = value.encode()
        with self._httpd.store_lock:
            self._httpd.store.setdefault(scope, {})[key] = value

    def delete(self, scope, key):
        with self._httpd.store_lock:
            self._httpd.store.get(scope, {}).pop(key, None)

    def scope_keys(self, scope):
        with self._httpd.store_lock:
            return sorted(self._httpd.store.get(scope, {}).keys())

    def scopes(self):
        with self._httpd.store_lock:
            return sorted(self._httpd.store.keys())

    def clear_scope(self, scope):
        with self._httpd.store_lock:
            self._httpd.store.pop(scope, None)

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None


class RendezvousServer(KVStoreServer):
    """KV store pre-loaded with the job's slot table so each worker can
    fetch its assignment by rank (reference: RendezvousServer serving host
    allocations, horovod/runner/http/http_server.py:192)."""

    SLOT_SCOPE = "slots"

    def publish_assignments(self, slots):
        """Store each SlotInfo under slots/<rank> as a csv line."""
        self.clear_scope(self.SLOT_SCOPE)
        for s in slots:
            line = (f"{s.hostname},{s.rank},{s.size},{s.local_rank},"
                    f"{s.local_size},{s.cross_rank},{s.cross_size}")
            self.put(self.SLOT_SCOPE, str(s.rank), line)
        self.put(self.SLOT_SCOPE, "size", str(len(slots)))

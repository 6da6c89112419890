"""In-driver HTTP key-value store + rendezvous server (port of
``horovod_tpu/runner/http_server.py``; reference:
horovod/runner/http/http_server.py:35-192, ``KVStoreHandler`` GET/PUT and
``RendezvousServer``).

Workers fetch their slot assignment and publish/discover peer addresses
instead of receiving a hand-assembled peer list. The store is scoped
(``/scope/key``) and authenticated with a per-job token carried in a
header, the analog of the reference's HMAC-signed service messages
(horovod/runner/common/util/secret.py). The wire protocol is the JAX
package's: either package's client talks to either package's server.

Besides the store, behind the same token: ``/metrics`` (Prometheus text of
this process's registry and, once ranks have pushed their snapshots into
the ``metrics`` scope, their cluster roll-up), ``/metrics.json``
(``{"local": ..., "ranks": {rank: snapshot}}``), ``/clock`` (this
process's wall clock, for the trace plane's offset estimate) and, with a
journal attached, ``/journal?since=N`` (a standby's sync route).

Control-plane HA: every reply carries the store's term and, when known,
the primary hint; a PUT or DELETE whose term header is older than the
store's is refused 409 with both terms (the split-brain fence), a newer
one is adopted; durable-scope writes go to the journal under the store
lock.

The serving plane rides the same server: attaching a ``serving_router``
or ``serving_worker`` (``attach_serving``) enables the token-gated
``POST /v1/generate``, ``GET /v1/serving/stats`` and ``POST
/v1/serving/drain`` routes, with the JAX package's status codes and bodies
(a 429 carries ``Retry-After``). Workers additionally answer ``POST
/v1/serving/migrate_in`` (KV-cache live migration).
"""

import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

AUTH_HEADER = "X-Hvdtpu-Job-Token"
#: Control-plane HA headers (docs/fault_tolerance.md "Control-plane
#: HA"): every response advertises the store's current term and, when
#: known, the primary endpoint workers should prefer; PUT/DELETE
#: requests may carry the writer's term, and a term older than the
#: store's is rejected 409 instead of applied (split-brain fencing).
TERM_HEADER = "X-Hvd-Term"
PRIMARY_HEADER = "X-Hvd-Primary"


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
        if time.monotonic() < getattr(self.server, "paused_until", 0.0):
            # Simulated network partition (chaos `driver:partition`):
            # drop the request on the floor — the client sees a closed
            # connection, exactly what a partitioned store looks like.
            self.close_connection = True
            return False
        token = self.server.job_token
        if token and self.headers.get(AUTH_HEADER) != token:
            self.send_response(403)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return False
        return True

    def _serving_target(self):
        """The attached serving endpoint: the router when one is
        attached, else the worker, else None (routes answer 404)."""
        return (getattr(self.server, "serving_router", None)
                or getattr(self.server, "serving_worker", None))

    def _ha_headers(self):
        """Advertise the store's term + primary hint on every reply."""
        self.send_header(TERM_HEADER, str(self.server.term))
        hint = getattr(self.server, "primary_hint", None)
        if hint:
            self.send_header(PRIMARY_HEADER, hint)

    def _fence_term(self):
        """Apply the request's term header against the store's term.
        Returns True when the mutation may proceed; replies 409 (with
        both terms) and returns False when the writer is stale. A
        NEWER term is adopted — that is how a failed-over worker's
        first write teaches a resurrected stale store that the world
        moved on."""
        raw = self.headers.get(TERM_HEADER)
        if raw is None:
            return True
        try:
            req_term = int(raw)
        except ValueError:
            return True
        from .journal import term_fences
        with self.server.store_lock:
            cur = self.server.term
            if term_fences(req_term, cur):
                stale = True
            else:
                stale = False
                if req_term > cur:
                    self.server.term = req_term
        if stale:
            self._reply_json(409, {"error": "term_fenced",
                                   "request_term": req_term,
                                   "server_term": cur})
            return False
        return True

    def _reply_json(self, code, obj):
        import json as _json
        body = _json.dumps(obj).encode()
        self.send_response(code)
        self._ha_headers()
        if code == 429:
            # Backpressure contract: clients are told when to come back
            # instead of hammering the queue limit.
            self.send_header(
                "Retry-After",
                str(obj.get("retry_after", 1.0) if isinstance(obj, dict)
                    else 1.0))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802
        """Serving-plane routes: /v1/generate, /v1/serving/drain,
        /v1/serving/migrate_in (worker targets only — migration is
        host-to-host, the router never holds KV pages)."""
        if not self._authorized():
            return
        import json as _json
        target = self._serving_target()
        if self.path not in ("/v1/generate", "/v1/serving/drain",
                             "/v1/serving/migrate_in") \
                or target is None:
            return self._reply(404, b"")
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length)
        try:
            payload = _json.loads(raw) if raw else {}
        except ValueError:
            return self._reply_json(400, {"error": "bad JSON body"})
        if not isinstance(payload, dict):
            return self._reply_json(
                400, {"error": "bad JSON body: must be an object"})
        if self.path == "/v1/generate":
            code, body = target.handle_generate(payload)
        elif self.path == "/v1/serving/migrate_in":
            worker = getattr(self.server, "serving_worker", None)
            if worker is None:
                return self._reply(404, b"")
            code, body = worker.handle_migrate_in(payload)
        else:
            code, body = target.handle_drain(payload)
        self._reply_json(code, body)

    def do_GET(self):  # noqa: N802 (http.server API)
        if not self._authorized():
            return
        if self.path == "/v1/serving/stats":
            target = self._serving_target()
            if target is None:
                return self._reply(404, b"")
            return self._reply_json(200, target.stats())
        if self.path.split("?")[0] == "/journal":
            return self._serve_journal()
        parts = [p for p in self.path.split("/") if p]
        if len(parts) == 1 and parts[0] in ("metrics", "metrics.json"):
            return self._serve_metrics(parts[0] == "metrics.json")
        if len(parts) == 1 and parts[0] == "clock":
            # Clock reference for cross-rank trace alignment
            # (tracing/clock.py): workers sample this with an NTP-style
            # round-trip to estimate their offset to the driver.
            import time
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
        if not self._fence_term():
            return
        with self.server.store_lock:
            self.server.store.setdefault(scope, {})[key] = value
            self._journal_write("kv_put", scope, key, value)
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
        if not self._fence_term():
            return
        with self.server.store_lock:
            if key == "_all":
                self.server.store.pop(scope, None)
            else:
                self.server.store.get(scope, {}).pop(key, None)
            self._journal_write(
                "kv_clear" if key == "_all" else "kv_delete", scope,
                key, None)
        self._reply(200, b"")

    def _journal_write(self, op, scope, key, value):
        """Journal a worker's write when the scope is durable (commits,
        exit markers — docs/fault_tolerance.md). Called UNDER the store
        lock so journal order can never invert store order for racing
        same-key writes (a replayed replica must land on the same final
        value as the live store); durable writes are rare — one per
        worker per membership event — so the fsync under the lock does
        not sit on any hot path."""
        journal = getattr(self.server, "journal", None)
        if journal is None:
            return
        from .journal import durable_key
        if not durable_key(scope, key):
            return
        if op == "kv_put":
            journal.record("kv_put", scope=scope, key=key,
                           value=value.decode("latin-1"))
        elif op == "kv_delete":
            journal.record("kv_delete", scope=scope, key=key)
        else:
            journal.record("kv_clear", scope=scope)

    def _serve_journal(self):
        """Token-gated standby sync route: ``GET /journal?since=N`` →
        ``{"term", "seq", "snapshot", "entries"}`` (journal.py
        sync_payload). 404 when this store has no journal attached —
        the disabled-mode contract leaves no trace of the route."""
        journal = getattr(self.server, "journal", None)
        if journal is None:
            return self._reply(404, b"")
        from urllib.parse import parse_qs, urlparse
        query = parse_qs(urlparse(self.path).query)
        try:
            since = int(query.get("since", ["0"])[0])
        except ValueError:
            return self._reply(400, b"")
        self._reply_json(200, journal.sync_payload(since))

    def _serve_metrics(self, json_mode):
        """Token-gated metrics exposition (docs/metrics.md): the local
        process's registry as Prometheus v0.0.4 text plus, when workers
        have pushed rank snapshots into the ``metrics`` scope, the
        cluster roll-up (``*_cluster{stat=...}``). ``/metrics.json``
        returns ``{"local": ..., "ranks": {rank: snapshot}}``."""
        import json as _json

        from ..telemetry import (METRICS_SCOPE, PROMETHEUS_CONTENT_TYPE,
                                 aggregate_snapshots, parse_rank_snapshots,
                                 render_prometheus, snapshot)
        local = snapshot()
        with self.server.store_lock:
            raw = dict(self.server.store.get(METRICS_SCOPE, {}))
        snaps = parse_rank_snapshots(raw)
        if json_mode:
            body = _json.dumps({"local": local, "ranks": snaps}).encode()
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
        self._ha_headers()
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
        self._port = port  # 0 = ephemeral; HA standbys bind fixed ports
        self._httpd = None
        self._thread = None
        self.job_token = job_token
        self.verbose = verbose
        # Control-plane HA state (docs/fault_tolerance.md): the highest
        # term this store has observed, an optional journal (enables
        # the /journal route + durable-write journaling), and the
        # primary endpoint hint advertised on every response.
        self._term = 0
        self.journal = None
        self.primary_hint = None
        self.serving_worker = None
        self.serving_router = None

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def term(self):
        return self._httpd.term if self._httpd is not None else self._term

    def set_term(self, term):
        """Raise the store's observed term (never lowers it)."""
        if self._httpd is None:
            self._term = max(self._term, int(term))
            return
        with self._httpd.store_lock:
            self._httpd.term = max(self._httpd.term, int(term))

    def set_primary_hint(self, hint):
        self.primary_hint = hint
        if self._httpd is not None:
            self._httpd.primary_hint = hint

    def attach_journal(self, journal):
        """Attach a DriverJournal: enables ``GET /journal`` and the
        durable-scope write-through (callable before or after start)."""
        self.journal = journal
        if self._httpd is not None:
            self._httpd.journal = journal

    def attach_serving(self, worker=None, router=None):
        """Attach a serving worker/router; enables the /v1 routes
        (callable before or after start())."""
        if worker is not None:
            self.serving_worker = worker
        if router is not None:
            self.serving_router = router
        if self._httpd is not None:
            self._httpd.serving_worker = self.serving_worker
            self._httpd.serving_router = self.serving_router

    def pause_for(self, seconds):
        """Black-hole every request for ``seconds`` — the chaos
        ``driver:partition`` effect (clients see closed connections)."""
        self._httpd.paused_until = time.monotonic() + seconds

    def paused(self):
        return (self._httpd is not None
                and time.monotonic() < self._httpd.paused_until)

    def _check_write_term(self, mutation, writer_term):
        """In-process analog of the HTTP fence: the driver stamps its
        own writes with its term; once the store has observed a newer
        one (a failed-over worker wrote through), the stale driver's
        mutation raises instead of applying. ``None`` = unfenced
        (HA off)."""
        if writer_term is None:
            return
        cur = self._httpd.term
        from .journal import StaleTermError, term_fences
        if term_fences(writer_term, cur):
            raise StaleTermError(mutation, writer_term, cur)
        if writer_term > cur:
            self._httpd.term = writer_term

    def start(self):
        self._httpd = ThreadingHTTPServer((self._addr, self._port),
                                          _KVStoreHandler)
        self._httpd.store = {}
        self._httpd.store_lock = threading.Lock()
        self._httpd.job_token = self.job_token
        self._httpd.verbose = self.verbose
        self._httpd.term = self._term
        self._httpd.journal = self.journal
        self._httpd.primary_hint = self.primary_hint
        self._httpd.paused_until = 0.0
        self._httpd.serving_worker = self.serving_worker
        self._httpd.serving_router = self.serving_router
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="hvdtpu-kvstore")
        self._thread.start()
        return self.port

    def get(self, scope, key):
        with self._httpd.store_lock:
            return self._httpd.store.get(scope, {}).get(key)

    def put(self, scope, key, value, term=None):
        if isinstance(value, str):
            value = value.encode()
        with self._httpd.store_lock:
            self._check_write_term(f"put {scope}/{key}", term)
            self._httpd.store.setdefault(scope, {})[key] = value

    def delete(self, scope, key, term=None):
        with self._httpd.store_lock:
            self._check_write_term(f"delete {scope}/{key}", term)
            self._httpd.store.get(scope, {}).pop(key, None)

    def scope_keys(self, scope):
        with self._httpd.store_lock:
            return sorted(self._httpd.store.get(scope, {}).keys())

    def scopes(self):
        with self._httpd.store_lock:
            return sorted(self._httpd.store.keys())

    def clear_scope(self, scope, term=None):
        with self._httpd.store_lock:
            self._check_write_term(f"clear {scope}", term)
            self._httpd.store.pop(scope, None)

    def load_state(self, kv_state):
        """Pre-load durable KV scopes (a journal replica's ``kv``
        partition) — the promotion path re-serving a dead primary's
        commits and assignment table. Existing keys win: anything a
        worker wrote here directly after the primary died is NEWER
        than the replica's journal-replayed value."""
        with self._httpd.store_lock:
            for scope, keys in kv_state.items():
                bucket = self._httpd.store.setdefault(scope, {})
                for key, value in keys.items():
                    bucket.setdefault(key, value.encode("latin-1"))

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

"""Request router: assigns requests to host cohorts over the runner
HTTP/KV plane, with backpressure and dead-worker re-routing (port of
``horovod_tpu/serving/router.py``; the wire protocol is the JAX package's,
so either package's router fronts either package's workers).

The router is deliberately *stateless about requests*: it holds no
queue of its own (every wait station in the serving plane is a bounded
scheduler queue on some host — rule HVD210), forwards each request
synchronously on its handler thread, and answers **429 + Retry-After**
the moment every candidate worker reports backpressure. A cohort's
queue depth crossing its limit therefore propagates to clients
immediately instead of accumulating anywhere.

Routing policy: cohorts ordered by last-known total queue depth (from
the KV-plane stats snapshots workers push; direct worker stats when no
KV store is configured), members round-robin within a cohort. A
transport failure mid-request — the worker died with streams in
flight — marks the member dead for a grace period and **re-routes the
request to the next candidate**; generation is deterministic given the
prompt, so the surviving worker completes the identical stream and an
accepted request is never lost (chaos row (a) pins this end to end).

A KV blackout degrades reads to the last-known / direct-local view
(``stats()['source']`` flips ``kv`` → ``local``) and recovery re-syncs
the cohort roll-up — the router never stops routing because the
control plane blinked (chaos row (b)).
"""

import http.client
import itertools
import json
import threading
import time
import urllib.error
import urllib.request
import zlib

from ..utils.logging_util import get_logger
from . import metrics as _m

#: how long a transport-failed member stays deprioritized.
DEAD_GRACE_S = 5.0
#: member slots probed per cohort during KV discovery.
MAX_MEMBERS = 32
#: Retry-After base seconds for router 429s (jittered per request).
RETRY_AFTER_S = 1.0
#: handoff hops the router follows for one migrated stream.
HANDOFF_HOPS = 4


def retry_after_jitter(request_id, base=RETRY_AFTER_S):
    """Deterministic per-request ``Retry-After``: ``base`` scaled into
    [0.5, 1.5) by a hash of the request id. Synchronized clients that
    all hit a full queue de-herd — each backs off a *different* but
    *reproducible* amount (same id, same value), so chaos/backpressure
    tests stay deterministic while the thundering herd disperses."""
    h = zlib.crc32(str(request_id).encode())
    return round(float(base) * (0.5 + (h % 4096) / 4096.0), 3)

# RemoteDisconnected is a ConnectionResetError, but BadStatusLine (a
# half-written response from a dying worker) is only an HTTPException.
_TRANSPORT_ERRORS = (urllib.error.URLError, ConnectionError, OSError,
                     http.client.HTTPException)


class WorkerClient:
    """HTTP client for one serving worker endpoint."""

    def __init__(self, base_url, token="", timeout_s=120.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout_s = float(timeout_s)

    def __repr__(self):
        return f"WorkerClient({self.base_url})"

    def _req(self, path, data=None, timeout=None):
        from ..runner.http_server import AUTH_HEADER
        req = urllib.request.Request(
            self.base_url + path,
            data=(json.dumps(data).encode() if data is not None
                  else None),
            method="POST" if data is not None else "GET")
        if self.token:
            req.add_header(AUTH_HEADER, self.token)
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout_s) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                parsed = json.loads(body) if body else {}
            except ValueError:
                parsed = {"error": body.decode(errors="replace")}
            return e.code, parsed

    def generate(self, payload):
        return self._req("/v1/generate", data=payload)

    def stats(self):
        return self._req("/v1/serving/stats", timeout=5.0)[1]

    def drain(self):
        return self._req("/v1/serving/drain", data={}, timeout=5.0)


class InProcClient:
    """Direct in-process client (bench, unit tests, single-host)."""

    def __init__(self, worker):
        self.worker = worker
        self.wid = worker.wid
        self.base_url = f"inproc:{worker.cohort}.{worker.wid}"

    def generate(self, payload):
        return self.worker.handle_generate(payload)

    def stats(self):
        return self.worker.stats()

    def drain(self):
        return self.worker.handle_drain()


class Router:
    """Routes ``/v1/generate`` to the least-loaded cohort member."""

    def __init__(self, members=None, kv=None, queue_limit=None):
        #: cohort -> list of clients (insertion order = member order).
        self.members = {c: list(ms) for c, ms in (members or {}).items()}
        #: (addr, port, token) of the launcher KV store, or None.
        self.kv = kv
        self.queue_limit = queue_limit
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._dead = {}          # base_url -> dead-until monotonic
        self._stats_cache = {}   # (cohort, idx) -> last stats dict
        self._source = "local"
        self.accepted = 0
        self.completed = 0
        self.rerouted = 0
        self.rejected = 0
        self.handoffs = 0        # migrated streams followed to a peer
        self._log = get_logger()

    # -- membership --------------------------------------------------------
    @staticmethod
    def _wid_of(client, fallback):
        """The worker id a client's stats live under on the KV plane
        (`stats.<cohort>.<wid>`). Discovery stamps it; wids need NOT
        be contiguous (a replacement host takes the next free slot)."""
        return getattr(client, "wid", fallback)

    def add_member(self, cohort, client, wid=None):
        with self._lock:
            members = self.members.setdefault(cohort, [])
            if wid is not None:
                client.wid = int(wid)
            elif not hasattr(client, "wid"):
                client.wid = len(members)
            members.append(client)

    def refresh_from_kv(self, cohorts, timeout_s=5.0):
        """Discover cohort members from ``serving/member.<cohort>.<i>``
        keys (workers register themselves there)."""
        from ..runner import http_client
        if self.kv is None:
            raise ValueError("router has no KV store configured")
        addr, port, token = self.kv
        found = {}
        for cohort in cohorts:
            urls = []
            for i in range(MAX_MEMBERS):
                raw = http_client.get_kv(
                    addr, port, "serving", f"member.{cohort}.{i}",
                    token=token, retries=0, deadline=timeout_s)
                if raw is None:
                    continue
                urls.append((i, raw.decode()))
            found[cohort] = urls
        with self._lock:
            for cohort, urls in found.items():
                have = {c.base_url for c in self.members.get(cohort, [])}
                for wid, url in urls:
                    base = url if url.startswith("http") \
                        else f"http://{url}"
                    if base not in have:
                        client = WorkerClient(base, token=token)
                        client.wid = wid
                        self.members.setdefault(cohort, []).append(
                            client)
        return {c: len(self.members.get(c, ())) for c in cohorts}

    # -- routing -----------------------------------------------------------
    def _cohort_depth(self, cohort):
        depth = 0
        for (c, _), s in self._stats_cache.items():
            if c == cohort:
                depth += int(s.get("queue_depth", 0)) \
                    + int(s.get("running", 0))
        return depth

    def _candidates(self, cohort=None):
        with self._lock:
            cohorts = ([cohort] if cohort is not None
                       else sorted(self.members,
                                   key=self._cohort_depth))
            now = time.monotonic()
            rr = next(self._rr)
            alive, dead = [], []
            for c in cohorts:
                ms = self.members.get(c, [])
                for i in range(len(ms)):
                    client = ms[(i + rr) % len(ms)]
                    if self._dead.get(client.base_url, 0) > now:
                        dead.append(client)
                    else:
                        alive.append(client)
            # Dead members are last-resort candidates, not excluded:
            # if everyone else backpressures we still try them (they
            # may have recovered inside the grace window).
            return alive + dead

    def _mark_dead(self, client):
        with self._lock:
            self._dead[client.base_url] = time.monotonic() + DEAD_GRACE_S

    def generate(self, payload):
        """Forward one request; ``(status, body)``. Transport failures
        re-route; a ``migrated`` response is followed to the new host
        (the stream continues there with zero re-prefill); uniform
        backpressure returns 429 + a per-request-jittered
        Retry-After."""
        request_id = None
        if isinstance(payload, dict):
            request_id = payload.get("id")
            # Ask workers for the raw handoff record instead of having
            # them proxy a migrated stream — the router follows it and
            # keeps the fallback ladder (replay on the next candidate)
            # in one place.
            payload["handoff"] = "return"
        candidates = self._candidates(payload.pop("cohort", None)
                                      if isinstance(payload, dict)
                                      else None)
        if not candidates:
            return 503, {"error": "no serving workers registered"}
        backpressured = failed = draining = False
        retry_hint = 0.0
        for client in candidates:
            try:
                status, body = client.generate(payload)
            except _TRANSPORT_ERRORS as e:
                # The worker vanished — possibly with this request
                # already decoding. Deterministic generation makes the
                # retry exact; re-route to the next candidate.
                self._log.warning(
                    "serving router: %s failed mid-request (%s); "
                    "re-routing", client.base_url, e)
                self._mark_dead(client)
                failed = True
                continue
            if status == 200 and body.get("state") == "migrated":
                status, body = self._follow_handoff(body)
                if status != 200:
                    # Handoff lost (the peer died before the stream
                    # was claimed): fall back to replaying the request
                    # on the next candidate — recompute, the status
                    # quo.
                    failed = True
                    continue
            if status == 200:
                with self._lock:
                    self.accepted += 1
                    self.completed += 1
                    if failed:
                        self.rerouted += 1
                if failed:
                    _m.rerouted_total().inc()
                return status, body
            if status in (429, 503):
                if body.get("error") == "draining":
                    draining = True
                else:
                    backpressured = True
                    # Honor the most conservative worker-supplied
                    # (already jittered) Retry-After hint.
                    try:
                        retry_hint = max(
                            retry_hint,
                            float(body.get("retry_after") or 0.0))
                    except (TypeError, ValueError):
                        pass
                continue
            if 400 <= status < 500:
                # Deterministic client errors (400 malformed, 413 too
                # large for the pool/budget) — retrying the identical
                # doomed request on other members only multiplies the
                # failure; hand it straight back.
                return status, body
            failed = True            # 5xx: try the next member
        if backpressured:
            with self._lock:
                self.rejected += 1
            _m.rejected_total("overload").inc()
            return 429, {"error": "all serving cohorts at queue limit",
                         "retry_after": retry_hint
                         or retry_after_jitter(request_id)}
        if draining:
            with self._lock:
                self.rejected += 1
            _m.rejected_total("draining").inc()
            return 503, {"error": "all serving cohorts draining"}
        return 503, {"error": "no serving worker reachable"}

    # -- migration handoff -------------------------------------------------
    def _client_for(self, url):
        """A client for a handoff target: the known member with that
        base URL when we have one (keeps its dead-marking state), else
        a fresh WorkerClient on the KV token."""
        base = url.rstrip("/")
        with self._lock:
            for clients in self.members.values():
                for client in clients:
                    if client.base_url == base:
                        return client
        token = self.kv[2] if self.kv is not None else ""
        return WorkerClient(base, token=token)

    def _follow_handoff(self, body, hops=HANDOFF_HOPS):
        """Chase a migrated stream to the host now decoding it; the
        final ``(status, body)``. The continuation is the *same*
        sequence — imported KV pages, zero re-prefill — so the client
        stream completes token-exact without replaying the prompt.
        Any failure returns non-200 and the caller falls back to the
        replay (recompute) ladder."""
        for _ in range(hops):
            handoff = body.get("handoff") or {}
            url, rid = handoff.get("url"), handoff.get("id")
            if not url or not rid:
                return 502, {"error": "malformed handoff record"}
            client = self._client_for(url)
            try:
                status, body = client.generate(
                    {"attach": rid, "handoff": "return"})
            except _TRANSPORT_ERRORS as e:
                self._log.warning(
                    "serving router: handoff target %s unreachable "
                    "(%s); falling back to re-route", url, e)
                self._mark_dead(client)
                return 502, {"error": "handoff target unreachable"}
            if status == 200 and body.get("state") == "migrated":
                continue             # moved again: follow the chain
            if status == 200:
                with self._lock:
                    self.handoffs += 1
            return status, body
        return 502, {"error": "handoff chain unresolved"}

    # HTTP-surface aliases (the runner server dispatches on these).
    def handle_generate(self, payload):
        return self.generate(payload)

    def handle_drain(self, payload=None):
        cohort = (payload or {}).get("cohort")
        if not cohort:
            return 400, {"error": "drain needs a cohort"}
        return 200, self.drain_cohort(cohort)

    # -- stats / cohort view -----------------------------------------------
    def _kv_stats(self):
        from ..runner import http_client
        addr, port, token = self.kv
        fresh = {}
        for cohort, clients in list(self.members.items()):
            wids = sorted({self._wid_of(c, i)
                           for i, c in enumerate(clients)}) or [0]
            for wid in wids:
                raw = http_client.get_kv(
                    addr, port, "serving", f"stats.{cohort}.{wid}",
                    token=token, retries=0, deadline=2.0)
                if raw is not None:
                    fresh[(cohort, wid)] = json.loads(raw)
        return fresh

    def refresh_stats(self):
        """Refresh the cohort view: KV-plane snapshots when available,
        direct member scrapes otherwise; on KV trouble, keep serving
        from the last-known view (``source`` = ``local``)."""
        if self.kv is not None:
            try:
                fresh = self._kv_stats()
            except Exception as e:  # noqa: BLE001 — KV blackout: degrade
                self._log.warning(
                    "serving router: KV stats unavailable (%s); "
                    "serving from local view", e)
                with self._lock:
                    self._source = "local"
                return self._source
            with self._lock:
                self._stats_cache.update(fresh)
                self._source = "kv"
            return self._source
        fresh = {}
        for cohort, clients in list(self.members.items()):
            for i, client in enumerate(clients):
                try:
                    fresh[(cohort, self._wid_of(client, i))] = \
                        client.stats()
                except _TRANSPORT_ERRORS as e:
                    # Stale beats absent, but never silently (HVD213):
                    # an operator watching the log can tell a scrape
                    # gap from a healthy idle worker.
                    self._log.debug(
                        "serving router: stats scrape of %s failed "
                        "(%s); serving last-known view",
                        client.base_url, e)
                    continue
        with self._lock:
            self._stats_cache.update(fresh)
            self._source = "local"
        return self._source

    def stats(self):
        self.refresh_stats()
        with self._lock:
            cohorts = {}
            for (cohort, i), s in self._stats_cache.items():
                c = cohorts.setdefault(
                    cohort, {"members": {}, "queue_depth": 0,
                             "running": 0, "completed": 0,
                             "tokens_out": 0})
                c["members"][str(i)] = s
                c["queue_depth"] += int(s.get("queue_depth", 0))
                c["running"] += int(s.get("running", 0))
                c["completed"] += int(s.get("completed", 0))
                c["tokens_out"] += int(s.get("tokens_out", 0))
            return {
                "role": "router", "source": self._source,
                "cohorts": cohorts,
                "accepted": self.accepted, "completed": self.completed,
                "rerouted": self.rerouted, "rejected": self.rejected,
                "handoffs": self.handoffs,
            }

    # -- drain -------------------------------------------------------------
    def drain_cohort(self, cohort):
        """Set the KV drain flag (workers poll it) and tell reachable
        members directly; returns per-member acks."""
        acks = {}
        if self.kv is not None:
            from ..runner import http_client
            addr, port, token = self.kv
            try:
                http_client.put_kv(addr, port, "serving",
                                   f"drain.{cohort}", "1", token=token,
                                   retries=0, deadline=2.0)
                acks["kv_flag"] = True
            except Exception:  # noqa: BLE001 — direct drains still go out
                acks["kv_flag"] = False
        for i, client in enumerate(self.members.get(cohort, [])):
            try:
                status, _ = client.drain()
                acks[str(i)] = status == 200
            except _TRANSPORT_ERRORS as e:
                self._log.warning(
                    "serving router: direct drain of %s failed (%s); "
                    "the KV drain flag still reaches it",
                    client.base_url, e)
                acks[str(i)] = False
        return {"cohort": cohort, "acks": acks}

    # -- HTTP hosting ------------------------------------------------------
    def serve_http(self, addr="0.0.0.0", token=""):
        from ..runner.http_server import KVStoreServer
        self._server = KVStoreServer(job_token=token, addr=addr)
        self._server.serving_router = self
        return self._server.start()

    def stop_http(self):
        server = getattr(self, "_server", None)
        if server is not None:
            server.stop()
            self._server = None

"""Per-host serving worker: the continuous-batching loop, its HTTP
surface, and KV-plane registration + stats push (port of
``horovod_tpu/serving/worker.py``).

The worker's model and page pool live on its device — the GPU unless the
caller passes ``device="cpu"`` (without CUDA it raises) — and its
scheduler loop thread runs there.

One ``ServingWorker`` per serving host: it owns a
:class:`~.scheduler.Scheduler`, steps it on a dedicated loop thread,
and exposes ``POST /v1/generate`` / ``GET /v1/serving/stats`` /
``POST /v1/serving/drain`` through the runner HTTP server
(``serve_http``). Requests block their HTTP handler thread until the
stream completes — the *scheduler's* bounded queue is the only wait
station; a full queue answers 429 immediately (backpressure, never
buffering).

On the control plane the worker registers itself in the launcher KV
store (``serving`` scope, ``member.<cohort>.<wid>`` = ``host:port``)
and pushes a stats snapshot every ``stats_interval`` seconds
(``stats.<cohort>.<wid>``), which is what the router's cohort view and
the autoscaler consume. The same pump polls the cohort drain flag
(``drain.<cohort>``), so ``hvd-serve drain`` reaches workers through
the KV plane alone. Push/poll errors are swallowed — a KV blackout
degrades stats to stale, it never stops serving (the chaos matrix row
pins that).

Live migration (docs/serving.md "Live migration"): a registered worker
wires a :class:`~.migration.Migrator` into its scheduler, accepts
verified KV pages from peers through the token-gated
``POST /v1/serving/migrate_in`` route, and on drain or SIGTERM
hand-off pushes every live sequence to a peer so chip-return latency
decouples from stream length. A stream that migrated away finishes
locally with a ``handoff`` record; the router (or this worker, for
direct clients) follows it to the new host, where the continuation is
token-exact with zero re-prefill.
"""

import collections
import itertools
import json
import threading
import time

import torch

from .. import chaos
from ..exceptions import ChaosInjectedError
from ..utils import envparse
from ..utils.logging_util import get_logger
from . import metrics as _m
from . import migration
from .kv_cache import DigestMismatch, MigrationError, NoHeadroom
from .model import ToyLM
from .router import WorkerClient, _TRANSPORT_ERRORS, retry_after_jitter
from .scheduler import Request, Scheduler

#: serving control-plane scope in the launcher KV store.
SERVING_SCOPE = "serving"
#: loop sleep when there is nothing to schedule.
_IDLE_SLEEP_S = 0.002
#: default seconds between stats pushes / drain-flag polls.
STATS_INTERVAL_S = 0.5
#: bound of the attach registry (migrated-in streams awaiting their
#: follower); completed entries are evicted oldest-first at the cap.
ATTACH_CAP = 512
#: handoff hops a worker follows for a direct (router-less) client.
HANDOFF_HOPS = 4


def knob_defaults():
    """The serving knob family resolved through envparse
    (docs/knobs.md)."""
    return {
        "max_batch_tokens": envparse.get_int(
            envparse.SERVING_MAX_BATCH_TOKENS, 256),
        "queue_limit": envparse.get_int(envparse.SERVING_QUEUE_LIMIT, 64),
        "num_pages": envparse.get_int(envparse.SERVING_KV_PAGES, 256),
        "page_size": envparse.get_int(envparse.SERVING_KV_PAGE_SIZE, 16),
        "drain_timeout": envparse.get_float(
            envparse.SERVING_DRAIN_TIMEOUT, 30.0),
    }


class ServingWorker:
    """One serving host: scheduler loop + HTTP + KV registration."""

    def __init__(self, model=None, cohort="c0", wid=0, *,
                 scheduler=None, max_batch_tokens=None, queue_limit=None,
                 num_pages=None, page_size=None, watermark=None,
                 request_timeout_s=120.0, migrate=True, device=None):
        knobs = knob_defaults()
        self.model = model if model is not None else ToyLM(device=device)
        self.device = getattr(self.model, "device", None)
        self.cohort = str(cohort)
        self.wid = int(wid)
        if scheduler is None:
            scheduler = Scheduler(
                self.model,
                max_batch_tokens=(max_batch_tokens
                                  or knobs["max_batch_tokens"]),
                queue_limit=queue_limit or knobs["queue_limit"],
                num_pages=num_pages or knobs["num_pages"],
                page_size=page_size or knobs["page_size"],
                watermark=watermark)
        self.scheduler = scheduler
        self.request_timeout_s = float(request_timeout_s)
        self.drain_timeout_s = knobs["drain_timeout"]
        self._stop = threading.Event()
        self._reqno = itertools.count(1)
        self._loop_thread = None
        self._pump_thread = None
        self._server = None
        self._kv = None      # (addr, port, token) once registered
        self._log = get_logger()
        # -- live migration ------------------------------------------------
        self._migrate = bool(migrate)
        self.migrator = None         # wired at register()
        self.elastic_version = envparse.get_str(
            envparse.ELASTIC_VERSION, "0")
        self.scheduler.elastic_version = self.elastic_version
        self._token = ""             # job token, for peer hand-offs
        self._staging = migration.InboundStaging(
            ttl_s=max(10.0, 2 * migration.knobs()["deadline"]))
        self._attached = collections.OrderedDict()  # rid -> result
        self._attached_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._loop_thread is not None:
            return self
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"hvd-serving-{self.cohort}.{self.wid}")
        self._loop_thread.start()
        return self

    def _loop(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            composition = self.scheduler.step()
            if not composition:
                # Nothing running: wait for arrivals without burning
                # a core (bounded sleep, not a blocking get — drain
                # and stop must stay responsive).
                self._stop.wait(_IDLE_SLEEP_S)

    def stop(self):
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
            self._loop_thread = None
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)
            self._pump_thread = None
        if self._server is not None:
            self._server.stop()
            self._server = None

    # -- HTTP surface ------------------------------------------------------
    def serve_http(self, addr="0.0.0.0", token=""):
        """Start a runner HTTP server with this worker attached;
        returns the bound port."""
        from ..runner.http_server import KVStoreServer
        self._server = KVStoreServer(job_token=token, addr=addr)
        self._server.serving_worker = self
        self._token = token or self._token
        port = self._server.start()
        return port

    def handle_generate(self, payload):
        """``(status, body)`` for one request — called from an HTTP
        handler thread (or directly by InProcClient). Blocks until the
        stream completes; 429 body carries a per-request-jittered
        ``retry_after``. A ``{"attach": id}`` payload claims the stream
        of a migrated-in sequence instead of submitting a new one."""
        if not isinstance(payload, dict):
            # A JSON array/scalar body must be a 400, not an
            # AttributeError that resets the connection (the router
            # would read that as a dead worker).
            return 400, {"error": "bad request: body must be a JSON "
                                  "object"}
        if payload.get("attach") is not None:
            return self._handle_attach(payload)
        client_id = str(payload.get("id") or f"r{next(self._reqno)}")
        try:
            # Scheduler ids must be unique per worker lifetime — a
            # client-chosen id re-routed here after a retry must not
            # collide with an in-flight sequence's table entry.
            req = Request(f"{client_id}#{next(self._reqno)}",
                          payload["prompt"],
                          payload.get("max_new_tokens", 16))
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"bad request: {e}"}
        result = self.scheduler.submit(req)
        if result is None:
            reason = "draining" if self.scheduler.draining \
                else "queue_full"
            _m.rejected_total(reason).inc()
            status = 503 if reason == "draining" else 429
            # Deterministic per-request jitter: synchronized client
            # retries de-herd instead of arriving at the same tick.
            return status, {"error": reason,
                            "retry_after": retry_after_jitter(client_id)}
        try:
            tokens = result.tokens(timeout=self.request_timeout_s)
        except TimeoutError:
            self._log.warning(
                "serving %s.%d: request %s exceeded %.0fs; answering "
                "504", self.cohort, self.wid, client_id,
                self.request_timeout_s)
            return 504, {"error": "generation timed out",
                         "id": client_id}
        summary = dict(result.summary)
        summary["id"] = client_id  # report the caller's id, not the
        #                            suffixed scheduler-unique one
        if summary.get("state") == "migrated":
            return self._reply_migrated(payload, summary, client_id)
        if summary.get("state") != "done":
            # A request the pool/budget can never serve is the
            # client's error (413) — the router must hand it back, not
            # retry it on every member. Runtime failures stay 500.
            status = 413 if summary.get("reason") == "too_large" \
                else 500
            return status, {"error": summary.get("error", "failed"),
                            "id": client_id,
                            "state": summary.get("state")}
        summary["worker"] = f"{self.cohort}.{self.wid}"
        summary["tokens"] = tokens
        return 200, summary

    # -- live migration ----------------------------------------------------
    def _reply_migrated(self, payload, summary, client_id):
        """The stream moved to a peer mid-request. The router asks for
        the raw handoff (``handoff: "return"``) and follows it itself;
        a direct client gets transparency — this worker follows the
        chain and returns the final tokens."""
        handoff = summary.get("handoff") or {}
        if payload.get("handoff") == "return":
            return 200, {"id": client_id, "state": "migrated",
                         "handoff": handoff,
                         "migrations": summary.get("migrations", 1)}
        return self._follow_handoff(handoff, client_id)

    def _follow_handoff(self, handoff, client_id):
        """Chase a migrated stream to its new host (bounded hops);
        ``(status, body)``. A 502 tells the router/client to fall back
        to replaying the request (recompute — never worse than the
        status quo)."""
        url, rid = handoff.get("url"), handoff.get("id")
        for _ in range(HANDOFF_HOPS):
            if not url or not rid:
                break
            client = WorkerClient(url, token=self._token,
                                  timeout_s=self.request_timeout_s)
            try:
                status, body = client.generate(
                    {"attach": rid, "handoff": "return"})
            except _TRANSPORT_ERRORS as e:
                self._log.warning(
                    "serving %s.%d: migrated peer %s unreachable (%s); "
                    "caller falls back to re-route", self.cohort,
                    self.wid, url, e)
                return 502, {"error": "migrated peer unreachable",
                             "id": client_id}
            if status == 200 and body.get("state") == "migrated":
                nxt = body.get("handoff") or {}
                url, rid = nxt.get("url"), nxt.get("id")
                continue
            if status == 200 and isinstance(body, dict):
                body["id"] = client_id
            return status, body
        return 502, {"error": "handoff chain unresolved",
                     "id": client_id}

    def _handle_attach(self, payload):
        """Claim the continuation stream of a migrated-in sequence."""
        rid = str(payload["attach"])
        with self._attached_lock:
            result = self._attached.get(rid)
        if result is None:
            return 404, {"error": f"unknown attach id {rid!r}"}
        try:
            tokens = result.tokens(timeout=self.request_timeout_s)
        except TimeoutError:
            self._log.warning(
                "serving %s.%d: attached stream %s exceeded %.0fs; "
                "answering 504", self.cohort, self.wid, rid,
                self.request_timeout_s)
            return 504, {"error": "generation timed out", "id": rid}
        summary = dict(result.summary)
        client_id = rid.split("#", 1)[0]
        summary["id"] = client_id
        if summary.get("state") == "migrated":
            return self._reply_migrated(payload, summary, client_id)
        if summary.get("state") != "done":
            return 500, {"error": summary.get("error", "failed"),
                         "id": client_id,
                         "state": summary.get("state")}
        summary["worker"] = f"{self.cohort}.{self.wid}"
        summary["tokens"] = tokens
        return 200, summary

    def _attach_put(self, rid, result):
        """Register a migrated-in stream for its follower; bounded —
        completed entries are evicted oldest-first at the cap."""
        with self._attached_lock:
            while len(self._attached) >= ATTACH_CAP:
                done = [k for k, r in self._attached.items()
                        if r.done.is_set()]
                if not done:
                    break
                del self._attached[done[0]]
            self._attached[rid] = result

    def handle_migrate_in(self, payload):
        """``(status, body)`` for one inbound migrate chunk (the
        token-gated ``POST /v1/serving/migrate_in`` route). Chunks
        stage in a bounded buffer; the commit chunk verifies the
        elastic-version fence, then places pages all-or-nothing
        against the watermark (scheduler.import_remote). Every refusal
        is counted in ``hvd_serving_migrations_total{outcome}``."""
        if not isinstance(payload, dict):
            return 400, {"error": "bad request: body must be a JSON "
                                  "object"}
        try:
            chaos.inject("migrate_in", key=str(payload.get("mid", "")),
                         name=f"{self.cohort}.{self.wid}")
        except chaos.ChaosSignal as sig:
            if sig.action == "corrupt":
                migration._corrupt_payload(payload.get("pages") or [])
        except ChaosInjectedError as e:
            return 503, {"error": f"chaos: {e}", "retry_after": 0.05}
        if self.scheduler.draining:
            # A draining worker is shedding sequences, not absorbing
            # them — a deterministic refusal, the source tries the
            # next peer.
            _m.migrations_total("draining").inc()
            return 409, {"error": "draining"}
        try:
            record = self._staging.offer(payload)
        except migration.StagingFull as e:
            return 429, {"error": "migrate staging full",
                         "detail": str(e),
                         "retry_after": retry_after_jitter(
                             payload.get("mid", ""), base=0.1)}
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"bad migrate chunk: {e}"}
        if record is None:
            return 200, {"staged": payload.get("chunk")}
        if str(record.get("elastic_version", "0")) \
                != str(self.elastic_version):
            _m.migrations_total("version_fence").inc()
            self._log.warning(
                "serving %s.%d: migrate-in of %s fenced: record "
                "version %r vs worker version %r", self.cohort,
                self.wid, record.get("id"),
                record.get("elastic_version"), self.elastic_version)
            return 409, {"error": "version_fenced",
                         "record_version": record.get(
                             "elastic_version"),
                         "worker_version": self.elastic_version}
        try:
            rid, result = self.scheduler.import_remote(record)
        except NoHeadroom as e:
            _m.migrations_total("no_headroom").inc()
            self._log.warning(
                "serving %s.%d: migrate-in of %s refused: %s",
                self.cohort, self.wid, record.get("id"), e)
            return 409, {"error": "no_headroom", "detail": str(e)}
        except DigestMismatch as e:
            _m.migrations_total("digest_mismatch").inc()
            self._log.warning(
                "serving %s.%d: migrate-in of %s REJECTED on digest: "
                "%s", self.cohort, self.wid, record.get("id"), e)
            return 422, {"error": "digest_mismatch", "detail": str(e)}
        except MigrationError as e:
            _m.migrations_total("refused").inc()
            self._log.warning(
                "serving %s.%d: migrate-in of %s refused: %s",
                self.cohort, self.wid, record.get("id"), e)
            return 422, {"error": "geometry_mismatch",
                         "detail": str(e)}
        self._attach_put(rid, result)
        self._log.info(
            "serving %s.%d: imported %s (%d pages, %d tokens done) "
            "from a peer", self.cohort, self.wid, rid,
            len(record.get("pages", ())),
            len(record.get("generated", ())))
        return 200, {"state": "imported", "id": rid,
                     "cohort": self.cohort, "wid": self.wid}

    def migrate_all_out(self):
        """Push every live sequence to a peer (drain / SIGTERM
        hand-off); the count moved — 0 when migration is not wired or
        every transfer fell back."""
        if self.scheduler.migrator is None:
            return 0
        return self.scheduler.migrate_all_out()

    def _kick_migrate_out(self):
        """Start the drain hand-off without blocking the caller (HTTP
        handler / stats pump)."""
        if self.scheduler.migrator is None:
            return
        threading.Thread(
            target=self.scheduler.migrate_all_out, daemon=True,
            name=f"hvd-serving-migrate-{self.cohort}.{self.wid}"
        ).start()

    def handoff(self):
        """SIGTERM hand-off: stop admitting, migrate everything live
        to peers, leave the recompute fallback to finish the rest.
        Returns the number migrated."""
        self.scheduler.drain()
        moved = self.migrate_all_out()
        self._log.warning(
            "serving %s.%d: hand-off migrated %d live sequence(s)",
            self.cohort, self.wid, moved)
        return moved

    def handle_drain(self, payload=None):
        self.scheduler.drain()
        self._kick_migrate_out()
        return 200, {"draining": True,
                     "cohort": self.cohort, "wid": self.wid}

    def stats(self):
        s = self.scheduler.stats()
        s.update(cohort=self.cohort, wid=self.wid, role="worker")
        return s

    # -- drain -------------------------------------------------------------
    def drain(self, timeout=None):
        """Stop admitting, migrate live sequences to peers where the
        migration plane is wired, and wait for what remains to
        complete. Returns True when fully drained within the
        timeout."""
        self.scheduler.drain()
        self.migrate_all_out()
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.drain_timeout_s)
        while time.monotonic() < deadline:
            if self.scheduler.idle():
                return True
            time.sleep(0.01)
        return self.scheduler.idle()

    # -- KV-plane registration + stats push --------------------------------
    def register(self, kv_addr, kv_port, token="", advertise=None):
        """Announce this worker under ``serving/member.<cohort>.<wid>``
        and start the stats/drain pump."""
        from ..runner import http_client
        self._kv = (kv_addr, int(kv_port), token)
        self._token = token or self._token
        if self._migrate and self.migrator is None:
            # Peers authenticate with the same job token; discovery
            # rides the member keys this very registration writes.
            self.migrator = migration.Migrator(
                self.cohort, self.wid, kv=self._kv, token=token)
            self.scheduler.migrator = self.migrator
        if advertise:
            member_key = f"member.{self.cohort}.{self.wid}"
            http_client.put_kv(
                kv_addr, kv_port, SERVING_SCOPE, member_key, advertise,
                token=token)

            def _reregister():
                # Serving membership is EPHEMERAL on the HA contract
                # (docs/fault_tolerance.md): after a control-plane
                # failover the journal deliberately carries no member
                # keys, so each worker re-announces itself against the
                # new primary (the stats pump self-heals on its own).
                addr, port, tok = self._kv
                http_client.put_kv(addr, port, SERVING_SCOPE,
                                   member_key, advertise, token=tok,
                                   retries=2, deadline=5.0)

            http_client.on_new_primary(
                f"serving.member.{self.cohort}.{self.wid}", _reregister)
        if self._pump_thread is None:
            self._pump_thread = threading.Thread(
                target=self._stats_pump, daemon=True,
                name=f"hvd-serving-stats-{self.cohort}.{self.wid}")
            self._pump_thread.start()

    def push_stats_once(self):
        """One stats push + drain-flag poll; KV trouble is swallowed
        (stale stats beat a dead worker). Returns True on success."""
        from ..runner import http_client
        if self._kv is None:
            return False
        addr, port, token = self._kv
        try:
            http_client.put_kv(
                addr, port, SERVING_SCOPE,
                f"stats.{self.cohort}.{self.wid}",
                json.dumps(self.stats()), token=token,
                retries=0, deadline=2.0)
            flag = http_client.get_kv(
                addr, port, SERVING_SCOPE, f"drain.{self.cohort}",
                token=token, retries=0, deadline=2.0)
            if not (flag and flag.strip() == b"1"):
                # Per-worker drain: the fleet arbiter ebbs chips back
                # to training one worker at a time, which must not
                # drain the survivors of the same cohort.
                flag = http_client.get_kv(
                    addr, port, SERVING_SCOPE,
                    f"drain.{self.cohort}.{self.wid}",
                    token=token, retries=0, deadline=2.0)
            if flag and flag.strip() == b"1" \
                    and not self.scheduler.draining:
                self._log.warning(
                    "serving %s.%d: drain flag set on the KV plane; "
                    "admission stopped", self.cohort, self.wid)
                self.scheduler.drain()
                # Drain-via-migration: live sequences move to peers so
                # the fleet arbiter gets its chips back in transfer
                # time, not longest-stream time (fallback: they finish
                # locally as before).
                self._kick_migrate_out()
            return True
        except Exception as e:  # noqa: BLE001 — stats are best-effort
            self._log.debug("serving stats push failed: %s", e)
            return False

    def _stats_pump(self):
        while not self._stop.is_set():
            self.push_stats_once()
            self._stop.wait(STATS_INTERVAL_S)

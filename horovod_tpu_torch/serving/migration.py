"""KV-cache live migration: verified page transfer between serving
hosts (port of ``horovod_tpu/serving/migration.py``; the wire protocol is
the JAX package's, so either package's worker takes the other's records).

Recompute-on-preempt (scheduler.py) and reroute-on-death (router.py)
both re-prefill the victim's whole prompt+generation, so recovery cost
grows with context length and drain time is bounded by the longest
in-flight stream. Migration moves the state instead of rebuilding it:
the source exports a sequence's KV pages (kv_cache.export_sequence,
one sha256 digest per page), ships them to a capacity-bearing peer
over ``POST /v1/serving/migrate_in`` — chunked to
``HVDTPU_SERVING_MIGRATE_MAX_BYTES``, each chunk retried on the
runner's exp-backoff/deadline machinery, the whole transfer fenced by
elastic version — and the target places them all-or-nothing against
its own watermark before resuming decode from the migrated position.

**Graceful degradation is the contract**: every failure leg — digest
mismatch, timeout, no peer headroom, version fence — is counted in
``hvd_serving_migrations_total{outcome}`` and falls back loudly to the
status-quo recompute/reroute path, so a broken migration plane can
slow recovery but never lose an accepted request. Chaos points
``migrate_out``/``migrate_in`` (fail/delay/corrupt) make each leg
injectable.

Wire protocol (one migration = 1..N chunk POSTs, same ``mid``)::

    {"mid": m, "chunk": i, "total": N, "pages": [{payload, digest}..]}
    ... last chunk additionally: {"meta": {...}, "commit": true}

Non-final chunks ack ``{"staged": i}``; the commit chunk answers
``{"state": "imported", "id": <local id>, ...}`` — the handoff the
router follows — or a refusal: 409 ``no_headroom``/``version_fenced``/
``draining`` (structural: try another peer or fall back), 422
``digest_mismatch``/``geometry_mismatch`` (the payload is bad), 413
``too_large`` (a single chunk over the byte bound), 429/5xx retryable.
"""

import itertools
import json
import os
import threading
import time
import urllib.error

from .. import chaos
# The migration handshake's state machine lives in the protocol spec
# (spec-is-implementation — analysis/protocol/migration_spec.py is the
# module a model checker explores, and this module executes the exact
# same chunking/staging/refusal functions). This file owns everything
# impure: sockets, retries, locks, the real clock, metrics.
from ..analysis.protocol import migration_spec
from ..exceptions import ChaosInjectedError
from ..utils import envparse
from ..utils.logging_util import get_logger
from . import metrics as _m
from .kv_cache import MigrationError

#: token-gated route on the runner HTTP server (worker targets only).
MIGRATE_PATH = "/v1/serving/migrate_in"
#: member slots probed per cohort during peer discovery.
MAX_MEMBERS = 32

DEFAULT_RETRIES = 3
DEFAULT_DEADLINE_S = 5.0
DEFAULT_MAX_BYTES = 4 * 1024 * 1024

_midno = itertools.count(1)


class VersionFenced(MigrationError):
    """The record was exported under a different elastic version than
    the target is serving — membership changed mid-flight; the source
    falls back to recompute rather than resume against a stale view."""


class MigrationRefused(MigrationError):
    """The target refused the transfer with a deterministic 4xx; the
    ``outcome`` attribute names the leg for the metrics/fallback."""

    def __init__(self, outcome, message):
        super().__init__(message)
        self.outcome = str(outcome)


class StagingFull(MigrationError):
    """Inbound staging is at its bound — the target answers 429 and
    the source's chunk retry (or fallback) takes it from there."""


def knobs():
    """The migration knob family resolved through envparse
    (docs/knobs.md)."""
    return {
        "retries": envparse.get_int(
            envparse.SERVING_MIGRATE_RETRIES, DEFAULT_RETRIES),
        "deadline": envparse.get_float(
            envparse.SERVING_MIGRATE_DEADLINE, DEFAULT_DEADLINE_S),
        "max_bytes": envparse.get_int(
            envparse.SERVING_MIGRATE_MAX_BYTES, DEFAULT_MAX_BYTES),
    }


# -- wire helpers ----------------------------------------------------------
def _parse_url(url):
    """(addr, port) of an ``http://host:port`` worker base URL."""
    rest = url.split("//", 1)[-1].rstrip("/")
    host, _, port = rest.partition(":")
    return host, int(port or 80)


#: Greedy page packing — the spec function, re-exported for the wire
#: layer and tests.
chunk_pages = migration_spec.chunk_pages


def _corrupt_payload(pages):
    """Chaos ``corrupt`` effect: flip one character of the first
    non-empty page payload (the digest was computed before the flip,
    so verification must refuse the import)."""
    for pg in pages:
        payload = pg.get("payload", "")
        if payload:
            flipped = ("B" if payload[0] != "B" else "C") + payload[1:]
            pg["payload"] = flipped
            return True
    return False


def migrate_out(url, record, token="", retries=None, deadline=None,
                max_bytes=None):
    """Ship one exported sequence record to the worker at ``url``;
    returns the target's commit body (the handoff the router follows).

    Each chunk POST rides the runner retry engine (exp backoff +
    jitter, per-chunk ``deadline``); deterministic 4xx refusals raise
    :class:`MigrationRefused` immediately, retry exhaustion raises
    ``KVRetryExhaustedError`` (a TimeoutError). Callers map both to
    the recompute fallback."""
    from ..runner import http_client
    cfg = knobs()
    retries = cfg["retries"] if retries is None else int(retries)
    deadline = cfg["deadline"] if deadline is None else float(deadline)
    max_bytes = (cfg["max_bytes"] if max_bytes is None
                 else int(max_bytes))
    addr, port = _parse_url(url)
    meta = {k: v for k, v in record.items() if k != "pages"}
    chunks = chunk_pages(record.get("pages", []), max_bytes)
    mid = f"{record.get('id', '?')}@{os.getpid()}.{next(_midno)}"
    out = None
    for ci, chunk in enumerate(chunks):
        body = {"mid": mid, "chunk": ci, "total": len(chunks),
                "pages": chunk}
        if ci == len(chunks) - 1:
            body["meta"] = meta
            body["commit"] = True

        def attempt(a, p, _body=body, _ci=ci):
            try:
                chaos.inject("migrate_out", key=str(record.get("id")),
                             name=mid, kind=f"chunk{_ci}")
            except chaos.ChaosSignal as sig:
                if sig.action == "corrupt":
                    _corrupt_payload(_body["pages"])
                else:
                    raise ChaosInjectedError(str(sig))
            data = json.dumps(_body).encode()
            if len(data) > max_bytes * 2:
                # One page alone blew the byte bound: deterministic,
                # shipping it anyway would just bounce off the target.
                raise MigrationRefused(
                    "too_large",
                    f"migrate chunk {_ci} is {len(data)} bytes against "
                    f"a {max_bytes} bound")
            try:
                resp = http_client._request(
                    "POST", f"http://{a}:{p}{MIGRATE_PATH}", data=data,
                    token=token, timeout=max(deadline, 1.0))
            except urllib.error.HTTPError as e:
                if 400 <= e.code < 500 and e.code not in (408, 425,
                                                          429):
                    raw = e.read()
                    try:
                        parsed = json.loads(raw) if raw else {}
                    except ValueError:
                        parsed = {}
                    outcome = parsed.get("error") or f"http_{e.code}"
                    raise MigrationRefused(
                        outcome,
                        f"peer {a}:{p} refused migrate chunk {_ci}: "
                        f"HTTP {e.code} {outcome}") from e
                raise
            with resp:
                return json.loads(resp.read() or b"{}")

        out = http_client._call(
            "migrate", "serving", f"{record.get('id', '?')}/{ci}",
            attempt, addr, port, retries=retries, deadline=deadline)
    return out


# -- target side -----------------------------------------------------------
class InboundStaging:
    """Bounded reassembly buffers for in-flight inbound migrations —
    at most ``max_staged`` concurrent transfers, each bounded by the
    sender's chunk size (HVD210: this is a fixed-size wait station,
    not a queue). Stale entries (an aborted sender) expire after
    ``ttl_s``."""

    def __init__(self, max_staged=8, ttl_s=30.0):
        self.max_staged = int(max_staged)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._entries = {}   # mid -> {chunks, total, meta, t}

    def offer(self, payload):
        """Stage one chunk; the assembled record when the migration is
        complete, else None. Raises KeyError/ValueError on a malformed
        chunk and :class:`StagingFull` at the bound. The transition
        itself is migration_spec.stage_chunk — this wrapper adds the
        lock and the real clock."""
        with self._lock:
            try:
                return migration_spec.stage_chunk(
                    self._entries, payload,
                    max_staged=self.max_staged, ttl_s=self.ttl_s,
                    now=time.monotonic())
            except migration_spec.StagingLimit as exc:
                raise StagingFull(str(exc)) from exc

    def depth(self):
        with self._lock:
            return len(self._entries)


# -- source-side policy ----------------------------------------------------
class Migrator:
    """Source-side migrate-out policy: peer discovery over the KV
    member plane plus the graceful-fallback transfer loop. One per
    worker; the scheduler calls :meth:`migrate_seq` with an exported
    record and falls back to recompute whenever it returns None."""

    #: seconds a discovered peer list stays cached.
    PEER_TTL_S = 1.0

    def __init__(self, cohort, wid, kv=None, token="", peers=None):
        self.cohort = str(cohort)
        self.wid = int(wid)
        self.kv = kv                  # (addr, port, token) or None
        self.token = token            # worker-auth token for migrate_in
        self._static_peers = list(peers) if peers is not None else None
        self._peer_cache = (0.0, [])
        self._log = get_logger()

    def peers(self):
        """[(wid, url)] of live cohort peers, self excluded — the KV
        member plane when configured, else the static test list."""
        if self._static_peers is not None:
            return list(self._static_peers)
        if self.kv is None:
            return []
        t, cached = self._peer_cache
        now = time.monotonic()
        if now - t < self.PEER_TTL_S:
            return list(cached)
        from ..runner import http_client
        addr, port, token = self.kv
        found = []
        for i in range(MAX_MEMBERS):
            if i == self.wid:
                continue
            try:
                raw = http_client.get_kv(
                    addr, port, "serving",
                    f"member.{self.cohort}.{i}", token=token,
                    retries=0, deadline=2.0)
            except Exception as e:  # noqa: BLE001 — KV blackout: no peers
                self._log.warning(
                    "serving migrate: peer discovery failed (%s); "
                    "falling back to recompute", e)
                return []
            if raw is None:
                continue
            url = raw.decode()
            found.append((i, url if url.startswith("http")
                          else f"http://{url}"))
        self._peer_cache = (now, found)
        return list(found)

    def migrate_seq(self, record):
        """Try every peer in turn; the handoff dict on success, None
        on fallback (every leg logged + counted — loud, never
        silent)."""
        t0 = time.monotonic()
        peers = self.peers()
        if not peers:
            _m.migrations_total("no_peer").inc()
            self._log.warning(
                "serving migrate: no peer for %s; falling back to "
                "recompute", record.get("id"))
            return None
        for wid, url in peers:
            try:
                body = migrate_out(url, record, token=self.token)
            except MigrationRefused as e:
                outcome, try_next = migration_spec.classify_refusal(
                    e.outcome)
                _m.migrations_total(outcome).inc()
                self._log.warning(
                    "serving migrate: peer %s refused %s (%s)",
                    url, record.get("id"), e)
                if try_next:
                    continue          # structural: another peer may fit
                return None           # payload/version: fallback now
            except TimeoutError as e:
                _m.migrations_total("timeout").inc()
                self._log.warning(
                    "serving migrate: transfer of %s to %s timed out "
                    "(%s); trying next peer", record.get("id"), url, e)
                continue
            except Exception as e:  # noqa: BLE001 — any other failure:
                #                     loud fallback, never worse than
                #                     the recompute status quo
                _m.migrations_total("error").inc()
                self._log.warning(
                    "serving migrate: transfer of %s to %s failed "
                    "(%s); trying next peer", record.get("id"), url, e)
                continue
            _m.migrations_total("complete").inc()
            _m.migrated_pages_total().inc(len(record.get("pages", ())))
            _m.migration_seconds().observe(time.monotonic() - t0)
            return {"url": url, "wid": wid,
                    "id": body.get("id"),
                    "cohort": body.get("cohort", self.cohort)}
        return None

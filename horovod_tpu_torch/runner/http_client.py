"""Retrying HTTP KV client used by workers to talk to the launcher's
rendezvous store (port of ``horovod_tpu/runner/http_client.py``;
reference: horovod/runner/http/http_client.py).

Every worker-driver exchange (peer rendezvous, elastic version polls,
commit persistence, heartbeats) rides on these four verbs. Each call
retries with exponential backoff and jitter under an overall deadline
(``HVDTPU_KV_RETRIES`` / ``HVDTPU_KV_BACKOFF`` / ``HVDTPU_KV_DEADLINE``),
with errors classified retryable or fatal:

- **retryable**: connection refused/reset/aborted, socket timeouts, DNS
  blips, mid-response disconnects, HTTP 408/425/429 and 5xx;
- **fatal**: every other HTTP status. 401/403 mean a bad or missing job
  token and would never succeed on retry; ``KVFatalError`` names the op,
  scope and key.

Retry exhaustion raises ``KVRetryExhaustedError``, a ``TimeoutError``, so
elastic's reset-retry loop classifies it as transient. Outcomes feed
``hvd_kv_retries_total{op,outcome}``.

**Control-plane HA** (docs/fault_tolerance.md "Control-plane HA"):
when ``HVDTPU_RENDEZVOUS_ADDRS`` carries an ordered endpoint list
(primary first, then standbys), a call whose per-endpoint retry budget
exhausts on connection-class errors *fails over* to the next endpoint
— counted in ``hvd_kv_endpoint_failover_total`` — and every later call
starts at the active endpoint. Responses carry the store's *term* and
an optional ``X-Hvd-Primary`` hint; the client adopts the highest term
it has seen, stamps it on writes, honors the hint, and surfaces a 409
term fence as ``TermFencedError`` naming both terms (after one retry
with the adopted term — a worker that merely lagged behind a failover
must succeed against the new primary, only a truly stale writer must
fail loud). ``on_new_primary`` registers re-registration hooks for
ephemeral keys (peer addresses, serving members) that are NOT
replicated through the journal and must be republished after a
takeover. With ``HVDTPU_RENDEZVOUS_ADDRS`` unset all of this is one
cached-None check per call.

``kv_get``/``kv_put``/``kv_delete``/``kv_wait`` are chaos injection
points (``chaos/``). Every verb goes through the sanitizer's blocking
tripwire in ``_request`` (``HVDTPU_SANITIZE``).
"""

import http.client
import random
import threading
import time
import urllib.error
import urllib.request

from ..analysis import sanitizer
from ..chaos import inject as _chaos_inject
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger
from .http_server import AUTH_HEADER, PRIMARY_HEADER, TERM_HEADER

DEFAULT_RETRIES = 8
DEFAULT_BACKOFF_S = 0.05
DEFAULT_DEADLINE_S = 30.0
_BACKOFF_CAP_S = 2.0
# Transient-by-contract statuses: request timeout, too-early, throttled.
_RETRYABLE_HTTP = {408, 425, 429}


class KVError(RuntimeError):
    """Base for KV client failures; message names op, scope and key."""


class KVFatalError(KVError):
    """Non-retryable KV failure (auth rejection, client error)."""

    def __init__(self, message, code=None):
        super().__init__(message)
        self.code = code


class TermFencedError(KVFatalError):
    """A write was rejected by the store's split-brain fence even
    after adopting the store's term — the writer's view of the control
    plane is authoritatively stale. Never retried."""

    def __init__(self, message, request_term=None, server_term=None):
        super().__init__(message, code=409)
        self.request_term = request_term
        self.server_term = server_term


class KVRetryExhaustedError(KVError, TimeoutError):
    """Retry budget or deadline exhausted on a retryable failure.
    Inherits TimeoutError (an OSError) so callers that treat transient
    transport trouble as recoverable — elastic's ``_retry_reset`` —
    classify it correctly without importing this module."""


def _m_retries():
    # Resolved at call time: NULL no-op when HOROVOD_TPU_METRICS is off.
    return telemetry.counter(
        "hvd_kv_retries_total",
        "KV client retry outcomes by operation",
        labelnames=("op", "outcome"))


def _m_failover():
    return telemetry.counter(
        "hvd_kv_endpoint_failover_total",
        "KV endpoint failovers (active rendezvous endpoint switched)")


# --------------------------------------------------------------------------
# Endpoint failover state (process-wide: the rendezvous store is one
# logical service no matter how many call sites hold its address).
# --------------------------------------------------------------------------

def parse_endpoints(text):
    """``host:port,host:port`` → ordered [(host, port)]; loud on a
    malformed element (a silently dropped standby would turn failover
    into a no-op exactly when it matters)."""
    endpoints = []
    for chunk in (text or "").split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        host, sep, port = chunk.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"HVDTPU_RENDEZVOUS_ADDRS element {chunk!r} is not "
                "host:port")
        try:
            endpoints.append((host, int(port)))
        except ValueError:
            raise ValueError(
                f"HVDTPU_RENDEZVOUS_ADDRS element {chunk!r} has a "
                "non-integer port")
    return endpoints


class _Failover:
    """Ordered endpoint list + active index + adopted term."""

    def __init__(self, endpoints):
        self.endpoints = endpoints
        self.active = 0
        self.callbacks = {}   # name -> fn, re-run on primary change

    def plan_for(self, addr, port):
        """Endpoint order for one call: active first, then the rest in
        ring order — or just the caller's endpoint when it is not part
        of the configured list (a serving/test store of its own)."""
        if (addr, port) not in self.endpoints:
            return [(addr, port)]
        n = len(self.endpoints)
        return [self.endpoints[(self.active + i) % n] for i in range(n)]


_STATE_LOCK = threading.RLock()
_FAILOVER = None          # tri-state: None = unresolved, False = off
_TERM = 0                 # highest store term observed by this process
_IN_CALLBACK = threading.local()


def _failover_state():
    global _FAILOVER
    with _STATE_LOCK:
        if _FAILOVER is None:
            text = envparse.get_str(envparse.RENDEZVOUS_ADDRS, "")
            _FAILOVER = _Failover(parse_endpoints(text)) if text \
                else False
        return _FAILOVER if _FAILOVER else None


def reset_failover():
    """Test hook: drop the endpoint list, adopted term and hooks so
    the next call re-resolves from the environment."""
    global _FAILOVER, _TERM
    with _STATE_LOCK:
        _FAILOVER = None
        _TERM = 0


def known_term():
    """The highest store term this process has observed (0 = none)."""
    with _STATE_LOCK:
        return _TERM


def note_term(term):
    global _TERM
    with _STATE_LOCK:
        if term > _TERM:
            _TERM = term


def active_endpoint(addr, port):
    """Where a call addressed to ``(addr, port)`` actually goes right
    now (identity unless that endpoint belongs to the failover list)."""
    fo = _failover_state()
    if fo is None:
        return addr, port
    with _STATE_LOCK:
        return fo.plan_for(addr, port)[0]


def on_new_primary(name, callback):
    """Register (idempotently, keyed by name) a hook run after the
    active endpoint changes — the re-registration path for *ephemeral*
    keys (peer addresses, serving members) the journal deliberately
    does not replicate. No-op when no endpoint list is configured."""
    fo = _failover_state()
    if fo is None:
        return
    with _STATE_LOCK:
        fo.callbacks[name] = callback


def _switch_active(fo, endpoint, reason):
    """Point the process at a new endpoint; fires the re-registration
    hooks (outside the lock, reentrancy-guarded: a hook's own KV write
    must not recurse into more hook runs)."""
    with _STATE_LOCK:
        try:
            idx = fo.endpoints.index(endpoint)
        except ValueError:
            return
        if idx == fo.active:
            return
        fo.active = idx
        callbacks = list(fo.callbacks.items())
    _m_failover().inc()
    get_logger().warning(
        "kv client: rendezvous endpoint failover to %s:%d (%s)",
        endpoint[0], endpoint[1], reason)
    if getattr(_IN_CALLBACK, "active", False):
        return
    _IN_CALLBACK.active = True
    try:
        for name, cb in callbacks:
            try:
                cb()
            except Exception as e:  # noqa: BLE001 — best-effort hooks
                get_logger().warning(
                    "kv client: re-registration hook %s failed after "
                    "failover: %s", name, e)
    finally:
        _IN_CALLBACK.active = False


def _note_headers(headers, fo):
    """Adopt term + primary hint from a response's HA headers."""
    if headers is None:
        return
    raw = headers.get(TERM_HEADER)
    if raw:
        try:
            note_term(int(raw))
        except ValueError:
            pass
    hint = headers.get(PRIMARY_HEADER)
    if hint and fo is not None:
        try:
            parsed = parse_endpoints(hint)
        except ValueError:
            return
        if parsed:
            _switch_active(fo, parsed[0], "primary hint")


def _url(addr, port, scope, key):
    return f"http://{addr}:{port}/{scope}/{key}"


def _request(method, url, data=None, token="", timeout=10, fo=None):
    # hvd-sanitize tripwire: every KV verb funnels through this urlopen,
    # so a collective-critical thread doing store I/O (outside a bounded
    # sanitizer.allowed() scope, such as the guardian board's short-budget
    # calls) is flagged here.
    sanitizer.check_blocking("urlopen", url)
    req = urllib.request.Request(url, data=data, method=method)
    if token:
        req.add_header(AUTH_HEADER, token)
    if method in ("PUT", "DELETE"):
        term = known_term()
        if term > 0:
            req.add_header(TERM_HEADER, str(term))
    resp = urllib.request.urlopen(req, timeout=timeout)
    _note_headers(resp.headers, fo)
    return resp


def probe_term(addr, port, token="", timeout=2):
    """The store's current term as advertised on its response headers
    (every route carries ``X-Hvd-Term``; /clock is the cheapest), or
    None when unreachable. The one probe primaries and standbys share —
    they must never disagree on how terms are observed."""
    try:
        with _request("GET", f"http://{addr}:{port}/clock", token=token,
                      timeout=timeout) as resp:
            return int(resp.headers.get(TERM_HEADER, 0))
    except urllib.error.HTTPError as e:
        try:
            return int(e.headers.get(TERM_HEADER, 0))
        except (TypeError, ValueError, AttributeError):
            return None
    except Exception:  # noqa: BLE001 — unreachable/refused/timeout
        return None


def _fatal_http(code):
    return not (code in _RETRYABLE_HTTP or code >= 500)


def _retry_params(retries, backoff, deadline):
    if retries is None:
        retries = envparse.get_int(envparse.KV_RETRIES, DEFAULT_RETRIES)
    if backoff is None:
        backoff = envparse.get_float(envparse.KV_BACKOFF,
                                     DEFAULT_BACKOFF_S)
    if deadline is None:
        deadline = envparse.get_float(envparse.KV_DEADLINE,
                                      DEFAULT_DEADLINE_S)
    return retries, backoff, deadline


def _fence_info(err):
    """(request_term, server_term) from a 409 term-fence body, or None
    when the 409 is something else."""
    import json
    try:
        body = json.loads(err.read().decode())
    except Exception:  # noqa: BLE001 — any unreadable body: not a fence
        return None
    if body.get("error") != "term_fenced":
        return None
    return body.get("request_term"), body.get("server_term")


def _call(op, scope, key, attempt_fn, addr, port, retries=None,
          backoff=None, deadline=None):
    """Run ``attempt_fn(addr, port)`` under the retry policy.
    HTTPError reaching here is already known non-404 (attempt_fn
    handles the existence contract); fatal statuses raise immediately
    with the op/scope/key named; retryable failures back off
    exponentially with jitter, failing over along the configured
    endpoint list when one endpoint's budget exhausts, until the
    overall deadline runs out."""
    retries, backoff, deadline_s = _retry_params(retries, backoff,
                                                 deadline)
    fo = _failover_state()
    plan = fo.plan_for(addr, port) if fo is not None else [(addr, port)]
    start = time.monotonic()
    deadline_t = start + deadline_s
    attempt = 0
    ep_idx = 0
    fence_retried = False
    while True:
        ep_addr, ep_port = plan[ep_idx]
        try:
            out = attempt_fn(ep_addr, ep_port)
        except urllib.error.HTTPError as e:
            _note_headers(getattr(e, "headers", None), fo)
            if e.code == 409:
                fence = _fence_info(e)
                if fence is not None:
                    req_term, srv_term = fence
                    if srv_term is not None:
                        note_term(int(srv_term))
                    if not fence_retried:
                        # One immediate retry with the adopted term: a
                        # worker that only LAGGED the failover must
                        # succeed against the new primary.
                        fence_retried = True
                        _m_retries().labels(op=op,
                                            outcome="retried").inc()
                        continue
                    _m_retries().labels(op=op, outcome="fatal").inc()
                    raise TermFencedError(
                        f"KV {op} {scope}/{key} term-fenced by "
                        f"{ep_addr}:{ep_port}: request term "
                        f"{req_term} < store term {srv_term} — a newer "
                        "primary owns this control plane",
                        request_term=req_term,
                        server_term=srv_term) from e
            if _fatal_http(e.code):
                _m_retries().labels(op=op, outcome="fatal").inc()
                hint = (" (bad or missing job token?)"
                        if e.code in (401, 403) else "")
                raise KVFatalError(
                    f"KV {op} {scope}/{key} failed: HTTP {e.code} "
                    f"{e.reason}{hint}", code=e.code) from e
            err = e
        except (http.client.HTTPException, OSError) as e:
            # URLError, ConnectionError, socket.timeout, DNS failures,
            # RemoteDisconnected/BadStatusLine — all worth retrying.
            err = e
        else:
            if attempt or ep_idx:
                _m_retries().labels(op=op, outcome="recovered").inc()
            if ep_idx and fo is not None:
                # This endpoint answered after earlier ones failed:
                # make it the active primary for every later call.
                _switch_active(fo, (ep_addr, ep_port),
                               "answered after failover probe")
            return out
        attempt += 1
        sleep_s = min(backoff * (2 ** (attempt - 1)), _BACKOFF_CAP_S)
        sleep_s *= 0.5 + random.random() / 2  # jitter: [0.5x, 1.0x)
        if attempt > retries or time.monotonic() + sleep_s > deadline_t:
            if ep_idx + 1 < len(plan) \
                    and time.monotonic() < deadline_t:
                # Per-endpoint budget spent: try the next endpoint in
                # the configured order with a fresh attempt budget
                # (the overall deadline still bounds the whole call).
                ep_idx += 1
                attempt = 0
                _m_retries().labels(op=op, outcome="retried").inc()
                continue
            _m_retries().labels(op=op, outcome="exhausted").inc()
            raise KVRetryExhaustedError(
                f"KV {op} {scope}/{key} failed after {attempt} "
                f"attempt(s) over {time.monotonic() - start:.1f}s "
                f"across {ep_idx + 1} endpoint(s): {err}") from err
        _m_retries().labels(op=op, outcome="retried").inc()
        time.sleep(sleep_s)


def put_kv(addr, port, scope, key, value, token="", timeout=10,
           retries=None, backoff=None, deadline=None):
    if isinstance(value, str):
        value = value.encode()

    def attempt(ep_addr, ep_port):
        _chaos_inject("kv_put", scope=scope, key=key)
        with _request("PUT", _url(ep_addr, ep_port, scope, key),
                      data=value, token=token, timeout=timeout,
                      fo=_failover_state()):
            pass

    _call("put", scope, key, attempt, addr, port, retries=retries,
          backoff=backoff, deadline=deadline)


def get_kv(addr, port, scope, key, token="", timeout=10, retries=None,
           backoff=None, deadline=None):
    """Returns bytes, or None when the key does not exist yet (404 is
    the store's existence contract, never retried)."""

    def attempt(ep_addr, ep_port):
        _chaos_inject("kv_get", scope=scope, key=key)
        try:
            with _request("GET", _url(ep_addr, ep_port, scope, key),
                          token=token, timeout=timeout,
                          fo=_failover_state()) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    return _call("get", scope, key, attempt, addr, port,
                 retries=retries, backoff=backoff, deadline=deadline)


def delete_kv(addr, port, scope, key, token="", timeout=10,
              retries=None, backoff=None, deadline=None):
    def attempt(ep_addr, ep_port):
        _chaos_inject("kv_delete", scope=scope, key=key)
        with _request("DELETE", _url(ep_addr, ep_port, scope, key),
                      token=token, timeout=timeout,
                      fo=_failover_state()):
            pass

    _call("delete", scope, key, attempt, addr, port, retries=retries,
          backoff=backoff, deadline=deadline)


def wait_for_kv(addr, port, scope, key, token="", deadline_s=120,
                poll_s=0.05, heal=None, heal_every=1.0):
    """Poll GET until the key appears; raises TimeoutError. Transient
    transport trouble mid-poll — even a whole inner retry budget
    exhausting — is swallowed until ``deadline_s``: the wait's own
    deadline is the only thing that ends it. Fatal errors (auth) still
    propagate immediately; waiting out a bad token would always time
    out anyway, with a worse message.

    ``heal`` (optional) runs every ``heal_every`` seconds while
    waiting — the self-repair hook for waits whose *precondition* can
    be lost while they wait (rendezvous re-verifying its own published
    peer key against a restored/failed-over store). Transport errors
    from the hook are swallowed like any other transient."""
    deadline = time.monotonic() + deadline_s
    last_err = None
    last_heal = time.monotonic()
    while True:
        left = deadline - time.monotonic()
        try:
            # The kv_wait chaos point is inside the try: an injected
            # transport error must be swallowed like any other transient
            # (only KVFatalError — a RuntimeError, uncaught below — may
            # end the wait early).
            _chaos_inject("kv_wait", scope=scope, key=key)
            value = get_kv(addr, port, scope, key, token=token,
                           deadline=max(poll_s,
                                        min(DEFAULT_DEADLINE_S, left)))
        except (http.client.HTTPException, OSError) as e:
            # KVRetryExhaustedError is an OSError too: the inner retry
            # budget spending does not end the wait.
            last_err = e
            value = None
        else:
            if value is not None:
                return value
        now = time.monotonic()
        if heal is not None and now - last_heal >= heal_every:
            last_heal = now
            try:
                heal()
            except (http.client.HTTPException, OSError) as e:
                last_err = e
        if time.monotonic() > deadline:
            detail = f" (last transport error: {last_err})" if last_err \
                else ""
            raise TimeoutError(
                f"rendezvous key {scope}/{key} not published within "
                f"{deadline_s}s{detail}")
        time.sleep(poll_s)

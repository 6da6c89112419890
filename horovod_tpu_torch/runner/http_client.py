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

Not ported: endpoint failover and term fencing (control-plane HA), the
sanitizer's tripwire and the chaos points (ROADMAP queue A, items 13 and
15).
"""

import http.client
import random
import time
import urllib.error
import urllib.request

from ..telemetry import core as telemetry
from ..utils import envparse
from .http_server import AUTH_HEADER

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


class KVRetryExhaustedError(KVError, TimeoutError):
    """Retry budget or deadline exhausted on a retryable failure.
    Inherits TimeoutError (an OSError) so callers that treat transient
    transport trouble as recoverable (elastic's ``_retry_reset``)
    classify it correctly without importing this module."""


def _m_retries():
    # Resolved at call time: a no-op when HOROVOD_TPU_METRICS is off.
    return telemetry.counter(
        "hvd_kv_retries_total",
        "KV client retry outcomes by operation",
        labelnames=("op", "outcome"))


def _url(addr, port, scope, key):
    return f"http://{addr}:{port}/{scope}/{key}"


def _request(method, url, data=None, token="", timeout=10):
    req = urllib.request.Request(url, data=data, method=method)
    if token:
        req.add_header(AUTH_HEADER, token)
    return urllib.request.urlopen(req, timeout=timeout)


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


def _call(op, scope, key, attempt_fn, retries=None, backoff=None,
          deadline=None):
    """Run ``attempt_fn()`` under the retry policy. An HTTPError reaching
    here is already known not to be a 404 (``attempt_fn`` handles the
    existence contract); fatal statuses raise at once with the op, scope
    and key named; retryable failures back off exponentially with jitter
    until the retries or the overall deadline run out."""
    retries, backoff, deadline_s = _retry_params(retries, backoff,
                                                 deadline)
    start = time.monotonic()
    deadline_t = start + deadline_s
    attempt = 0
    while True:
        try:
            out = attempt_fn()
        except urllib.error.HTTPError as e:
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
            # RemoteDisconnected/BadStatusLine: all worth retrying.
            err = e
        else:
            if attempt:
                _m_retries().labels(op=op, outcome="recovered").inc()
            return out
        attempt += 1
        sleep_s = min(backoff * (2 ** (attempt - 1)), _BACKOFF_CAP_S)
        sleep_s *= 0.5 + random.random() / 2  # jitter: [0.5x, 1.0x)
        if attempt > retries or time.monotonic() + sleep_s > deadline_t:
            _m_retries().labels(op=op, outcome="exhausted").inc()
            raise KVRetryExhaustedError(
                f"KV {op} {scope}/{key} failed after {attempt} "
                f"attempt(s) over {time.monotonic() - start:.1f}s: "
                f"{err}") from err
        _m_retries().labels(op=op, outcome="retried").inc()
        time.sleep(sleep_s)


def put_kv(addr, port, scope, key, value, token="", timeout=10,
           retries=None, backoff=None, deadline=None):
    if isinstance(value, str):
        value = value.encode()

    def attempt():
        with _request("PUT", _url(addr, port, scope, key), data=value,
                      token=token, timeout=timeout):
            pass

    _call("put", scope, key, attempt, retries=retries, backoff=backoff,
          deadline=deadline)


def get_kv(addr, port, scope, key, token="", timeout=10, retries=None,
           backoff=None, deadline=None):
    """Returns bytes, or None when the key does not exist yet (404 is
    the store's existence contract, never retried)."""

    def attempt():
        try:
            with _request("GET", _url(addr, port, scope, key), token=token,
                          timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    return _call("get", scope, key, attempt, retries=retries,
                 backoff=backoff, deadline=deadline)


def delete_kv(addr, port, scope, key, token="", timeout=10,
              retries=None, backoff=None, deadline=None):
    def attempt():
        with _request("DELETE", _url(addr, port, scope, key), token=token,
                      timeout=timeout):
            pass

    _call("delete", scope, key, attempt, retries=retries, backoff=backoff,
          deadline=deadline)


def wait_for_kv(addr, port, scope, key, token="", deadline_s=120,
                poll_s=0.05):
    """Poll GET until the key appears; raises TimeoutError. Transient
    transport trouble mid-poll, even a whole inner retry budget
    exhausting, is swallowed until ``deadline_s``: the wait's own deadline
    is the only thing that ends it. Fatal errors (auth) still propagate at
    once; waiting out a bad token would always time out anyway, with a
    worse message."""
    deadline = time.monotonic() + deadline_s
    last_err = None
    while True:
        left = deadline - time.monotonic()
        try:
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
        if time.monotonic() > deadline:
            detail = f" (last transport error: {last_err})" if last_err \
                else ""
            raise TimeoutError(
                f"rendezvous key {scope}/{key} not published within "
                f"{deadline_s}s{detail}")
        time.sleep(poll_s)

"""Worker heartbeat lease + driver-side liveness tracking (port of
``horovod_tpu/runner/heartbeat.py``).

Closes the hung-worker gap: the elastic driver's ``_sweep_exits`` only
notices workers that *exit*, never workers that *hang* (a wedged NFS
mount, a deadlocked extension, a SIGSTOPped process). Each worker runs
a background thread that PUTs ``heartbeat/<worker_id>`` into the
driver's KV store every ``HVDTPU_HEARTBEAT_INTERVAL`` seconds; the
driver fails any worker whose published value stops *changing* for
``HVDTPU_HEARTBEAT_TIMEOUT`` seconds (0 disables).

Liveness is clock-skew free by construction: the beat value is
``<pid>:<count>`` — an opaque token the driver compares for *change*
against its own monotonic clock, never a timestamp compared across
hosts. The pid prefix makes a respawned worker's stream distinct from
its predecessor's, so a fresh process restarting the counter still
reads as "changed".

A worker that has never published a beat is NOT subject to the timeout:
process startup (imports, the native core's build, rendezvous) is
governed by the launcher's start timeout, and judging it by heartbeat
silence would just re-implement that timeout with a harsher penalty.

Each beat is the ``heartbeat`` chaos point; its failures are swallowed
like any other failed beat.
"""

import os
import threading
import time

from ..chaos import inject as _chaos_inject
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger

HEARTBEAT_SCOPE = "heartbeat"
DEFAULT_INTERVAL_S = 2.0
DEFAULT_TIMEOUT_S = 30.0
#: Consecutive beat failures before ONE warning names the endpoint —
#: a partitioned worker becomes diagnosable from its own log before
#: the driver declares it dead (errors stay swallowed regardless).
ERROR_WARN_STREAK = 5


def heartbeat_interval():
    return envparse.get_float(envparse.HEARTBEAT_INTERVAL,
                              DEFAULT_INTERVAL_S)


def heartbeat_timeout():
    return envparse.get_float(envparse.HEARTBEAT_TIMEOUT,
                              DEFAULT_TIMEOUT_S)


class HeartbeatThread:
    """Background lease renewal. Beat failures are swallowed (counted,
    logged at debug): liveness reporting must never kill a live worker
    — if the store is really gone, collectives and commits will surface
    it with a better error, and the driver's timeout judges us anyway."""

    def __init__(self, addr, port, token, worker_id, interval_s=None):
        self._addr = addr
        self._port = port
        self._token = token
        self._worker_id = worker_id
        self._interval = (heartbeat_interval() if interval_s is None
                          else interval_s)
        self._stop = threading.Event()
        self._thread = None
        self._count = 0
        self._log = get_logger()
        self._m_beats = telemetry.counter(
            "hvd_heartbeat_beats_total",
            "Worker heartbeat lease renewals", labelnames=("outcome",))
        self._m_errors = telemetry.counter(
            "hvd_heartbeat_errors_total",
            "Worker beat failures (error) and streak-ending successes "
            "(recovered)", labelnames=("outcome",))
        self._consec_errors = 0

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="hvd-tpu-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=2.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _loop(self):
        from . import http_client
        while not self._stop.is_set():
            self._count += 1
            try:
                _chaos_inject("heartbeat", wid=self._worker_id)
                # Tight retry budget: a beat that cannot land within one
                # interval is worth less than the NEXT beat — backing up
                # stale beats behind a long retry would delay detection.
                http_client.put_kv(
                    self._addr, self._port, HEARTBEAT_SCOPE,
                    self._worker_id, f"{os.getpid()}:{self._count}",
                    token=self._token, retries=1,
                    deadline=max(self._interval, 1.0))
                self._m_beats.labels(outcome="ok").inc()
                if self._consec_errors:
                    self._m_errors.labels(outcome="recovered").inc()
                    self._log.info(
                        "heartbeat: beat landed again after %d "
                        "consecutive failures", self._consec_errors)
                    self._consec_errors = 0
            except Exception as e:  # noqa: BLE001 — never kill the worker
                self._m_beats.labels(outcome="error").inc()
                self._m_errors.labels(outcome="error").inc()
                self._consec_errors += 1
                if self._consec_errors == ERROR_WARN_STREAK:
                    # Previously these were swallowed at debug level
                    # FOREVER — a worker partitioned from the control
                    # plane looked healthy in its own log right up to
                    # the moment the driver killed it as hung. One
                    # warning per streak, naming where the beats were
                    # going.
                    addr, port = http_client.active_endpoint(
                        self._addr, self._port)
                    self._log.warning(
                        "heartbeat: %d consecutive beat failures "
                        "against %s:%d (last: %s) — this worker may be "
                        "partitioned from the control plane; the "
                        "driver will declare it hung after "
                        "HVDTPU_HEARTBEAT_TIMEOUT", self._consec_errors,
                        addr, port, e)
                else:
                    self._log.debug("heartbeat: beat %d failed: %s",
                                    self._count, e)
            self._stop.wait(self._interval)


class LivenessTracker:
    """Driver-side change detection over beat values. ``observe``
    returns True when ``wid`` is expired: its value has been seen
    unchanged for longer than ``timeout_s`` of the local clock."""

    def __init__(self, timeout_s):
        self.timeout_s = timeout_s
        self._seen = {}  # wid -> [value, last_change_monotonic]

    def observe(self, wid, value, now=None):
        if now is None:
            now = time.monotonic()
        rec = self._seen.get(wid)
        if rec is None or rec[0] != value:
            self._seen[wid] = [value, now]
            return False
        return (now - rec[1]) > self.timeout_s

    def age(self, wid, now=None):
        rec = self._seen.get(wid)
        if rec is None:
            return 0.0
        return (time.monotonic() if now is None else now) - rec[1]

    def forget(self, wid):
        self._seen.pop(wid, None)


# -- worker-side process singleton ----------------------------------------
# One lease per process for its whole lifetime: elastic re-inits must
# NOT stop the beat (a worker mid-reset is alive and must read as such),
# so this is started once by basics.init and left running; the daemon
# thread dies with the process.

_worker_thread = None


def start_worker_heartbeat():
    """Start the lease thread for this worker (idempotent). No-op when
    the job has no launcher rendezvous or no worker id — nothing to
    lease against. Returns the HeartbeatThread or None."""
    global _worker_thread
    if _worker_thread is not None:
        return _worker_thread
    from . import rendezvous as rdv
    cfg = rdv.rendezvous_config()
    worker_id = envparse.get_str(envparse.WORKER_ID)
    if cfg is None or not worker_id:
        return None
    addr, port, token = cfg
    _worker_thread = HeartbeatThread(addr, port, token,
                                     worker_id).start()
    return _worker_thread


def stop_worker_heartbeat():
    """Test hook: stop and forget the process singleton."""
    global _worker_thread
    if _worker_thread is not None:
        _worker_thread.stop()
        _worker_thread = None

"""Elastic fault tolerance: worker-side state machine + retry loop (port
of ``horovod_tpu/elastic.py``; reference: horovod/common/elastic.py:26-176).

Training state is committed in memory; collective failures
(``HorovodInternalError``) restore it, membership changes
(``HostsUpdatedInterrupt``) keep it; in both cases the runtime resets
(``shutdown(); init()``) with new ranks served by the driver's rendezvous,
then ``state.sync()`` re-broadcasts from a surviving rank.

Membership-change notification is poll-based: the driver bumps an
``elastic/version`` counter in its KV store; ``state.check_host_updates``
compares it against the version this worker joined at (the reference
pushes notifications into an in-worker TCP service instead,
horovod/runner/elastic/worker.py:46).

How the runtime resets. On the CUDA plane (and the native TCP plane) the
reset stays in the process, as the reference does: ``shutdown()`` stops the
coordinator's cycle thread and the native core, then tears the NCCL
process group down (after a dead peer the communicators were already
aborted by the cycle thread), and ``init()`` bootstraps at the new version
and forms a new group on a fresh store. ``torch.distributed`` can re-form
inside a process. The exit-restart path below is kept, keyed as in the
JAX package on ``HVDTPU_CPU_OPERATIONS`` naming the delegated plane (the
JAX package needs it because ``jax.distributed`` cannot re-form).

Each commit is the chaos ``worker`` point (after the save, so that a
preempt hand-off persists current progress). Under control-plane HA
(``HVDTPU_RENDEZVOUS_ADDRS`` exported by the driver) a worker leaves a
durable exit marker, ``elastic.exit/<worker id> = rc``, on success,
preemption and restart exits: a promoted standby, which never spawned the
worker, reaps the marker instead of an exit code.
"""

import functools
import os
import signal
import threading
import time

from . import basics, tracing
from .chaos import inject as _chaos_inject
from .exceptions import (PREEMPT_EXIT_CODE, RESTART_EXIT_CODE,
                         CollectiveAbortError, HorovodInternalError,
                         HostsUpdatedInterrupt)
from .telemetry import core as telemetry
from .utils import envparse
from .utils.logging_util import get_logger


# Elastic events are rare (one per commit / failure / reset), so the
# counters resolve through the registry at call time: no-ops when
# HOROVOD_TPU_METRICS is off.
def _m_commits():
    return telemetry.counter("hvd_elastic_commits_total",
                             "State commits (restore points marked)")


def _m_failures():
    return telemetry.counter(
        "hvd_elastic_failures_total",
        "Elastic interruptions by cause", labelnames=("cause",))


def _m_restarts():
    return telemetry.counter(
        "hvd_elastic_restarts_total",
        "Successful runtime resets (shutdown + re-init + re-sync)")


class State:
    """Base elastic state: commit/restore/sync + host-update checks
    (reference: horovod/common/elastic.py:26 ``State``)."""

    def __init__(self):
        self._reset_callbacks = []
        self._last_check = 0.0
        self._commits = 0
        self._check_interval = envparse.get_float(
            envparse.ELASTIC_CHECK_INTERVAL, 0.2)

    def register_reset_callbacks(self, callbacks):
        """Callbacks run after a reset (new world size), e.g. to rescale
        the learning rate (reference: elastic.py:44)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def reset(self):
        """Hook for subclasses (re-build data loaders, etc.)."""

    def commit(self):
        """Snapshot state in memory and check for membership changes
        (reference: elastic.py:70; raising here, between steps, is what
        keeps restore consistent)."""
        self.save()
        _m_commits().inc()
        self._commits += 1
        # Chaos 'worker' point: commit boundaries are where preemption /
        # hang scenarios are injected (after_commits matcher). Fires
        # AFTER save() so a preempt hand-off persists current progress.
        _chaos_inject("worker", commits=self._commits)
        self.check_host_updates()

    def check_host_updates(self):
        """Raise HostsUpdatedInterrupt when the driver published a newer
        membership version than the one this worker joined at."""
        if preempt_requested():
            # SIGTERM arrived since the last commit: hand off now, at a
            # consistent restore point (the commit just saved).
            raise HostsUpdatedInterrupt(skip_sync=True)
        now = time.monotonic()
        if now - self._last_check < self._check_interval:
            return
        self._last_check = now
        from .runner import rendezvous as rdv
        cfg = rdv.rendezvous_config()
        if cfg is None:
            return
        current = rdv.current_elastic_version(*cfg)
        if current > _joined_version():
            raise HostsUpdatedInterrupt(skip_sync=False)

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError


class ObjectState(State):
    """State holding arbitrary picklable attributes: epoch counters,
    numpy arrays, plain values (reference: horovod/common/elastic.py:116
    ``ObjectState``). save/restore are shallow snapshots; sync broadcasts
    the whole attribute dict from the new rank 0 (always a survivor: the
    driver assigns surviving workers the lowest ranks)."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved_state = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def _public_state(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def save(self):
        self._saved_state = self._public_state()

    def restore(self):
        for k, v in self._saved_state.items():
            setattr(self, k, v)

    def sync(self):
        from .functions import broadcast_object
        synced = broadcast_object(self._saved_state, root_rank=0,
                                  name="elastic.state")
        self._saved_state = synced
        self.restore()


# The JAX package's alias, kept for scripts written against it.
TpuState = ObjectState


def _joined_version():
    return envparse.get_int(envparse.ELASTIC_VERSION, -1)


# The device the process computed on: a reset re-initializes on it, so
# that a process keeps the device it was given (``init(device="cpu")``);
# on the card that is its slot's (``basics._card_index``), whatever local
# rank the new membership version hands it.
_RESET_DEVICE = {}


def _reset():
    """shutdown(); init(): re-rendezvous with new ranks from the driver
    (reference: horovod/torch/elastic/__init__.py:46-48), in process."""
    if basics.is_initialized():
        _RESET_DEVICE["device"] = basics.device()
    basics.shutdown()
    basics.init(device=_RESET_DEVICE.get("device"))


# ---------------------------------------------------------------------------
# Graceful preemption: SIGTERM -> hand off at the next commit boundary
# ---------------------------------------------------------------------------
#
# Cloud preemption (and the driver's own scale-down stop) arrives as
# SIGTERM. The default disposition is an abrupt death mid-step: in-memory
# progress since the last persisted commit is lost and the driver counts
# a failure against the host. With the handler installed, SIGTERM only
# sets a flag; the next commit boundary raises HostsUpdatedInterrupt at a
# consistent restore point, the worker persists that commit to the
# driver's KV store, and exits with PREEMPT_EXIT_CODE, which the driver
# treats as a membership change, not a failure.

_PREEMPT = {"installed": False, "requested": False}


def _publish_exit_marker(code):
    """Best-effort ``elastic.exit/<wid> = rc`` KV marker. The durable
    exit record a *promoted standby* driver — which never spawned this
    process and so cannot ``proc.poll()`` it — reaps instead of an
    exit code (runner/elastic_driver.py ``_AdoptedProc``). Crashes
    leave no marker; the heartbeat timeout covers those."""
    if not envparse.get_str(envparse.RENDEZVOUS_ADDRS, ""):
        # Exit markers only matter to a driver that could ADOPT this
        # worker, i.e. when a standby endpoint list was exported.
        # Without HA the driver reaps real exit codes, and the
        # disabled-mode contract promises zero extra KV traffic.
        return
    from .runner import http_client
    from .runner import rendezvous as rdv
    cfg = rdv.rendezvous_config()
    wid = envparse.get_str(envparse.WORKER_ID)
    if cfg is None or not wid:
        return
    addr, port, token = cfg
    try:
        http_client.put_kv(addr, port, rdv.EXIT_SCOPE, wid, str(code),
                           token=token, retries=2, deadline=5.0)
    except Exception as e:  # noqa: BLE001 — markers must never block exit
        get_logger().debug("elastic: could not publish exit marker: %s",
                           e)


def preempt_requested():
    """True once SIGTERM has been received (elastic workers only)."""
    return _PREEMPT["requested"]


def _reset_preempt_state():
    """Test hook."""
    _PREEMPT["requested"] = False


def _install_preempt_handler(log):
    """Install the SIGTERM->flag handler. Elastic workers only (gated by
    the caller), main thread only (signal API constraint), idempotent."""
    if _PREEMPT["installed"]:
        return
    if threading.current_thread() is not threading.main_thread():
        return

    def _on_sigterm(signum, frame):
        _PREEMPT["requested"] = True
        log.warning("elastic: SIGTERM received; handing off at the "
                    "next commit boundary")

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        return
    _PREEMPT["installed"] = True


def _graceful_preempt_exit(state, log):
    """Persist the last commit (so a replacement slot, or the whole
    respawned cohort in restart mode, can restore it) and leave with
    PREEMPT_EXIT_CODE. Persistence is best-effort: a state that cannot
    pickle, or a store that is already gone, must not turn a graceful
    exit back into a hang."""
    import sys
    _m_failures().labels(cause="preempted").inc()
    try:
        _persist_state(state)
        log.info("elastic: preemption hand-off: last commit persisted")
    except Exception as e:  # noqa: BLE001 - exit regardless
        log.warning("elastic: could not persist commit during "
                    "preemption hand-off: %s", e)
    _publish_exit_marker(PREEMPT_EXIT_CODE)
    try:
        basics.shutdown()
    except Exception:  # noqa: BLE001
        pass
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(PREEMPT_EXIT_CODE)


# ---------------------------------------------------------------------------
# Exit-restart reset
# ---------------------------------------------------------------------------
#
# Under HVDTPU_CPU_OPERATIONS naming the delegated plane, a membership
# event makes the worker persist its last commit to the driver's KV store
# and exit with RESTART_EXIT_CODE; the elastic driver respawns the same
# slot fresh, and run_fn restores the persisted commit before the first
# sync(). The JAX package needs this because jax.distributed cannot re-form
# inside a live process; the port keeps the same keying, and every other
# plane (CUDA tensors included) resets in process.

_STATE_SCOPE = "elastic.state"


def _restart_mode():
    """Exit-restart semantics apply when an elastic worker asked for the
    delegated plane by name (the JAX package's compiled-plane rule)."""
    if not envparse.get_bool(envparse.ELASTIC):
        return False
    return envparse.get_str(envparse.CPU_OPERATIONS, "").lower() in (
        "xla", "xla-global", "nccl")


def _state_payload(state):
    """The picklable restore-point of a State. save() runs first so a
    graceful membership change persists CURRENT progress. States with no
    ``_saved_state`` snapshot (``TorchState`` keeps ``_saved``) cannot use
    the exit-restart plane: fail loud at persist time, not with a corrupt
    restore."""
    try:
        state.save()
    except NotImplementedError:
        pass
    payload = getattr(state, "_saved_state", None)
    if payload is None:
        raise NotImplementedError(
            f"{type(state).__name__} exposes no _saved_state snapshot; "
            "exit-restart elastic needs a picklable commit payload")
    return payload


def _persist_state(state):
    """Write this worker's restore point to the driver's KV store under
    its worker id AND the cohort's "any" fallback (last-writer: all
    survivors persist the same step-aligned restore point, so any write
    is as good as another for a replacement slot with no history).
    Returns the resolved ``(addr, port, token, wid)``."""
    import base64
    import json
    import pickle

    from .runner import http_client
    from .runner import rendezvous as rdv
    cfg = rdv.rendezvous_config()
    wid = envparse.get_str(envparse.WORKER_ID)
    if cfg is None or not wid:
        raise HorovodInternalError(
            "persisting elastic state requires the launcher's "
            "rendezvous (HVDTPU_RENDEZVOUS_ADDR/PORT)")
    addr, port, token = cfg
    payload = base64.b64encode(
        pickle.dumps(_state_payload(state))).decode()
    json_blob = json.dumps({"version": _joined_version(),
                            "payload": payload})
    http_client.put_kv(addr, port, _STATE_SCOPE, wid, json_blob,
                       token=token)
    http_client.put_kv(addr, port, _STATE_SCOPE, "any", json_blob,
                       token=token)
    return addr, port, token, wid


def _persist_and_exit(state, log, rereq):
    """Persist the last commit to the driver's KV store and leave the
    process; the driver respawns this slot fresh (see the note above)."""
    import sys

    from .runner import http_client
    from .runner import rendezvous as rdv
    addr, port, token, wid = _persist_state(state)
    if rereq:
        # A failure with no process death changes no membership; ask the
        # driver to bump the version so the fresh cohort re-forms
        # (mirrors rendezvous.elastic_bootstrap).
        http_client.put_kv(addr, port, rdv.ELASTIC_SCOPE,
                           f"rereq.{wid}", str(_joined_version() + 1),
                           token=token)
    _publish_exit_marker(RESTART_EXIT_CODE)
    log.info("elastic: persisting commit and exiting for process "
             "restart")
    try:
        basics.shutdown()
    except Exception:  # noqa: BLE001
        pass
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(RESTART_EXIT_CODE)


def _maybe_restore_persisted(state, log):
    """In a fresh exit-restart process: load this slot's persisted
    commit (or the cohort's last-writer fallback) into ``state``."""
    import base64
    import json
    import pickle

    from .runner import http_client
    from .runner import rendezvous as rdv
    cfg = rdv.rendezvous_config()
    wid = envparse.get_str(envparse.WORKER_ID)
    if cfg is None or not wid:
        return
    addr, port, token = cfg
    raw = http_client.get_kv(addr, port, _STATE_SCOPE, wid, token=token)
    if raw is None:
        raw = http_client.get_kv(addr, port, _STATE_SCOPE, "any",
                                 token=token)
    if raw is None:
        return
    try:
        record = json.loads(raw.decode()
                            if isinstance(raw, bytes) else raw)
        payload = pickle.loads(base64.b64decode(record["payload"]))
    except Exception as e:  # noqa: BLE001
        log.warning("elastic: persisted state unreadable (%s); starting "
                    "fresh", e)
        return
    state._saved_state = payload
    state.restore()
    state.save()
    log.info("elastic: restored persisted commit from version %s",
             record.get("version"))


def run_fn(func, reset=_reset):
    """Wrap a training function for elastic execution (reference:
    horovod/common/elastic.py:151 ``run_fn``). The wrapped function takes
    the State first; on HorovodInternalError (the watchdog's
    CollectiveAbortError among them) the last commit is restored, on
    HostsUpdatedInterrupt state is kept; both paths reset the runtime and
    re-sync before retrying. Program bugs (CollectiveMismatchError,
    StalledTensorError) propagate."""
    log = get_logger()

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        if envparse.get_bool(envparse.ELASTIC):
            # Launcher-spawned elastic worker: convert SIGTERM (cloud
            # preemption / driver stop) into a commit-boundary hand-off.
            _install_preempt_handler(log)
        if _restart_mode():
            _maybe_restore_persisted(state, log)
        skip_sync = False
        while True:
            if not skip_sync:
                state.sync()
            try:
                result = func(state, *args, **kwargs)
                if envparse.get_bool(envparse.ELASTIC):
                    # Durable success marker for a control plane that
                    # survived a failover: a promoted standby has no
                    # process handle on this worker and reaps the
                    # marker instead of an exit code.
                    _publish_exit_marker(0)
                return result
            except HorovodInternalError as e:
                aborted = isinstance(e, CollectiveAbortError)
                tracing.trace_event(
                    "elastic", "restore",
                    cause="collective_abort" if aborted else "internal")
                if aborted:
                    # The stuck-collective watchdog aborted the in-flight
                    # operations (guardian.py); its diagnostic names the
                    # ranks that never submitted what. The abort becomes a
                    # restore-and-reset, not a job death.
                    log.warning("elastic: watchdog abort; restoring last "
                                "commit and resetting. %s", e)
                else:
                    log.info("elastic: collective failure (%s); restoring "
                             "last commit", e)
                state.restore()
                skip_sync = False
                if preempt_requested():
                    # Counted once, as cause="preempted", inside the
                    # hand-off: the failure causes are disjoint.
                    _graceful_preempt_exit(state, log)
                _m_failures().labels(
                    cause="collective_abort" if aborted
                    else "internal").inc()
                if _restart_mode():
                    _persist_and_exit(state, log, rereq=True)
            except HostsUpdatedInterrupt as e:
                tracing.trace_event("elastic", "hosts_updated")
                log.info("elastic: hosts updated; re-rendezvousing")
                skip_sync = e.skip_sync
                if preempt_requested():
                    _graceful_preempt_exit(state, log)
                _m_failures().labels(cause="hosts_updated").inc()
                if _restart_mode():
                    _persist_and_exit(state, log, rereq=False)
            _retry_reset(reset, log)
            _m_restarts().inc()
            state.on_reset()

    return wrapper


def _retry_reset(reset, log, attempts=3):
    """Re-init can itself hit a dying cohort (a peer drops while the new
    group forms); retry a few times before giving up: each attempt
    re-fetches the newest membership version."""
    for attempt in range(attempts):
        try:
            reset()
            return
        except (HorovodInternalError, TimeoutError, OSError) as e:
            log.warning("elastic: reset attempt %d failed (%s)",
                        attempt + 1, e)
            try:
                basics.shutdown()
            except Exception:  # noqa: BLE001
                pass
            if attempt == attempts - 1:
                raise


def run(func):
    """Decorator form (reference: horovod/torch/elastic/__init__.py
    ``hvd.elastic.run``)."""
    return run_fn(func)

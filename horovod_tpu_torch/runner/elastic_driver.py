"""Driver-side elasticity: discovery, stable rank assignment, blacklist,
re-rendezvous, worker respawn (port of
``horovod_tpu/runner/elastic_driver.py``).

The analog of the reference's ElasticDriver + WorkerStateRegistry +
HostDiscoveryScript (reference: horovod/runner/elastic/driver.py:68-314,
registration.py:28-150, discovery.py:80-185): a discovery script is polled
every second for the current ``host:slots`` membership; on change (or on a
worker failure) the driver bumps the membership **version**, publishes new
rank assignments to its KV store, spawns workers for new slots, and lets
surviving workers re-rendezvous under the new version. Failed hosts are
blacklisted after repeated worker failures.

Not ported: the control-plane journal, warm standby, adopted workers and
term fence (ROADMAP queue A, item 13), fleet transfer markers (item 14)
and the ``driver`` chaos point (item 13).
"""

import subprocess
import time
from types import SimpleNamespace

from . import spawn
from . import heartbeat as heartbeat_mod
from .hosts import HostInfo
from .http_server import RendezvousServer, new_job_token
from .job import _rendezvous_ip
from ..exceptions import PREEMPT_EXIT_CODE, RESTART_EXIT_CODE
from .rendezvous import ASSIGN_SCOPE, ELASTIC_SCOPE, PEER_SCOPE, VERSION_KEY
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger

RUNNING, SUCCEEDED, FAILED = "running", "succeeded", "failed"


def _check_heartbeat_config(timeout_s, worker_env):
    """True (and a warning logged) when the liveness timeout is below
    ~2 beat intervals: every healthy worker would read as hung and be
    killed on repeat, with logs blaming the workers instead of the
    configuration. The interval is read from the WORKER env when the
    job overrides it there, else from this process's knobs."""
    if timeout_s <= 0:
        return False
    interval = None
    for prefix in ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_"):
        value = (worker_env or {}).get(prefix + "HEARTBEAT_INTERVAL")
        if value:
            try:
                interval = float(value)
            except ValueError:
                pass
            break
    if interval is None:
        interval = heartbeat_mod.heartbeat_interval()
    if timeout_s < 2 * interval:
        get_logger().warning(
            "elastic driver: heartbeat timeout %.1fs is below twice the "
            "worker beat interval %.1fs; healthy workers WILL be "
            "failed as hung: raise HVDTPU_HEARTBEAT_TIMEOUT or lower "
            "HVDTPU_HEARTBEAT_INTERVAL", timeout_s, interval)
        return True
    return False


class ElasticSettings:
    def __init__(self, settings, discovery_script=None, min_np=1,
                 max_np=None, reset_limit=None, host_fail_limit=3,
                 discovery_interval=1.0, heartbeat_timeout=None,
                 sigkill_deadline=None):
        self.base = settings
        self.discovery_script = discovery_script
        self.min_np = min_np
        self.max_np = max_np
        self.reset_limit = reset_limit
        self.host_fail_limit = host_fail_limit
        self.discovery_interval = discovery_interval
        # Liveness: a worker whose heartbeat lease stops moving for this
        # long is failed (0 disables).
        self.heartbeat_timeout = (
            heartbeat_mod.heartbeat_timeout() if heartbeat_timeout is None
            else heartbeat_timeout)
        # SIGTERM->SIGKILL escalation window for workers being stopped.
        self.sigkill_deadline = (
            envparse.get_float(envparse.SIGKILL_DEADLINE, 10.0)
            if sigkill_deadline is None else sigkill_deadline)
        _check_heartbeat_config(self.heartbeat_timeout,
                                getattr(settings, "env", None))


class HostDiscovery:
    """Poll the user's discovery script for the current host set
    (reference: discovery.py:152-175 ``HostDiscoveryScript``). Fixed-host
    fallback uses the static -H/--hostfile list."""

    def __init__(self, elastic_settings):
        self._settings = elastic_settings

    def find_available_hosts(self):
        script = self._settings.discovery_script
        if not script:
            return self._settings.base.resolve_hosts()
        try:
            proc = subprocess.run(script, shell=True, capture_output=True,
                                  timeout=30)
        except subprocess.TimeoutExpired:
            raise RuntimeError("host discovery script timed out (30s)")
        if proc.returncode != 0:
            raise RuntimeError(
                f"host discovery script failed (exit {proc.returncode}): "
                f"{proc.stderr.decode(errors='replace')[:500]}")
        hosts = []
        for line in proc.stdout.decode().splitlines():
            line = line.strip()
            if line:
                hosts.append(HostInfo.from_string(line))
        return hosts


class _Worker:
    __slots__ = ("worker_id", "host", "slot_index", "proc", "state")

    def __init__(self, worker_id, host, slot_index, proc):
        self.worker_id = worker_id
        self.host = host
        self.slot_index = slot_index
        self.proc = proc
        self.state = RUNNING


class ElasticDriver:
    """Owns the rendezvous server and the worker fleet for one job."""

    DISCOVERY_FAIL_LIMIT = 30  # consecutive failures before aborting

    def __init__(self, elastic, command, discovery=None):
        self.elastic = elastic
        self.command = command
        # Pluggable membership source: anything with find_available_hosts()
        # -> [HostInfo].
        self.discovery = discovery or HostDiscovery(elastic)
        self.token = envparse.get_str(envparse.JOB_TOKEN) \
            or new_job_token()
        self.server = RendezvousServer(job_token=self.token,
                                       verbose=elastic.base.verbose)
        self.port = self.server.start()
        self.addr = None
        self.version = -1
        self.workers = {}        # worker_id -> _Worker (running only)
        self.stopping = []       # (worker, sigkill_deadline) being reaped
        self.rank_order = []     # worker_ids in rank order
        self.blacklist = set()
        self.fail_counts = {}
        self.resets = 0
        self.completing = False
        self.succeeded = []
        self.preempts = 0        # graceful exit-83 hand-offs
        self.log = get_logger()
        self._last_targets = []
        self._discovery_failures = 0
        # Driver-side elastic counters (no-ops when metrics are off).
        self._m_resets = telemetry.counter(
            "hvd_elastic_driver_resets_total",
            "Membership versions published after the initial cohort")
        self._m_worker_failures = telemetry.counter(
            "hvd_elastic_driver_worker_failures_total",
            "Worker processes that exited non-zero")
        self._m_blacklisted = telemetry.gauge(
            "hvd_elastic_driver_blacklisted_hosts",
            "Hosts excluded after repeated worker failures")
        self._m_heartbeat_failures = telemetry.counter(
            "hvd_elastic_driver_heartbeat_failures_total",
            "Workers failed for missing their heartbeat lease")
        self._liveness = heartbeat_mod.LivenessTracker(
            self.elastic.heartbeat_timeout)

    # -- membership ------------------------------------------------------
    def _discover_targets(self):
        """(worker_id, host, slot_index) for every slot in the current
        discovery output, minus blacklisted hosts, capped at max_np. A
        transient discovery failure keeps the last known membership:
        flaky cloud APIs are exactly what elastic mode exists for."""
        try:
            hosts = [h for h in self.discovery.find_available_hosts()
                     if h.hostname not in self.blacklist]
            self._discovery_failures = 0
        except RuntimeError as e:
            self._discovery_failures += 1
            self.log.warning(
                "elastic driver: discovery failed (%d consecutive): %s",
                self._discovery_failures, e)
            if self._discovery_failures >= self.DISCOVERY_FAIL_LIMIT:
                raise
            return self._last_targets
        slots = []
        cap = self.elastic.max_np or float("inf")
        for h in hosts:
            for idx in range(h.slots):
                if len(slots) >= cap:
                    break
                slots.append((f"{h.hostname}:{idx}", h.hostname, idx))
            if len(slots) >= cap:
                break
        self._last_targets = slots
        return slots

    def _publish(self):
        """Compute stable rank order and publish assignment version N.
        Surviving workers keep their relative order (and therefore the
        lowest ranks: rank 0 is always a survivor, which is what makes
        ``state.sync()`` broadcast-from-0 correct); new workers append
        (reference: driver.py:232-276 stable host ordering)."""
        alive = [wid for wid in self.rank_order if wid in self.workers]
        alive += [wid for wid in self.workers if wid not in alive]
        self.rank_order = alive
        size = len(alive)

        # Host-level grouping for local/cross ranks.
        host_of = {wid: self.workers[wid].host for wid in alive}
        local_rank = {}
        local_counts = {}
        for wid in alive:
            h = host_of[wid]
            local_rank[wid] = local_counts.get(h, 0)
            local_counts[h] = local_rank[wid] + 1
        host_order = list(dict.fromkeys(host_of[wid] for wid in alive))

        scope = f"{ASSIGN_SCOPE}.{self.version}"
        for rank, wid in enumerate(alive):
            h = host_of[wid]
            lr = local_rank[wid]
            hosts_at_lr = [x for x in host_order if local_counts[x] > lr]
            self.server.put(scope, wid,
                            f"{rank},{size},{lr},{local_counts[h]},"
                            f"{hosts_at_lr.index(h)},{len(hosts_at_lr)}")
        self.server.put(ELASTIC_SCOPE, VERSION_KEY, str(self.version))
        self.log.info("elastic driver: published version %d with %d "
                      "workers", self.version, size)

    def _spawn(self, worker_id, host, slot_index):
        # The fresh process must not inherit a stale lease.
        self._drop_heartbeat(worker_id)
        env = dict(self.elastic.base.env)
        env.update({
            "HVDTPU_ELASTIC": "1",
            "HVDTPU_WORKER_ID": worker_id,
            "HVDTPU_RENDEZVOUS_ADDR": self.addr,
            "HVDTPU_RENDEZVOUS_PORT": str(self.port),
            "HVDTPU_JOB_TOKEN": self.token,
            "HVDTPU_START_TIMEOUT": str(self.elastic.base.start_timeout),
        })
        slot = SimpleNamespace(hostname=host, rank=worker_id)
        proc = spawn.SlotProcess(
            slot, self.command, env,
            prefix_output=self.elastic.base.prefix_output,
            output_dir=self.elastic.base.output_filename,
            ssh_port=self.elastic.base.ssh_port,
            ssh_identity_file=self.elastic.base.ssh_identity_file)
        self.workers[worker_id] = _Worker(worker_id, host, slot_index, proc)

    def _reconcile(self, targets):
        """Diff targets vs running workers; returns True when membership
        changed (spawn/kill happened)."""
        target_ids = {t[0] for t in targets}
        changed = False
        for wid in list(self.workers):
            if wid not in target_ids:
                w = self.workers.pop(wid)
                if wid in self.rank_order:
                    self.rank_order.remove(wid)
                w.proc.terminate()
                self.stopping.append(
                    (w, time.monotonic() + self.elastic.sigkill_deadline))
                self._drop_heartbeat(wid)
                self.log.info("elastic driver: host removed, stopping %s",
                              wid)
                changed = True
        for wid, host, idx in targets:
            if wid not in self.workers:
                self._spawn(wid, host, idx)
                self.log.info("elastic driver: spawned worker %s", wid)
                changed = True
        return changed

    def _reap_stopping(self):
        """Reap scale-down terminations (no zombies) and escalate to
        SIGKILL for workers that ignore SIGTERM."""
        still = []
        now = time.monotonic()
        for w, kill_at in self.stopping:
            rc = w.proc.poll()
            if rc is not None:
                w.proc.wait()
                if rc == PREEMPT_EXIT_CODE:
                    self._count_preempt_exit(w.worker_id)
                # A SIGTERM-trapping worker keeps beating until its
                # commit-boundary hand-off: retire its lease now, unless
                # the slot was already respawned (the lease is then the
                # live successor's).
                if w.worker_id not in self.workers:
                    self._drop_heartbeat(w.worker_id)
                continue
            if now > kill_at:
                w.proc.kill()
            still.append((w, kill_at))
        self.stopping = still

    def _drop_heartbeat(self, wid):
        """Forget a worker's liveness state and retire its lease key so
        a respawn of the same slot starts with a clean record."""
        self._liveness.forget(wid)
        self.server.delete(heartbeat_mod.HEARTBEAT_SCOPE, wid)

    def _count_host_failure(self, host):
        """Failure accounting + blacklist escalation, shared by the exit
        sweep and the heartbeat detector."""
        self.fail_counts[host] = self.fail_counts.get(host, 0) + 1
        if self.fail_counts[host] >= self.elastic.host_fail_limit:
            self.blacklist.add(host)
            self._m_blacklisted.set(len(self.blacklist))
            self.log.warning(
                "elastic driver: blacklisting host %s after %d "
                "failures", host, self.fail_counts[host])

    def _check_heartbeats(self):
        """Fail workers whose heartbeat lease stopped moving: the
        hung-worker detector (`_sweep_exits` only sees exits). A missed
        lease takes the same exit ramp as a crash: SIGTERM now, SIGKILL
        after ``sigkill_deadline`` via the stopping reaper, a failure
        count against the host, and a membership change so survivors
        re-rendezvous. Workers that never published a beat are exempt
        (startup is the start timeout's jurisdiction). Returns True when
        membership changed."""
        if self.elastic.heartbeat_timeout <= 0 or self.completing:
            return False
        changed = False
        now = time.monotonic()
        for wid in list(self.workers):
            value = self.server.get(heartbeat_mod.HEARTBEAT_SCOPE, wid)
            if value is None or not self._liveness.observe(wid, value, now):
                continue
            w = self.workers.pop(wid)
            if wid in self.rank_order:
                self.rank_order.remove(wid)
            w.state = FAILED
            w.proc.terminate()
            self.stopping.append(
                (w, now + self.elastic.sigkill_deadline))
            self._drop_heartbeat(wid)
            self._m_heartbeat_failures.inc()
            self._count_host_failure(w.host)
            self.log.warning(
                "elastic driver: worker %s missed its heartbeat lease "
                "for over %.0fs; treating as hung (SIGTERM, SIGKILL "
                "after %.0fs)", wid, self.elastic.heartbeat_timeout,
                self.elastic.sigkill_deadline)
            changed = True
        return changed

    def _rereq_pending(self):
        """True when a live worker asked for a re-rendezvous at a version
        beyond the current one (a failure with no process death)."""
        for key in self.server.scope_keys(ELASTIC_SCOPE):
            if not key.startswith("rereq."):
                continue
            try:
                want = int(self.server.get(ELASTIC_SCOPE, key))
            except (TypeError, ValueError):
                continue
            if want > self.version:
                return True
        return False

    def _clear_stale_rereqs(self):
        for key in self.server.scope_keys(ELASTIC_SCOPE):
            if not key.startswith("rereq."):
                continue
            try:
                want = int(self.server.get(ELASTIC_SCOPE, key))
            except (TypeError, ValueError):
                want = -1
            if want <= self.version:
                self.server.delete(ELASTIC_SCOPE, key)

    def _count_preempt_exit(self, wid):
        self.preempts += 1
        self.log.info(
            "elastic driver: worker %s left after a graceful "
            "preemption hand-off", wid)

    def _sweep_exits(self):
        """Returns True when a failure changed membership."""
        changed = False
        for wid in list(self.workers):
            w = self.workers[wid]
            rc = w.proc.poll()
            if rc is None:
                continue
            w.proc.wait()
            del self.workers[wid]
            self._drop_heartbeat(wid)
            # Drop the dead worker's rank slot NOW: if the same worker id
            # is respawned it must re-enter at the END of the order; a
            # fresh-state replacement taking rank 0 would make
            # state.sync() broadcast empty state over the survivors.
            if wid in self.rank_order:
                self.rank_order.remove(wid)
            if rc == 0:
                w.state = SUCCEEDED
                self.succeeded.append(wid)
                self.completing = True
                self.log.info("elastic driver: worker %s finished", wid)
            elif rc == PREEMPT_EXIT_CODE:
                # Graceful preemption hand-off (elastic.py SIGTERM
                # handler): the worker persisted its commit and left on
                # purpose. A membership change, not a failure: no fail
                # count against its host.
                self._count_preempt_exit(wid)
                changed = True
            elif rc == RESTART_EXIT_CODE and not self.completing:
                # Exit-restart reset (elastic.py): the worker persisted its
                # commit and asked to be respawned fresh. Not a failure,
                # and no membership change beyond what triggered the
                # reset: bumping the version here would make the respawned
                # cohort immediately stale and loop.
                self._spawn(wid, w.host, w.slot_index)
                self.log.info(
                    "elastic driver: worker %s exited for data-plane "
                    "reset; respawned fresh", wid)
            else:
                w.state = FAILED
                self._m_worker_failures.inc()
                self._count_host_failure(w.host)
                self.log.warning(
                    "elastic driver: worker %s failed (exit %d)", wid, rc)
                changed = True
        return changed

    # -- main loop -------------------------------------------------------
    def run(self):
        """Drive the job to completion; returns its exit code."""
        deadline = time.monotonic() + self.elastic.base.start_timeout
        while True:
            targets = self._discover_targets()
            if len(targets) >= self.elastic.min_np:
                break
            if time.monotonic() > deadline:
                self.server.stop()
                raise RuntimeError(
                    f"discovery produced only {len(targets)} slots "
                    f"within the start timeout; "
                    f"min_np={self.elastic.min_np}")
            time.sleep(self.elastic.discovery_interval)

        self.addr = (self.elastic.base.rendezvous_addr
                     or _rendezvous_ip([SimpleNamespace(hostname=t[1])
                                        for t in targets]))
        self.version = 0
        self._reconcile(targets)
        self._publish()

        last_discovery = time.monotonic()
        finish_deadline = None
        try:
            while self.workers:
                changed = self._sweep_exits()
                changed |= self._check_heartbeats()
                self._reap_stopping()
                now = time.monotonic()
                targets = None
                if (not self.completing
                        and now - last_discovery
                        >= self.elastic.discovery_interval):
                    last_discovery = now
                    targets = self._discover_targets()
                    changed |= ({t[0] for t in targets}
                                != set(self.workers))
                if not self.completing and self._rereq_pending():
                    changed = True
                if changed and not self.completing:
                    self.resets += 1
                    self._m_resets.inc()
                    if (self.elastic.reset_limit is not None
                            and self.resets > self.elastic.reset_limit):
                        raise RuntimeError(
                            f"elastic reset count {self.resets} exceeded "
                            f"--reset-limit {self.elastic.reset_limit}")
                    # Retire the old version's keys BEFORE spawning
                    # replacements: a respawned worker must never pick up
                    # the dead cohort's assignment and try to dial stale
                    # listeners. The version key itself is published last,
                    # after the new assignment is complete.
                    old = self.version
                    self.version += 1
                    self.server.clear_scope(f"{ASSIGN_SCOPE}.{old}")
                    self.server.clear_scope(f"{PEER_SCOPE}.{old}")
                    if targets is None:
                        targets = self._discover_targets()
                    self._reconcile(targets)
                    if len(self.workers) < self.elastic.min_np:
                        # Below quorum: keep polling discovery for
                        # replacement hosts until the start timeout.
                        wait_until = now + self.elastic.base.start_timeout
                        while (len(self.workers) < self.elastic.min_np
                               and time.monotonic() < wait_until):
                            self._sweep_exits()
                            self._check_heartbeats()
                            self._reap_stopping()
                            self._reconcile(self._discover_targets())
                            time.sleep(self.elastic.discovery_interval)
                        if len(self.workers) < self.elastic.min_np:
                            raise RuntimeError(
                                f"{len(self.workers)} workers alive < "
                                f"min_np={self.elastic.min_np}; aborting")
                    self._publish()
                    self._clear_stale_rereqs()
                if self.completing and finish_deadline is None:
                    finish_deadline = now + 60
                if finish_deadline is not None and now > finish_deadline:
                    self.log.warning(
                        "elastic driver: stragglers after success; killing")
                    for w in self.workers.values():
                        w.proc.terminate()
                    finish_deadline = now + 1e9
                time.sleep(0.05)
        except Exception:
            for w in self.workers.values():
                w.proc.terminate()
            raise
        finally:
            deadline = time.monotonic() + 5
            leftovers = list(self.workers.values()) + \
                [w for w, _ in self.stopping]
            for w in leftovers:
                if w.proc.poll() is None and time.monotonic() < deadline:
                    try:
                        w.proc.proc.wait(
                            max(0.1, deadline - time.monotonic()))
                    except Exception:  # noqa: BLE001
                        pass
                w.proc.kill()
            self.server.stop()
        return 0 if self.succeeded else 1


def launch_elastic_job(elastic, command):
    """Entry used by the launcher for elastic flags; returns the exit
    code."""
    spawn.reset_capture_dir(elastic.base.output_filename)
    driver = ElasticDriver(elastic, command)
    try:
        return driver.run()
    except RuntimeError as e:
        get_logger().error("elastic job failed: %s", e)
        return 1


__all__ = ["ElasticSettings", "ElasticDriver", "HostDiscovery",
           "launch_elastic_job"]

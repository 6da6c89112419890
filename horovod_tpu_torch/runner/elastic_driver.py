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

Control-plane HA (``HVDTPU_DRIVER_JOURNAL``, ``--standby-endpoints``):
every mutation is journaled before it is published, the workers get the
ordered endpoint list for their KV client's failover, a promoted standby
adopts the running cohort (``_AdoptedProc``: exit markers and heartbeat
pids instead of child handles), and a healed stale primary finds the newer
term by probing its standbys and demotes (``DEMOTED_RC``). ``driver`` is a
chaos point (``kill``, ``partition``).

Not ported: the fleet arbiter's transfer markers (ROADMAP queue A, item
14); every graceful exit-83 hand-off counts as a preemption.
"""

import os
import signal
import subprocess
import time
from types import SimpleNamespace

from . import spawn
from . import heartbeat as heartbeat_mod
from . import journal as journal_mod
from .hosts import HostInfo
from .http_server import RendezvousServer, new_job_token
from .job import _rendezvous_ip
from ..chaos import ChaosSignal, inject as _chaos_inject
from ..exceptions import PREEMPT_EXIT_CODE, RESTART_EXIT_CODE
from .rendezvous import (ASSIGN_SCOPE, ELASTIC_SCOPE, EXIT_SCOPE,
                         PEER_SCOPE, VERSION_KEY)
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger

RUNNING, SUCCEEDED, FAILED = "running", "succeeded", "failed"

#: Exit code of a driver that discovered it is a fenced stale primary
#: and demoted itself (its workers belong to the newer primary now).
DEMOTED_RC = 3


def _check_heartbeat_config(timeout_s, worker_env):
    """True (and a warning logged) when the liveness timeout is below
    ~2 beat intervals — every healthy worker would read as hung and be
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
            "worker beat interval %.1fs — healthy workers WILL be "
            "failed as hung; raise HVDTPU_HEARTBEAT_TIMEOUT or lower "
            "HVDTPU_HEARTBEAT_INTERVAL", timeout_s, interval)
        return True
    return False


class ElasticSettings:
    def __init__(self, settings, discovery_script=None, min_np=1,
                 max_np=None, reset_limit=None, host_fail_limit=3,
                 discovery_interval=1.0, heartbeat_timeout=None,
                 sigkill_deadline=None, journal_dir=None,
                 standby_addrs=None, driver_port=None):
        self.base = settings
        self.discovery_script = discovery_script
        self.min_np = min_np
        self.max_np = max_np
        self.reset_limit = reset_limit
        self.host_fail_limit = host_fail_limit
        self.discovery_interval = discovery_interval
        # Control-plane HA (docs/fault_tolerance.md "Control-plane HA"):
        # journal directory (unset = no journal object, no term
        # fencing, no extra KV traffic — the existing code path),
        # standby endpoints exported to workers for KV failover, and
        # an optional fixed listen port so standbys are addressable
        # before they exist.
        self.journal_dir = (
            envparse.get_str(envparse.DRIVER_JOURNAL, "")
            if journal_dir is None else journal_dir)
        self.standby_addrs = (
            envparse.get_str(envparse.DRIVER_STANDBY_ADDRS, "")
            if standby_addrs is None else standby_addrs)
        self.driver_port = (
            envparse.get_int(envparse.DRIVER_PORT, 0)
            if driver_port is None else driver_port)
        self.lease_interval = envparse.get_float(
            envparse.DRIVER_LEASE_INTERVAL, 1.0)
        # Liveness: a worker whose heartbeat lease stops moving for this
        # long is failed (0 disables; docs/fault_tolerance.md).
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


class _AdoptedProc:
    """SlotProcess-shaped shim for a worker *inherited* through a
    control-plane failover: the promoted standby never spawned it, so
    there is no child handle. Exit detection reads the worker's
    ``elastic.exit`` KV marker (durable — journaled; written by
    elastic.py on success/preempt/restart exits); signaling falls back
    to the pid carried in the worker's heartbeat lease when the worker
    runs on this host. A worker that dies without a marker is caught by
    the heartbeat timeout like any hung worker."""

    def __init__(self, server, wid, host=None):
        self._server = server
        self._wid = wid
        self._host = host
        self._rc = None
        self.proc = self  # the reaper's w.proc.proc.wait() shape

    def poll(self):
        if self._rc is not None:
            return self._rc
        value = self._server.get(EXIT_SCOPE, self._wid)
        if value is not None:
            try:
                self._rc = int(value.decode())
            except (ValueError, UnicodeDecodeError):
                self._rc = 1
        return self._rc

    def wait(self, timeout=None):
        del timeout
        return self.poll()

    def _pid(self):
        value = self._server.get(heartbeat_mod.HEARTBEAT_SCOPE,
                                 self._wid)
        if not value:
            return None
        try:
            return int(value.split(b":")[0])
        except ValueError:
            return None

    def _signal(self, sig):
        if self._host is None or not spawn.is_local(self._host):
            return
        pid = self._pid()
        if pid:
            try:
                os.kill(pid, sig)
            except (ProcessLookupError, PermissionError):
                pass

    def terminate(self):
        self._signal(signal.SIGTERM)

    def kill(self):
        self._signal(signal.SIGKILL)


class ElasticDriver:
    """Owns the rendezvous server and the worker fleet for one job."""

    def __init__(self, elastic, command, discovery=None, server=None,
                 resume_state=None, term=None):
        self.elastic = elastic
        self.command = command
        # Pluggable membership source: anything with find_available_hosts()
        # -> [HostInfo]. The Ray integration substitutes actor-cluster
        # discovery here (ray/elastic.py RayHostDiscovery).
        self.discovery = discovery or HostDiscovery(elastic)
        # An externally-fixed token lets a warm standby share the job's
        # auth domain (the launcher's --standby needs it; workers keep
        # their spawn-time token across a takeover).
        self.token = envparse.get_str(envparse.JOB_TOKEN) \
            or new_job_token()
        # Durable control plane: every mutation below goes through the
        # journal first when HVDTPU_DRIVER_JOURNAL is set; None keeps
        # the pre-HA code path byte for byte (guard-tested).
        self.journal = None
        self.term = None  # None = unfenced writes (HA off)
        if elastic.journal_dir:
            self.journal = journal_mod.DriverJournal(
                elastic.journal_dir,
                snapshot_every=envparse.get_int(
                    envparse.DRIVER_JOURNAL_SNAPSHOT_EVERY, 256),
                term=1 if term is None else term)
            self.term = self.journal.term
        elif term is not None:
            self.term = term
        if server is not None:
            # Promotion path: adopt the standby's already-running
            # server (workers are already pointed at its endpoint).
            self.server = server
            self.port = server.port
        else:
            self.server = RendezvousServer(job_token=self.token,
                                           verbose=elastic.base.verbose,
                                           port=elastic.driver_port)
            self.port = self.server.start()
        if self.term is not None:
            self.server.set_term(self.term)
        if self.journal is not None:
            self.server.attach_journal(self.journal)
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
        self._demoted = False
        self._last_term_probe = 0.0
        self._probe_idx = 0
        self._adopted_deadlines = {}  # wid -> silent-adoption deadline
        self._last_targets = []
        self._discovery_failures = 0
        # Driver-side elastic counters (NULL no-ops when metrics off).
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
        if resume_state is not None:
            self._adopt_state(resume_state)

    DISCOVERY_FAIL_LIMIT = 30  # consecutive failures before aborting

    # -- control-plane HA ------------------------------------------------
    def _adopt_state(self, state):
        """Promotion: rebuild in-memory driver state from a journal
        replica and adopt the running cohort. Deliberately does NOT
        bump the elastic version — a takeover with unchanged
        membership must be invisible to in-flight collectives; only a
        real membership change moves the version."""
        self.version = state["version"]
        self.rank_order = list(state["rank_order"])
        self.blacklist = set(state["blacklist"])
        self.fail_counts = dict(state["fail_counts"])
        self.resets = state.get("resets", 0)
        self._m_blacklisted.set(len(self.blacklist))
        # Durable KV (commits, exit markers, assignment table) is
        # re-served as-is; worker-written keys that landed here after
        # the primary died win over the replica (overwrite=False).
        self.server.load_state(state["kv"])
        grace = max(self.elastic.heartbeat_timeout,
                    2 * heartbeat_mod.heartbeat_interval(), 10.0)
        now = time.monotonic()
        for wid, rec in state["workers"].items():
            self.workers[wid] = _Worker(
                wid, rec["host"], rec["slot"],
                _AdoptedProc(self.server, wid, host=rec["host"]))
            if self.elastic.heartbeat_timeout > 0:
                # An adopted worker that never surfaces on this
                # control plane (no beat, no exit marker) died with
                # the old primary; without a deadline the never-beaten
                # exemption would wait for it forever.
                self._adopted_deadlines[wid] = now + grace
        self._last_targets = [
            (wid, rec["host"], rec["slot"])
            for wid, rec in state["workers"].items()]

    def _wt(self):
        """Term stamped on this driver's own store mutations (None =
        unfenced when HA is off)."""
        return self.term

    def _jrec(self, op, **fields):
        if self.journal is not None:
            self.journal.record(op, **fields)

    def _endpoint_csv(self):
        """Ordered rendezvous endpoint list for workers: this driver
        first, then the configured standbys ('' when HA is off)."""
        if not self.elastic.standby_addrs:
            return ""
        own = f"{self.addr}:{self.port}"
        rest = [e.strip() for e in
                self.elastic.standby_addrs.split(",")
                if e.strip() and e.strip() != own]
        return ",".join([own] + rest)

    def _chaos_driver(self):
        """Chaos `driver` injection point: `kill` fires directly
        (SIGKILL — the abrupt driver-death scenario); `partition` is a
        signal this site consumes by black-holing the KV/journal
        routes for the rule's ms window."""
        try:
            _chaos_inject("driver", wid="primary", version=self.version)
        except ChaosSignal as sig:
            if sig.action == "partition":
                ms = sig.rule.ms if sig.rule.ms is not None else 5000
                self.log.warning(
                    "chaos: partitioning driver KV store for %d ms", ms)
                self.server.pause_for(ms / 1000.0)

    def _check_term_fence(self, now):
        """Probe the configured standby endpoints for a higher term.
        A healed stale primary must discover the takeover and demote
        LOUDLY instead of mutating cohort state the moment its next
        membership event fires; the probe turns that race into a
        bounded window (one lease interval)."""
        if self.term is None or not self.elastic.standby_addrs:
            return
        if self.server.paused():
            # A partitioned driver cannot reach its peers either; the
            # probe resumes when the partition heals (chaos realism).
            return
        if now - self._last_term_probe < self.elastic.lease_interval:
            return
        self._last_term_probe = now
        from . import http_client
        peers = [c.strip() for c in self.elastic.standby_addrs.split(",")
                 if c.strip() and c.strip() != f"{self.addr}:{self.port}"]
        if not peers:
            return
        # ONE endpoint per tick, short timeout: the probe runs on the
        # single-threaded main loop, and a black-holed standby must not
        # wedge exit sweeping / heartbeat detection for seconds per
        # iteration — the fence window widens to len(peers) intervals,
        # still bounded.
        chunk = peers[self._probe_idx % len(peers)]
        self._probe_idx += 1
        host, _, port = chunk.rpartition(":")
        observed = http_client.probe_term(host, port, token=self.token,
                                          timeout=1)
        if observed is not None and journal_mod.term_fences(self.term,
                                                            observed):
            raise journal_mod.StaleTermError(
                f"term probe of standby {chunk}", self.term, observed)

    # -- membership ------------------------------------------------------
    def _discover_targets(self):
        """(worker_id, host, slot_index) for every slot in the current
        discovery output, minus blacklisted hosts, capped at max_np. A
        transient discovery failure keeps the last known membership —
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
        lowest ranks — rank 0 is always a survivor, which is what makes
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
        assign = {}
        for rank, wid in enumerate(alive):
            h = host_of[wid]
            lr = local_rank[wid]
            hosts_at_lr = [x for x in host_order if local_counts[x] > lr]
            assign[wid] = (f"{rank},{size},{lr},{local_counts[h]},"
                           f"{hosts_at_lr.index(h)},{len(hosts_at_lr)}")
        # Journal BEFORE publish: a standby replaying the journal may
        # trail reality but can never be ahead of it.
        self._jrec("membership", version=self.version, rank_order=alive,
                   workers={wid: {"host": host_of[wid],
                                  "slot": self.workers[wid].slot_index}
                            for wid in alive},
                   resets=self.resets, assign=assign)
        for wid, line in assign.items():
            self.server.put(scope, wid, line, term=self._wt())
        self.server.put(ELASTIC_SCOPE, VERSION_KEY, str(self.version),
                        term=self._wt())
        self.log.info("elastic driver: published version %d with %d "
                      "workers", self.version, size)

    def _spawn(self, worker_id, host, slot_index):
        # Belt and braces for the never-beaten exemption: whatever path
        # led here, the fresh process must not inherit a stale lease —
        # nor a predecessor's exit marker (it would be reaped at birth).
        # The marker delete is JOURNALED: the marker arrived over HTTP
        # (journaled by the handler), so without a matching delete a
        # journal replica would resurrect it and a promoted standby
        # would reap the live respawn the moment it adopted it.
        self._drop_heartbeat(worker_id)
        self._jrec("kv_delete", scope=EXIT_SCOPE, key=worker_id)
        self.server.delete(EXIT_SCOPE, worker_id, term=self._wt())
        env = dict(self.elastic.base.env)
        env.update({
            "HVDTPU_ELASTIC": "1",
            "HVDTPU_WORKER_ID": worker_id,
            "HVDTPU_RENDEZVOUS_ADDR": self.addr,
            "HVDTPU_RENDEZVOUS_PORT": str(self.port),
            "HVDTPU_JOB_TOKEN": self.token,
            "HVDTPU_START_TIMEOUT": str(self.elastic.base.start_timeout),
        })
        endpoints = self._endpoint_csv()
        if endpoints:
            # Ordered failover list for the worker's KV client
            # (http_client: re-resolve on connection-class exhaustion).
            env["HVDTPU_RENDEZVOUS_ADDRS"] = endpoints
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
                    # A stop-requested worker that hands off at its
                    # commit boundary is the arbiter-shrink path (the
                    # target file shrank under a lease): same cause
                    # accounting as a self-initiated exit 83.
                    self._count_preempt_exit(w.worker_id)
                # The lease may have been re-published between the stop
                # request and the actual exit (a SIGTERM-trapping worker
                # keeps beating until its commit-boundary hand-off);
                # retire it NOW so a respawn of the same slot is judged
                # by its own beats, not a dead predecessor's frozen one.
                # UNLESS the slot was already respawned: the lease then
                # belongs to the live successor — deleting it would
                # blind hung-worker detection until its next beat.
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
        self.server.delete(heartbeat_mod.HEARTBEAT_SCOPE, wid,
                           term=self._wt())

    def _count_host_failure(self, host):
        """Failure accounting + blacklist escalation, shared by the
        exit sweep and the heartbeat detector (one place to keep the
        policy from drifting)."""
        self.fail_counts[host] = self.fail_counts.get(host, 0) + 1
        if self.fail_counts[host] >= self.elastic.host_fail_limit:
            self.blacklist.add(host)
            self._m_blacklisted.set(len(self.blacklist))
            self.log.warning(
                "elastic driver: blacklisting host %s after %d "
                "failures", host, self.fail_counts[host])
        self._jrec("fail_count", host=host,
                   count=self.fail_counts[host],
                   blacklisted=host in self.blacklist)

    def _check_heartbeats(self):
        """Fail workers whose heartbeat lease stopped moving — the
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
            if value is None:
                # Adopted workers (promotion) get a bounded grace to
                # surface on the NEW control plane; spawned workers
                # keep the never-beaten exemption (startup is the
                # start timeout's jurisdiction).
                deadline = self._adopted_deadlines.get(wid)
                if deadline is None or now < deadline:
                    continue
            else:
                self._adopted_deadlines.pop(wid, None)
                if not self._liveness.observe(wid, value, now):
                    continue
            self._adopted_deadlines.pop(wid, None)
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
        beyond the current one (transport failure with no process death)."""
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
            # is respawned it must re-enter at the END of the order — a
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
                # purpose. A membership change, not a failure — no
                # fail count, no blacklist pressure on a host that did
                # everything right on its way out. Unconditional on
                # ``completing`` (the re-publish below is gated anyway):
                # a preemption during wind-down must not read as a crash.
                self._count_preempt_exit(wid)
                changed = True
            elif rc == RESTART_EXIT_CODE and self.completing:
                # An exit-restart while the job winds down: the worker
                # asked for a fresh process the finished job no longer
                # needs. A neutral exit: no fail count, no blacklist
                # pressure on a healthy host, no respawn. (The JAX
                # driver sends it to FAILED, ROADMAP queue C, C5.)
                w.state = SUCCEEDED
                self.log.info(
                    "elastic driver: worker %s exited for a reset during "
                    "wind-down; not respawned", wid)
            elif rc == RESTART_EXIT_CODE:
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
    def run(self, resume=False):
        """Drive the job to completion. ``resume=True`` is the
        promoted-standby entry: membership, durable KV and the adopted
        cohort are already in place (``_adopt_state``), so the initial
        discovery/publish is skipped and the elastic version does NOT
        move — the takeover is invisible to in-flight collectives."""
        if not resume:
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
            self.server.set_primary_hint(f"{self.addr}:{self.port}")
            self.version = 0
            self._reconcile(targets)
            self._publish()

        last_discovery = time.monotonic()
        finish_deadline = None
        try:
            while self.workers:
                self._chaos_driver()
                self._check_term_fence(time.monotonic())
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
                    self.server.clear_scope(f"{ASSIGN_SCOPE}.{old}",
                                            term=self._wt())
                    self.server.clear_scope(f"{PEER_SCOPE}.{old}",
                                            term=self._wt())
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
        except journal_mod.StaleTermError as e:
            # A newer primary owns the cohort: demote WITHOUT touching
            # the workers — they are the new primary's now, and killing
            # them would be exactly the split-brain damage the fence
            # exists to prevent. Loud, never silent.
            self._demoted = True
            self.log.error(
                "elastic driver: STALE PRIMARY FENCED — %s. Demoting; "
                "leaving the worker fleet to the newer primary.", e)
        except Exception:
            for w in self.workers.values():
                w.proc.terminate()
            raise
        finally:
            if not self._demoted:
                deadline = time.monotonic() + 5
                leftovers = list(self.workers.values()) + \
                    [w for w, _ in self.stopping]
                for w in leftovers:
                    if w.proc.poll() is None \
                            and time.monotonic() < deadline:
                        try:
                            w.proc.proc.wait(
                                max(0.1, deadline - time.monotonic()))
                        except Exception:  # noqa: BLE001
                            pass
                    w.proc.kill()
            self.server.stop()
            if self.journal is not None:
                self.journal.close()

        if self._demoted:
            return DEMOTED_RC
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
           "launch_elastic_job", "DEMOTED_RC"]

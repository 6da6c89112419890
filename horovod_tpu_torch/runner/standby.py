"""Warm-standby driver: journal tailing, lease tracking, promotion (port of
``horovod_tpu/runner/standby.py``).

The second half of control-plane HA (docs/fault_tolerance.md
"Control-plane HA"): a standby launcher started with ``python -m
horovod_tpu_torch.runner.launch --standby PRIMARY_HOST:PORT`` runs this
controller instead of an ``ElasticDriver``. It

1. binds its own KV store on a FIXED port (``HVDTPU_DRIVER_PORT``) —
   the endpoint the primary already advertised to workers in
   ``HVDTPU_RENDEZVOUS_ADDRS`` — and hints every early caller back at
   the primary (``X-Hvd-Primary``) while the primary is alive;
2. tails the primary's token-gated ``GET /journal?since=seq`` route
   every ``HVDTPU_DRIVER_LEASE_INTERVAL`` seconds into a
   ``JournalReplica`` (a read-only copy of membership, blacklist and
   the durable KV scopes);
3. treats each successful poll as a lease renewal; once the primary
   has been unreachable for ``HVDTPU_DRIVER_LEASE_TIMEOUT`` seconds it
   **promotes**: term := replica term + 1, the replica state becomes a
   live ``ElasticDriver`` over the standby's already-running server
   (the cohort is *adopted*, not respawned; the elastic version does
   NOT move), and the takeover is counted in
   ``hvd_driver_failover_total``.

Split-brain: the promotion bumps the term, so a healed stale primary
is fenced — its in-process mutations raise ``StaleTermError`` once its
store observes the newer term (a failed-over worker's write, or its
own standby probe), and it demotes without touching the workers that
now belong to the promoted standby.
"""

import json
import time

from . import http_client
from .elastic_driver import ElasticDriver
from .http_server import RendezvousServer
from .journal import JournalReplica
from ..chaos import ChaosSignal, inject as _chaos_inject
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger


def _m_failover():
    return telemetry.counter(
        "hvd_driver_failover_total",
        "Warm-standby promotions (control-plane takeovers)")


class StandbyController:
    """One warm standby for one primary. ``run()`` blocks: replicate
    until the lease expires, then promote and drive the adopted job to
    completion (returning its exit code)."""

    def __init__(self, elastic, command, primary, advertise=None,
                 lease_interval=None, lease_timeout=None):
        self.elastic = elastic
        self.command = command
        host, _, port = primary.rpartition(":")
        if not host:
            raise ValueError(
                f"--standby expects PRIMARY_HOST:PORT, got {primary!r}")
        self.primary = (host, int(port))
        self.token = envparse.get_str(envparse.JOB_TOKEN)
        if not self.token:
            raise RuntimeError(
                "a standby needs the job's shared token: export "
                "HVDTPU_JOB_TOKEN to the same value on the primary "
                "and the standby")
        self.lease_interval = (
            envparse.get_float(envparse.DRIVER_LEASE_INTERVAL, 1.0)
            if lease_interval is None else lease_interval)
        self.lease_timeout = (
            envparse.get_float(envparse.DRIVER_LEASE_TIMEOUT, 10.0)
            if lease_timeout is None else lease_timeout)
        self.replica = JournalReplica()
        self.advertise = advertise or elastic.base.rendezvous_addr \
            or "127.0.0.1"
        self.server = RendezvousServer(job_token=self.token,
                                       verbose=elastic.base.verbose,
                                       port=elastic.driver_port)
        self.port = self.server.start()
        # Primary hint pre-promotion is DYNAMIC (_update_hint): while
        # our lease view says the primary is alive, stray callers — a
        # worker that defected here during a transient primary blip —
        # are pointed back at it, so a sub-lease-timeout outage cannot
        # permanently strand workers on a store the primary never
        # reads. Once the lease looks expired the hint is withdrawn (a
        # hint at a dead endpoint would just flap every client), and
        # at promotion it names ourselves.
        self.synced = False
        self.promoted = None     # ElasticDriver after promotion
        self.promoted_digest = None
        self.log = get_logger()

    # -- replication -------------------------------------------------------
    def poll_once(self):
        """One /journal fetch; True = lease renewed (entries applied to
        the replica and mirrored into this store's durable scopes)."""
        host, port = self.primary
        url = (f"http://{host}:{port}/journal"
               f"?since={self.replica.seq}")
        try:
            with http_client._request("GET", url, token=self.token,
                                      timeout=max(2.0,
                                                  self.lease_interval)
                                      ) as resp:
                payload = json.loads(resp.read().decode())
        except Exception as e:  # noqa: BLE001 — any transport failure
            self.log.debug("standby: journal poll failed: %s", e)
            return False
        self.replica.apply_payload(payload)
        self.synced = True
        return True

    def _update_hint(self, primary_alive):
        """Advertise the primary on our responses only while the lease
        view says it is alive (see __init__ note)."""
        hint = (f"{self.primary[0]}:{self.primary[1]}"
                if primary_alive else None)
        if hint != self.server.primary_hint:
            self.server.set_primary_hint(hint)

    # -- promotion ---------------------------------------------------------
    def promote(self):
        """Turn the replica into a live driver at term+1. The adopted
        cohort keeps its membership version; the elastic version moves
        only if membership later actually changes."""
        state = self.replica.snapshot_state()
        new_term = max(self.replica.term, 1) + 1
        self.promoted_digest = self.replica.digest()
        _m_failover().inc()
        self.log.warning(
            "standby: PRIMARY LEASE EXPIRED — promoting to primary at "
            "term %d (replica seq %d, membership version %s, %d "
            "workers adopted)", new_term, self.replica.seq,
            state["version"], len(state["workers"]))
        self.server.set_term(new_term)
        self.server.set_primary_hint(f"{self.advertise}:{self.port}")
        driver = ElasticDriver(self.elastic, self.command,
                               server=self.server, resume_state=state,
                               term=new_term)
        driver.addr = self.advertise
        if driver.journal is not None:
            # Chainable HA: re-state term + membership + EVERY durable
            # KV key in OUR journal, so a next-generation standby (or a
            # crash-recovery replay of this dir) reconstructs the same
            # state — membership alone would lose the workers' commits.
            driver.journal.set_term(new_term)
            driver.journal.record("term", term=new_term)
            if state["version"] >= 0:
                assign = state["kv"].get(f"assign.{state['version']}",
                                         {})
                driver.journal.record(
                    "membership", version=state["version"],
                    rank_order=state["rank_order"],
                    workers=state["workers"],
                    resets=state.get("resets", 0), assign=assign)
            # Journal from the live STORE, not the replica snapshot:
            # worker writes that landed here during the takeover
            # window (journal was None pre-promotion) are newer than
            # the replica's values and load_state let them win.
            from .journal import DURABLE_SCOPES
            for scope in DURABLE_SCOPES:
                for key in self.server.scope_keys(scope):
                    value = self.server.get(scope, key)
                    if value is not None:
                        driver.journal.record(
                            "kv_put", scope=scope, key=key,
                            value=value.decode("latin-1"))
        self.promoted = driver
        return driver

    # -- main loop ---------------------------------------------------------
    def run(self):
        """Replicate until the lease expires, then promote and run the
        adopted job to completion."""
        self.log.info(
            "standby: tailing journal of primary %s:%d (lease "
            "interval %.1fs, timeout %.1fs), serving on port %d",
            self.primary[0], self.primary[1], self.lease_interval,
            self.lease_timeout, self.port)
        last_ok = time.monotonic()
        sync_deadline = (last_ok + self.elastic.base.start_timeout
                         + self.lease_timeout)
        while True:
            try:
                _chaos_inject("driver", wid="standby",
                              version=self.replica.seq)
            except ChaosSignal as sig:
                if sig.action == "partition":
                    ms = sig.rule.ms if sig.rule.ms is not None else 5000
                    self.server.pause_for(ms / 1000.0)
            ok = self.poll_once()
            if ok:
                last_ok = time.monotonic()
            self._update_hint(
                self.synced
                and time.monotonic() - last_ok <= self.lease_timeout)
            if not ok and self.synced \
                    and (time.monotonic() - last_ok
                         > self.lease_timeout):
                # Never promote before the FIRST successful sync: an
                # empty replica describes no cohort — taking over with
                # it would "adopt" nothing and exit successfully.
                break
            elif not self.synced \
                    and time.monotonic() > sync_deadline:
                self.server.stop()
                raise RuntimeError(
                    "standby: never reached the primary's journal at "
                    f"{self.primary[0]}:{self.primary[1]} within the "
                    "start timeout — wrong endpoint, token, or the "
                    "primary has no HVDTPU_DRIVER_JOURNAL")
            time.sleep(self.lease_interval)
        driver = self.promote()
        if not driver.workers:
            # The primary died before publishing any membership (or the
            # replica describes a cohort with nobody in it): there is
            # nothing to adopt, but we hold the command and settings —
            # run the job FRESH instead of reporting a phantom failure.
            self.log.warning(
                "standby: promoted over an empty cohort (primary died "
                "before publishing membership); starting the job fresh")
            return driver.run(resume=False)
        return driver.run(resume=True)

    def observed_term(self):
        """Probe helper (tests/ops): the primary's current term as
        advertised on its response headers, or None when unreachable."""
        host, port = self.primary
        return http_client.probe_term(host, port, token=self.token)

    def stop(self):
        """Tear down a standby that never promoted (tests)."""
        if self.promoted is None:
            self.server.stop()


def launch_standby(elastic, command, primary):
    """Entry used by the launcher's --standby; returns the exit code.
    Construction is inside the try: a missing HVDTPU_JOB_TOKEN or a
    malformed HOST:PORT must take the clean error path too, not an
    unhandled traceback."""
    try:
        controller = StandbyController(elastic, command, primary)
        return controller.run()
    except (RuntimeError, ValueError) as e:
        get_logger().error("standby failed: %s", e)
        return 1


__all__ = ["StandbyController", "launch_standby"]

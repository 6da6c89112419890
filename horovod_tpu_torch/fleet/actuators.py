"""Fleet actuators: the only cohort-mutation surface outside the drivers
(port of ``horovod_tpu/fleet/actuators.py``).

Everything here is an **idempotent desired-state write** — target files
the elastic discovery scripts read, drain flags on the KV plane, transfer
markers in the ledger. That property is what makes the arbiter's crash
story simple: a promoted standby that finds a lease mid-flight re-issues
the current state's actuation verbatim (ledger.resume_action) and
nothing double-fires, because writing the same target file or raising an
already-raised drain flag twice is a no-op. Worker processes are spawned
and terminated only by the elastic drivers reconciling these writes
(runner/elastic_driver.py, runner/spawn.py).

The stock actuator set drives both planes through the same elastic
machinery the autoscaler uses (serving/autoscale.py ``write_target``):
shrinking the training target file makes the training driver deliver
graceful SIGTERM preemption at the next commit boundary (exit 83 →
membership change), growing the serving target adds serving workers that
join through the normal router/KV registration.

The drain flags raised here are migration-backed: the port's
``ServingWorker`` polls ``drain.<cohort>.<wid>`` and hands its in-flight
KV pages to a surviving peer (serving/migration.py) instead of decoding
them to completion; without a peer, or on a refused transfer, they finish
locally. Either way no accepted request is lost.
"""

import json

from ..chaos import inject as _chaos_inject
from ..serving.autoscale import write_target
from ..serving.worker import SERVING_SCOPE
from ..utils.logging_util import get_logger


class TargetFileActuators:
    """Desired-state writes for a single-host slot budget: the
    training cohort is ``host:0..n-1`` of the training target file,
    the serving cohort ``host:0..m-1`` of the serving one. ``kv_put``
    (a ``(scope, key, value)`` callable) carries drain flags to the
    serving plane; None disables them (callers that drain through
    their own channel)."""

    def __init__(self, train_target, serve_target, *,
                 host="localhost", serve_cohort="serve", kv_put=None):
        self.train_target = train_target
        self.serve_target = serve_target
        self.host = host
        self.serve_cohort = serve_cohort
        self.kv_put = kv_put
        self._log = get_logger()

    # -- victim selection --------------------------------------------------
    def pick_train_victims(self, old_slots, new_slots):
        """Shrinking a ``host:slots`` line drops the highest slot
        indices — pick exactly those so the ledger's transfer markers
        name the workers the driver will actually preempt."""
        return [f"{self.host}:{i}" for i in range(new_slots, old_slots)]

    def pick_serve_victims(self, old_slots, new_slots):
        return [f"{self.host}:{i}" for i in range(new_slots, old_slots)]

    # -- desired-state writes ----------------------------------------------
    def set_train_slots(self, slots):
        self._log.info("fleet actuate: training target -> %d slot(s)",
                       slots)
        lines = [f"{self.host}:{slots}"] if slots > 0 else []
        write_target(self.train_target, lines)

    def set_serve_slots(self, slots):
        self._log.info("fleet actuate: serving target -> %d slot(s)",
                       slots)
        lines = [f"{self.host}:{slots}"] if slots > 0 else []
        write_target(self.serve_target, lines)

    def drain(self, wid):
        """Raise the per-worker drain flag for one serving victim
        (serving/worker.py polls ``drain.<cohort>.<wid>``). Per-worker
        and slot-index-keyed, so the ebb of one slot never drains the
        survivors of the same cohort."""
        slot = wid.rsplit(":", 1)[-1]
        _chaos_inject("drain", name=self.serve_cohort, wid=wid)
        if self.kv_put is None:
            return
        self._log.info("fleet actuate: draining serving worker %s.%s",
                       self.serve_cohort, slot)
        self.kv_put(SERVING_SCOPE, f"drain.{self.serve_cohort}.{slot}",
                    "1")


class DriverProbes:
    """Settledness probes over an in-process training ElasticDriver
    plus the serving stats pushed to its KV store — the arbiter polls
    these to decide when a lease may advance. Read-only by design:
    probes observe, actuators write, drivers own processes."""

    def __init__(self, driver, serve_cohort="serve"):
        self.driver = driver
        self.serve_cohort = serve_cohort

    def train_size(self):
        return len(self.driver.workers)

    def train_victims_gone(self, victims):
        """True once no victim runs or is still being stopped. Unlike
        the JAX probe (``wid not in driver.workers``), a victim handing
        off at its commit boundary (in ``driver.stopping`` until its
        process exits) is not gone yet: a lease that returns the slot
        before that exit would start a fresh process on it beside the
        old one, ahead of the state the old one persists on its way
        out."""
        stopping = {w.worker_id for w, _ in self.driver.stopping}
        return not any(wid in self.driver.workers or wid in stopping
                       for wid in victims)

    def serve_members(self):
        """wids registered under ``serving/member.<cohort>.*``."""
        prefix = f"member.{self.serve_cohort}."
        return [key[len(prefix):]
                for key in self.driver.server.scope_keys(SERVING_SCOPE)
                if key.startswith(prefix)]

    def serve_size(self):
        return len(self.serve_members())

    def cohort_stats(self):
        """The serving stats map keyed like Router.stats()['cohorts']
        — one entry per worker here, which is exactly the granularity
        drain/ebb decisions need."""
        out = {}
        prefix = "stats."
        server = self.driver.server
        for key in server.scope_keys(SERVING_SCOPE):
            if not key.startswith(prefix):
                continue
            raw = server.get(SERVING_SCOPE, key)
            if not raw:
                continue
            try:
                out[key[len(prefix):]] = json.loads(
                    raw if isinstance(raw, str) else raw.decode())
            except ValueError:
                continue
        return out

    def serve_drained(self, victims):
        """A victim is drained when its pushed stats report draining
        with nothing queued or running (accepted requests all
        finished)."""
        stats = self.cohort_stats()
        for wid in victims:
            slot = wid.rsplit(":", 1)[-1]
            s = stats.get(f"{self.serve_cohort}.{slot}")
            if s is None:
                continue  # already gone
            if not s.get("draining"):
                return False
            if int(s.get("queue_depth", 0)) + int(s.get("running", 0)) > 0:
                return False
        return True


__all__ = ["TargetFileActuators", "DriverProbes"]

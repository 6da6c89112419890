"""The fleet lease ledger: durable, term-fenced transfer records (port of
``horovod_tpu/fleet/ledger.py``).

A **lease** is the unit of chip movement between the training and
serving planes: ``{id, direction, slots, state, wids, ...}`` stored in
the KV plane's durable ``fleet`` scope (journal_spec.DURABLE_SCOPES), so
every write is journaled *before* it is acknowledged and replicated to
warm standbys. The arbiter's contract is **ledger-before-actuation**: a
state transition is written here first and only then actuated, so the
journal always bounds what can have happened — a promoted standby reading
``proposed`` knows nothing was actuated yet (roll back); any later state
means actuation may have started, and because every actuation is an
idempotent desired-state write (target files, drain flags, transfer
markers) it can simply be re-issued (roll forward). ``resume_action``
encodes exactly that rule.

Alongside leases the scope carries:

- ``active``          — the id of the (single) in-flight lease
- ``split``           — the current train/serve slot split
- ``transfer.<wid>``  — per-victim markers the training driver reads
  to account a graceful preemption to ``cause=arbiter_transfer``
  instead of a cloud notice (runner/elastic_driver.py).

Records and keys are the JAX package's byte for byte
(docs/fault_tolerance.md "The lease ledger"): either package's arbiter
resumes a ledger the other wrote.
"""

import json
import time

# The lease state machine lives in the protocol spec; this file owns
# everything impure: backends, journaled writes, terms.
from ..analysis.protocol.lease_spec import (  # noqa: F401  (re-exported)
    CHAINS,
    DIRECTIONS,
    SERVE_TO_TRAIN,
    TERMINAL_STATES,
    TRAIN_TO_SERVE,
    LeaseStateError,
    check_transition,
    next_state,
    resume_action,
)

#: The durable KV scope (runner/journal.py DURABLE_SCOPES).
SCOPE = "fleet"
ACTIVE_KEY = "active"
SPLIT_KEY = "split"
LEASE_PREFIX = "lease."
TRANSFER_PREFIX = "transfer."


# --------------------------------------------------------------------------
# Backends: where the durable writes go
# --------------------------------------------------------------------------

class MemoryBackend:
    """Dict-backed ledger storage for unit tests — same interface, no
    durability."""

    def __init__(self):
        self.data = {}

    def put(self, key, value):
        self.data[key] = value

    def get(self, key):
        return self.data.get(key)

    def delete(self, key):
        self.data.pop(key, None)


def _text(value):
    if value is None:
        return None
    return value if isinstance(value, str) else value.decode()


class DriverBackend:
    """Ledger storage colocated with the (primary) elastic driver:
    journal-record first (fsync'd), then apply to the live KV store
    stamped with the driver's term. The same journal-before-apply
    discipline the driver uses for membership (elastic_driver._jrec) —
    an in-process write must journal explicitly because only *HTTP*
    mutations are journaled by the handler."""

    def __init__(self, server, journal=None, term_fn=None):
        self.server = server
        self.journal = journal
        self.term_fn = term_fn or (lambda: None)

    def put(self, key, value):
        if self.journal is not None:
            self.journal.record("kv_put", scope=SCOPE, key=key,
                                value=value)
        self.server.put(SCOPE, key, value, term=self.term_fn())

    def get(self, key):
        return _text(self.server.get(SCOPE, key))

    def delete(self, key):
        if self.journal is not None:
            self.journal.record("kv_delete", scope=SCOPE, key=key)
        self.server.delete(SCOPE, key, term=self.term_fn())


class HttpBackend:
    """Ledger storage over the runner KV HTTP routes — for an arbiter
    running outside the driver process. Durability is free: the HTTP
    handler journals every ``fleet``-scope mutation
    (journal.durable_key) and fences stale terms server-side."""

    def __init__(self, addr, port, token=""):
        self.addr, self.port, self.token = addr, int(port), token

    def put(self, key, value):
        from ..runner import http_client
        http_client.put_kv(self.addr, self.port, SCOPE, key, value,
                           token=self.token)

    def get(self, key):
        from ..runner import http_client
        return _text(http_client.get_kv(self.addr, self.port, SCOPE, key,
                                        token=self.token))

    def delete(self, key):
        from ..runner import http_client
        http_client.delete_kv(self.addr, self.port, SCOPE, key,
                              token=self.token)


# --------------------------------------------------------------------------
# The ledger
# --------------------------------------------------------------------------

class LeaseLedger:
    """Typed access to the ``fleet`` scope over any backend. All
    mutations go through here so the write ordering (lease before
    marker before actuation) lives in one place."""

    def __init__(self, backend):
        self.backend = backend
        self._seq = 0

    # -- leases ------------------------------------------------------------
    def open(self, direction, slots, now=None):
        """Create a new lease in ``proposed`` and mark it active.
        Exactly one lease may be in flight."""
        if direction not in DIRECTIONS:
            raise LeaseStateError(f"unknown direction {direction!r}")
        if self.active() is not None:
            raise LeaseStateError(
                "a lease is already in flight; the arbiter moves one "
                "lease at a time")
        now = time.time() if now is None else now
        self._seq += 1
        lease = {
            "id": f"{direction}-{int(now)}-{self._seq}",
            "direction": direction,
            "slots": int(slots),
            "state": "proposed",
            "wids": [],
            "created": now,
            "updated": now,
        }
        self._write(lease)
        self.backend.put(ACTIVE_KEY, lease["id"])
        return lease

    def advance(self, lease, state, now=None, **fields):
        """Validated transition, written durably BEFORE the caller
        actuates it. Returns the updated lease dict."""
        check_transition(lease, state)
        lease = dict(lease)
        lease.update(fields)
        lease["state"] = state
        lease["updated"] = time.time() if now is None else now
        self._write(lease)
        if state in TERMINAL_STATES:
            self.backend.delete(ACTIVE_KEY)
        return lease

    def get(self, lease_id):
        raw = self.backend.get(LEASE_PREFIX + lease_id)
        return json.loads(raw) if raw else None

    def active(self):
        lease_id = self.backend.get(ACTIVE_KEY)
        if not lease_id:
            return None
        return self.get(lease_id.strip())

    def _write(self, lease):
        self.backend.put(LEASE_PREFIX + lease["id"],
                         json.dumps(lease, sort_keys=True))

    # -- the split ---------------------------------------------------------
    def split(self):
        """``{"train": n, "serve": m, "leased": k}`` — the current
        slot split plus how many serving slots are held under
        train->serve leases (the ebb ceiling)."""
        raw = self.backend.get(SPLIT_KEY)
        if not raw:
            return None
        split = json.loads(raw)
        split.setdefault("leased", 0)
        return split

    def set_split(self, train, serve, leased=0):
        self.backend.put(SPLIT_KEY, json.dumps(
            {"train": int(train), "serve": int(serve),
             "leased": int(leased)}, sort_keys=True))

    # -- per-victim transfer markers ----------------------------------------
    def mark_transfer(self, wid, lease_id):
        """Claim ``wid`` for a lease BEFORE the shrink that preempts
        it — the training driver reads this marker at exit-sweep time
        to account the hand-off as ``cause=arbiter_transfer``."""
        self.backend.put(TRANSFER_PREFIX + wid, lease_id)

    def transfer_of(self, wid):
        value = self.backend.get(TRANSFER_PREFIX + wid)
        return value.strip() if value else None

    def clear_transfer(self, wid):
        self.backend.delete(TRANSFER_PREFIX + wid)


__all__ = ["SCOPE", "ACTIVE_KEY", "SPLIT_KEY", "LEASE_PREFIX",
           "TRANSFER_PREFIX", "MemoryBackend", "DriverBackend",
           "HttpBackend", "LeaseLedger", "LeaseStateError",
           "resume_action"]

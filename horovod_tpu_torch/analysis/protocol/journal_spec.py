"""Pure transition spec of the HA driver journal (port of
``horovod_tpu/analysis/protocol/journal_spec.py``).

This module IS the journal's state machine: ``runner/journal.py``
imports and executes these functions. The functions and the durable-scope
list are the JAX package's, so either package replays the other's journal
directory to the same state and the same digest. Everything here is
stdlib-pure (no I/O, no locks, no clock). The ``hvd-model`` checker
(``machines.py``) explores these same functions.
"""

import hashlib
import json

#: KV scopes replicated through the journal (everything else is
#: ephemeral and re-published by workers after a failover). The
#: ``fleet`` scope holds the chip-budget arbiter's lease ledger
#: (fleet/ledger.py): a lease must be durable *before* any actuation
#: it authorises, so a standby promotion mid-transfer can resume or
#: roll it back deterministically (docs/fault_tolerance.md "Fleet
#: arbitration").
DURABLE_SCOPES = ("elastic.state", "elastic.exit", "fleet")


class JournalError(RuntimeError):
    """A journal file could not be read or an entry could not be
    applied; the message names the file/entry."""


def durable_key(scope, key):
    """True when a worker-written KV key belongs to the durable
    partition (journaled; survives failover)."""
    del key
    return scope in DURABLE_SCOPES


def term_fences(writer_term, observed_term):
    """The split-brain fence predicate: True when a mutation carrying
    ``writer_term`` must be refused because the store has already
    observed a newer primary at ``observed_term`` (docs/
    fault_tolerance.md "Split-brain fencing")."""
    return int(writer_term) < int(observed_term)


def new_state():
    """Empty driver state — the single replicated structure."""
    return {
        "term": 0,
        "version": -1,
        "rank_order": [],
        "workers": {},       # wid -> {"host": h, "slot": i}
        "blacklist": [],     # sorted host list
        "fail_counts": {},
        "resets": 0,
        "kv": {},            # durable scopes only: scope -> {key: str}
    }


def apply_entry(state, entry):
    """Apply one journal entry to a state dict (pure state transition —
    shared by the primary's bookkeeping, crash recovery, and the
    standby replica, so the three can never drift)."""
    op = entry.get("op")
    if op == "membership":
        state["version"] = entry["version"]
        state["rank_order"] = list(entry["rank_order"])
        state["workers"] = {w: dict(rec)
                            for w, rec in entry["workers"].items()}
        state["resets"] = entry.get("resets", state["resets"])
        # The assignment table IS durable KV state: a promoted standby
        # re-serves the same version so the running cohort never
        # re-rendezvouses for a takeover alone.
        kv = state["kv"]
        for scope in [s for s in kv if s.startswith("assign.")]:
            del kv[scope]
        kv[f"assign.{entry['version']}"] = dict(entry["assign"])
        kv.setdefault("elastic", {})["version"] = str(entry["version"])
    elif op == "fail_count":
        state["fail_counts"][entry["host"]] = entry["count"]
        if entry.get("blacklisted"):
            bl = set(state["blacklist"])
            bl.add(entry["host"])
            state["blacklist"] = sorted(bl)
    elif op == "kv_put":
        state["kv"].setdefault(entry["scope"], {})[entry["key"]] = \
            entry["value"]
    elif op == "kv_delete":
        state["kv"].get(entry["scope"], {}).pop(entry["key"], None)
    elif op == "kv_clear":
        state["kv"].pop(entry["scope"], None)
    elif op == "term":
        state["term"] = entry["term"]
    else:
        raise JournalError(f"journal entry seq={entry.get('seq')} has "
                           f"unknown op {op!r}")
    if entry.get("term", 0) > state["term"]:
        state["term"] = entry["term"]
    return state


def state_digest(state):
    """Canonical SHA-256 over the state — the acceptance check that a
    journal-replayed standby equals the pre-failover primary."""
    blob = json.dumps(state, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


__all__ = ["DURABLE_SCOPES", "JournalError", "durable_key",
           "term_fences", "new_state", "apply_entry", "state_digest"]

"""The three control-plane protocol models ``hvd-model`` explores (port of
``horovod_tpu/analysis/protocol/machines.py``, over the port's own specs).

Each builder returns a :class:`~.model.Model` whose actions execute
the SAME spec functions the runtime does (journal_spec / lease_spec /
migration_spec) — the spec-is-implementation contract means checking
these models checks shipped transition code, with the harness adding
only the environment: crash/restart, message loss, duplication, and
reorder as fault actions enabled at every step.

Seeded bugs (the mutation proof): each builder takes ``bug=``
re-introducing one historical failure shape — the checker must produce a
minimized counterexample for every mutant while the shipped (bug=None)
models explore their full bounded state space with zero counterexamples.

- ``ha``:        ``skip_fence`` — a resurrected stale primary writes
  without the term fence (split-brain).
- ``lease``:     ``actuate_before_ledger`` — actuation issued before
  the durable ledger write (the fence-skip ordering bug; a crash in
  the window strands an actuation the recovery protocol rolls back).
- ``migration``: ``double_import`` — staging keeps a completed
  transfer's entry (the missing dedup delete), so a duplicated chunk
  reassembles and imports the sequence twice; ``skip_admit`` — import
  placement skips the watermark admission predicate.
"""

import copy

from . import journal_spec, lease_spec, migration_spec
from .model import Action, Model, _anchor


def _insert_sorted(lst, value):
    """Idempotent membership insert keeping the list canonical."""
    if value not in lst:
        lst.append(value)
        lst.sort()


# ==========================================================================
# HA terms: journal, standby sync, promotion, the term fence
# ==========================================================================

def ha_model(bug=None, max_writes=2):
    """Primary p1 journals durable mutations; a warm standby syncs the
    journal and promotes at term+1 once p1 crashes; a resurrected p1
    must be fenced. ``bug="skip_fence"`` lets the stale primary write
    anyway."""
    apply_anchor = _anchor(journal_spec.apply_entry)

    def init():
        return {
            "journal": [],
            "store_term": 1,
            "primaries": {"p1": {"alive": True, "term": 1,
                                 "writes": 0}},
            "standby": {"seq": 0, "promoted": False,
                        "replica": journal_spec.new_state()},
            "crashes_left": 1,
            "restarts_left": 1,
        }

    def actions(state):
        acts = []
        for name in sorted(state["primaries"]):
            p = state["primaries"][name]
            if p["alive"] and p["writes"] < max_writes:
                fenced = journal_spec.term_fences(
                    p["term"], state["store_term"])
                if not fenced or bug == "skip_fence":
                    def write(s, name=name):
                        prim = s["primaries"][name]
                        entry = {"seq": len(s["journal"]) + 1,
                                 "term": prim["term"], "op": "kv_put",
                                 "scope": "fleet", "key": "k",
                                 "value": f"{name}.{prim['writes']}",
                                 "writer": name}
                        s["journal"].append(entry)
                        prim["writes"] += 1
                        s["store_term"] = max(s["store_term"],
                                              entry["term"])
                        return s
                    acts.append(Action(f"{name}:write", name, write,
                                       anchor=apply_anchor))
            if p["alive"] and state["crashes_left"] > 0:
                def crash(s, name=name):
                    s["primaries"][name]["alive"] = False
                    s["crashes_left"] -= 1
                    return s
                acts.append(Action(f"{name}:crash", name, crash,
                                   fault=True))
            if not p["alive"] and state["restarts_left"] > 0:
                def restart(s, name=name):
                    s["primaries"][name]["alive"] = True
                    s["restarts_left"] -= 1
                    return s
                acts.append(Action(f"{name}:restart", name, restart,
                                   fault=True))
        sb = state["standby"]
        if not sb["promoted"] and sb["seq"] < len(state["journal"]):
            def sync(s):
                rep = s["standby"]
                for entry in s["journal"][rep["seq"]:]:
                    journal_spec.apply_entry(rep["replica"], entry)
                rep["seq"] = len(s["journal"])
                return s
            acts.append(Action("standby:sync", "standby", sync,
                               anchor=apply_anchor))
        if (not sb["promoted"] and sb["seq"] == len(state["journal"])
                and not state["primaries"]["p1"]["alive"]):
            def promote(s):
                rep = s["standby"]
                rep["promoted"] = True
                term = s["store_term"] + 1
                entry = {"seq": len(s["journal"]) + 1, "term": term,
                         "op": "term", "writer": "p2"}
                s["journal"].append(entry)
                journal_spec.apply_entry(rep["replica"], entry)
                rep["seq"] = len(s["journal"])
                s["store_term"] = term
                s["primaries"]["p2"] = {"alive": True, "term": term,
                                        "writes": 0}
                return s
            acts.append(Action("standby:promote", "standby", promote,
                               anchor=apply_anchor))
        return acts

    def terms_monotone(s):
        terms = [e["term"] for e in s["journal"]]
        for a, b in zip(terms, terms[1:]):
            if b < a:
                return (f"journal term regressed {a} -> {b}: a stale "
                        "primary mutated cohort state after a newer "
                        "term was observed (split-brain)")
        writers = {}
        for e in s["journal"]:
            first = writers.setdefault(e["term"], e["writer"])
            if first != e["writer"]:
                return (f"two primaries ({first}, {e['writer']}) "
                        f"wrote under term {e['term']}")
        return None

    def replica_convergence(s):
        sb = s["standby"]
        shadow = journal_spec.new_state()
        for entry in s["journal"][:sb["seq"]]:
            journal_spec.apply_entry(shadow, entry)
        if (journal_spec.state_digest(shadow)
                != journal_spec.state_digest(sb["replica"])):
            return ("standby replica digest diverged from the journal "
                    "replay at its seq — apply_entry is not the single "
                    "transition it claims to be")
        return None

    def goal(s):
        return any(p["alive"] and p["term"] == s["store_term"]
                   for p in s["primaries"].values())

    return Model(
        "ha", init, actions,
        invariants=[("single_writer_per_term", terms_monotone),
                    ("replica_convergence", replica_convergence)],
        liveness=[("active_primary_at_latest_term", goal)])


# ==========================================================================
# Fleet leases: ledger-before-actuation, crash, resume
# ==========================================================================

def lease_model(direction=lease_spec.TRAIN_TO_SERVE, bug=None):
    """One arbiter drives one lease down its chain: durable ledger
    write first, idempotent actuation second, crash anywhere, recovery
    via lease_spec.resume_action. ``bug="actuate_before_ledger"``
    swaps the ordering (the fence-skip shape)."""
    resume_anchor = _anchor(lease_spec.resume_action)
    check_anchor = _anchor(lease_spec.check_transition)

    def init():
        return {
            "lease": None,
            "up": True,
            "inflight": None,    # actuation (or write) still pending
            "effects": [],       # actuations issued (idempotent set)
            "passed": [],        # states durably written
            "crashes_left": 1,
        }

    def actions(state):
        acts = []
        lease = state["lease"]
        if state["up"] and lease is None:
            def open_lease(s):
                s["lease"] = {"id": "L1", "direction": direction,
                              "state": "proposed"}
                _insert_sorted(s["passed"], "proposed")
                return s
            acts.append(Action("arbiter:open", "arbiter", open_lease,
                               anchor=check_anchor))
        if (state["up"] and lease is not None
                and lease["state"] not in lease_spec.TERMINAL_STATES
                and state["inflight"] is None):
            nxt = lease_spec.next_state(direction, lease["state"])
            if nxt is not None:
                if bug == "actuate_before_ledger":
                    def actuate_first(s, nxt=nxt):
                        if nxt not in lease_spec.TERMINAL_STATES:
                            _insert_sorted(s["effects"], nxt)
                        s["inflight"] = {"phase": "write",
                                         "state": nxt}
                        return s
                    acts.append(Action(
                        f"arbiter:actuate[{nxt}]", "arbiter",
                        actuate_first, anchor=check_anchor))
                else:
                    def write(s, nxt=nxt):
                        lease_spec.check_transition(s["lease"], nxt)
                        s["lease"]["state"] = nxt
                        _insert_sorted(s["passed"], nxt)
                        if nxt not in lease_spec.TERMINAL_STATES:
                            s["inflight"] = {"phase": "actuate",
                                             "state": nxt}
                        return s
                    acts.append(Action(
                        f"arbiter:ledger_write[{nxt}]", "arbiter",
                        write, anchor=check_anchor))
        pending = state["inflight"]
        if state["up"] and pending is not None:
            if pending["phase"] == "actuate":
                def actuate(s):
                    _insert_sorted(s["effects"],
                                   s["inflight"]["state"])
                    s["inflight"] = None
                    return s
                acts.append(Action(
                    f"arbiter:actuate[{pending['state']}]", "arbiter",
                    actuate, anchor=check_anchor))
            else:   # the seeded bug's deferred ledger write
                def write_late(s):
                    nxt = s["inflight"]["state"]
                    lease_spec.check_transition(s["lease"], nxt)
                    s["lease"]["state"] = nxt
                    _insert_sorted(s["passed"], nxt)
                    s["inflight"] = None
                    return s
                acts.append(Action(
                    f"arbiter:ledger_write[{pending['state']}]",
                    "arbiter", write_late, anchor=check_anchor))
        if state["up"] and state["crashes_left"] > 0:
            def crash(s):
                s["up"] = False
                s["inflight"] = None    # volatile
                s["crashes_left"] -= 1
                return s
            acts.append(Action("arbiter:crash", "arbiter", crash,
                               fault=True))
        if not state["up"]:
            def recover(s):
                s["up"] = True
                lease = s["lease"]
                if lease is None:
                    return s
                what = lease_spec.resume_action(lease)
                if what == "rollback":
                    lease_spec.check_transition(lease, "rolled_back")
                    lease["state"] = "rolled_back"
                    _insert_sorted(s["passed"], "rolled_back")
                elif what == "roll_forward":
                    # re-issue the current state's idempotent actuation
                    _insert_sorted(s["effects"], lease["state"])
                return s
            acts.append(Action("arbiter:recover", "arbiter", recover,
                               anchor=resume_anchor))
        return acts

    def effects_are_ledgered(s):
        stray = [e for e in s["effects"] if e not in s["passed"]]
        if stray:
            return (f"actuation(s) {stray} issued before their ledger "
                    "write — a crash in this window strands actuated "
                    "state the recovery protocol cannot see")
        return None

    def rollback_unactuated(s):
        lease = s["lease"]
        if (lease is not None and lease["state"] == "rolled_back"
                and s["effects"]):
            return (f"lease rolled back with actuations {s['effects']} "
                    "already issued — rolled forward AND back")
        return None

    def valid_chain(s):
        lease = s["lease"]
        if lease is None:
            return None
        allowed = lease_spec.CHAINS[direction] + ("rolled_back",)
        if lease["state"] not in allowed:
            return f"lease in undefined state {lease['state']!r}"
        return None

    def goal(s):
        lease = s["lease"]
        return (lease is not None
                and lease["state"] in lease_spec.TERMINAL_STATES)

    return Model(
        "lease", init, actions,
        invariants=[("effects_are_ledgered", effects_are_ledgered),
                    ("rollback_unactuated", rollback_unactuated),
                    ("valid_chain", valid_chain)],
        liveness=[("lease_reaches_terminal", goal)])


# ==========================================================================
# KV migration: chunked transfer, staging, watermark admission
# ==========================================================================

def migration_model(bug=None, free=6, watermark=None, n_pages=2):
    """One sequence migrates source -> target as chunked messages over
    a lossy/duplicating/reordering channel; the target reassembles
    through migration_spec.stage_chunk and places all-or-nothing
    behind migration_spec.admits. Ownership transfers only on a
    delivered commit ack; every failure leg falls back to recompute
    (the graceful-degradation contract)."""
    if watermark is None:
        # skip_admit is only load-bearing when the pool is tight
        # enough that the admission predicate actually refuses.
        watermark = 5 if bug == "skip_admit" else 2
    pages = [{"payload": f"p{i}", "digest": f"d{i}"}
             for i in range(n_pages)]
    chunks = migration_spec.chunk_pages(pages, max_bytes=10)
    total = len(chunks)
    meta = {"id": "seq1", "num_tokens": n_pages}
    stage_anchor = _anchor(migration_spec.stage_chunk)
    admit_anchor = _anchor(migration_spec.admits)
    chunk_anchor = _anchor(migration_spec.chunk_pages)

    def _msg(i):
        msg = {"mid": "m1", "chunk": i, "total": total,
               "pages": copy.deepcopy(chunks[i])}
        if i == total - 1:
            msg["meta"] = dict(meta)
            msg["commit"] = True
        return msg

    def init():
        return {
            "src": {"next": 0, "owner": True, "done": None},
            "net": [],           # in-flight chunk indices (multiset)
            "staging": {},
            "imported": {},      # mid -> import count
            "alloc": {},         # mid -> pages allocated
            "free": int(free),
            "tgt_owner": False,
            "dups_left": 1,
            "drops_left": 1,
            "acklost_left": 1,
            "restarts_left": 1,
        }

    def _deliver(s, i, lost_ack):
        s["net"].remove(i)
        payload = _msg(i)
        record = migration_spec.stage_chunk(
            s["staging"], payload, max_staged=2, ttl_s=900.0, now=0.0)
        if record is not None and bug == "double_import":
            # The seeded mutation: the completed transfer's staging
            # entry is NOT deleted, so a duplicated chunk reassembles
            # the record again.
            s["staging"]["m1"] = {
                "chunks": {j: copy.deepcopy(chunks[j])
                           for j in range(total)},
                "total": total, "meta": dict(meta), "t": 0.0}
        imported_ok = False
        if record is not None:
            need = len(record["pages"])
            if (bug == "skip_admit"
                    or migration_spec.admits(s["free"], need,
                                             watermark)):
                s["free"] -= need
                s["imported"]["m1"] = s["imported"].get("m1", 0) + 1
                s["alloc"]["m1"] = s["alloc"].get("m1", 0) + need
                imported_ok = True
        if (payload.get("commit") and not lost_ack
                and s["src"]["done"] is None):
            if imported_ok:
                s["src"]["done"] = "handoff"
                s["src"]["owner"] = False
                s["tgt_owner"] = True
            else:
                s["src"]["done"] = "recompute"   # loud fallback
        return s

    def actions(state):
        acts = []
        src = state["src"]
        if src["done"] is None and src["next"] < total:
            def send(s):
                s["net"].append(s["src"]["next"])
                s["net"].sort()
                s["src"]["next"] += 1
                return s
            acts.append(Action("source:send", "source", send,
                               anchor=chunk_anchor))
        for i in sorted(set(state["net"])):
            def deliver(s, i=i):
                return _deliver(s, i, lost_ack=False)
            acts.append(Action(f"target:deliver[{i}]", "target",
                               deliver, anchor=stage_anchor))
            if state["dups_left"] > 0:
                def dup(s, i=i):
                    s["net"].append(i)
                    s["net"].sort()
                    s["dups_left"] -= 1
                    return s
                acts.append(Action(f"net:dup[{i}]", "net", dup,
                                   fault=True))
            if state["drops_left"] > 0:
                def drop(s, i=i):
                    s["net"].remove(i)
                    s["drops_left"] -= 1
                    return s
                acts.append(Action(f"net:drop[{i}]", "net", drop,
                                   fault=True))
            if i == total - 1 and state["acklost_left"] > 0:
                def acklost(s, i=i):
                    s["acklost_left"] -= 1
                    return _deliver(s, i, lost_ack=True)
                acts.append(Action(f"target:deliver_acklost[{i}]",
                                   "target", acklost, fault=True,
                                   anchor=stage_anchor))
        if (src["done"] is None and src["next"] == total
                and not state["net"]):
            def fallback(s):
                s["src"]["done"] = "recompute"
                return s
            acts.append(Action("source:fallback", "source", fallback,
                               anchor=admit_anchor))
        if state["restarts_left"] > 0 and not state["tgt_owner"]:
            def restart(s):
                s["staging"] = {}
                s["free"] += sum(s["alloc"].values())
                s["alloc"] = {}
                s["imported"] = {}
                s["restarts_left"] -= 1
                return s
            acts.append(Action("target:restart", "target", restart,
                               fault=True))
        return acts

    def no_double_import(s):
        doubled = {m: c for m, c in s["imported"].items() if c > 1}
        if doubled:
            return (f"transfer(s) {sorted(doubled)} imported "
                    f"{max(doubled.values())}x — a duplicated chunk "
                    "reassembled an already-committed migration")
        return None

    def watermark_respected(s):
        if s["free"] < watermark:
            return (f"page pool at {s['free']} free < watermark "
                    f"{watermark} — an import crossed the admission "
                    "reserve")
        return None

    def single_owner(s):
        owners = int(s["src"]["owner"]) + int(s["tgt_owner"])
        if owners != 1:
            return (f"sequence has {owners} authoritative owner(s) — "
                    "it must live in exactly one place")
        return None

    def goal(s):
        return s["src"]["done"] is not None

    return Model(
        "migration", init, actions,
        invariants=[("no_double_import", no_double_import),
                    ("watermark_respected", watermark_respected),
                    ("single_owner", single_owner)],
        liveness=[("migration_completes_or_falls_back", goal)])


# ==========================================================================
# Registry
# ==========================================================================

#: protocol -> builder. ``lease`` covers both directions (build() runs
#: each as its own exploration).
PROTOCOLS = ("ha", "lease", "migration")

#: protocol -> the seeded-bug names its builder understands.
BUGS = {
    "ha": ("skip_fence",),
    "lease": ("actuate_before_ledger",),
    "migration": ("double_import", "skip_admit"),
}


def build(protocol, bug=None):
    """The models to explore for ``protocol`` — a list, because the
    lease chain is per-direction."""
    if bug is not None and bug not in BUGS.get(protocol, ()):
        raise ValueError(
            f"protocol {protocol!r} has no seeded bug {bug!r} "
            f"(known: {', '.join(BUGS.get(protocol, ())) or 'none'})")
    if protocol == "ha":
        return [ha_model(bug=bug)]
    if protocol == "lease":
        return [lease_model(direction=d, bug=bug)
                for d in lease_spec.DIRECTIONS]
    if protocol == "migration":
        return [migration_model(bug=bug)]
    raise ValueError(f"unknown protocol {protocol!r} "
                     f"(known: {', '.join(PROTOCOLS)})")


__all__ = ["ha_model", "lease_model", "migration_model", "PROTOCOLS",
           "BUGS", "build"]

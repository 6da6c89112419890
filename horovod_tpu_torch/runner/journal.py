"""Driver control-plane journal: the durable half of control-plane HA (port
of ``horovod_tpu/runner/journal.py``; the file format is the JAX
package's, byte for byte, so each package replays the other's directory).

Every robustness subsystem so far funnels through one launcher process
— kill that host and the job dies with the in-memory membership,
blacklist, and commit state (docs/fault_tolerance.md "Control-plane
HA"). This module makes the driver's mutations *durable* and
*replicable*:

- ``DriverJournal`` is an append-only fsync'd JSONL (one entry per
  control-plane mutation, each stamped with a monotonically-increasing
  ``seq`` and the writer's ``term``) plus a periodic full-state
  snapshot (atomic tmp+fsync+rename, the checkpoint.py discipline).
  ``HVDTPU_DRIVER_JOURNAL`` names the directory; unset = no journal
  object exists at all (the disabled-mode contract — zero I/O).
- ``replay`` reconstructs the driver state from snapshot + journal,
  tolerating a torn final line (a crash mid-append loses at most the
  entry being written, never the file).
- ``JournalReplica`` is the warm-standby's in-memory copy, fed by the
  primary's token-gated ``GET /journal?since=seq`` route
  (runner/standby.py) and promoted into a live driver on lease expiry.

Durable vs ephemeral KV partition: worker *commits* (``elastic.state``)
and exit markers (``elastic.exit``) are durable — they are journaled by
the HTTP handler and survive a failover. Peer addresses, heartbeats,
metrics, trace shards and serving-member keys are **ephemeral** by
contract: workers republish them against the new primary
(http_client's ``on_new_primary`` hooks), so replicating them would
only replicate staleness.

Terms fence split-brain: every mutation carries the writer's term; a
resurrected stale primary whose server has observed a higher term gets
``StaleTermError`` naming BOTH terms instead of silently corrupting
the cohort (docs/fault_tolerance.md "Split-brain fencing").
"""

import json
import os
import threading

# The journal's state machine lives in the protocol spec
# (analysis/protocol/journal_spec.py); this module executes the exact same
# functions and owns everything impure: files, fsync, locks, telemetry.
from ..analysis.protocol.journal_spec import (
    DURABLE_SCOPES,
    JournalError,
    apply_entry,
    durable_key,
    new_state,
    state_digest,
    term_fences,
)
from ..telemetry import core as telemetry
from ..utils.logging_util import get_logger

JOURNAL_FILE = "journal.jsonl"
SNAPSHOT_FILE = "snapshot.json"

DEFAULT_SNAPSHOT_EVERY = 256


class StaleTermError(RuntimeError):
    """A control-plane mutation carried a term older than the one the
    store has observed — the writer is a fenced stale primary. Carries
    both terms so the split-brain is diagnosable from the one line."""

    def __init__(self, mutation, writer_term, observed_term):
        super().__init__(
            f"term fenced: {mutation} carries term {writer_term} but a "
            f"newer primary at term {observed_term} has taken over — "
            "this driver is stale and must not mutate cohort state")
        self.writer_term = writer_term
        self.observed_term = observed_term


def _m_bytes():
    return telemetry.gauge(
        "hvd_journal_bytes",
        "Bytes in the driver journal dir (journal + snapshot)")


def _read_lines(path):
    """(entries, good_bytes, torn) — parse a journal file, stopping at
    the first unparseable line. A torn FINAL line is the crash-
    mid-append signature and is recoverable; a torn line with entries
    after it means corruption and raises."""
    entries = []
    good = 0
    torn = False
    with open(path, "rb") as f:
        raw = f.read()
    for line in raw.splitlines(keepends=True):
        stripped = line.strip()
        if not stripped:
            good += len(line)
            continue
        try:
            entry = json.loads(stripped.decode())
        except (ValueError, UnicodeDecodeError):
            if raw[good + len(line):].strip():
                raise JournalError(
                    f"journal {path} is corrupt mid-file at byte {good} "
                    "(unparseable line with entries after it)")
            torn = True
            break
        if not line.endswith(b"\n"):
            # Parsed but unterminated: the trailing newline never hit
            # the disk; treat like a torn line so a replayer and the
            # recovered writer agree on what counts as durable.
            torn = True
            break
        entries.append(entry)
        good += len(line)
    return entries, good, torn


def read_dir(dirpath):
    """(state, seq, snapshot_seq) replayed from ``dirpath`` without
    modifying anything — usable on a dead primary's journal."""
    state = new_state()
    seq = 0
    snap_path = os.path.join(dirpath, SNAPSHOT_FILE)
    if os.path.exists(snap_path):
        with open(snap_path) as f:
            snap = json.load(f)
        state = snap["state"]
        seq = snap["seq"]
    snap_seq = seq
    jpath = os.path.join(dirpath, JOURNAL_FILE)
    if os.path.exists(jpath):
        entries, _, torn = _read_lines(jpath)
        if torn:
            get_logger().warning(
                "journal %s: torn final line (crash mid-append); "
                "replaying the intact prefix", jpath)
        for entry in entries:
            if entry["seq"] <= seq:
                continue
            apply_entry(state, entry)
            seq = entry["seq"]
    return state, seq, snap_seq


def replay(dirpath):
    """(state, seq) — public replay entry; raises JournalError on a
    journal corrupted anywhere but its final line."""
    state, seq, _ = read_dir(dirpath)
    return state, seq


class DriverJournal:
    """The primary's write-side: every control-plane mutation lands
    here (fsync'd) BEFORE it takes effect, so a standby replaying the
    journal can never be ahead of reality."""

    def __init__(self, dirpath, snapshot_every=None, term=1):
        self.dirpath = dirpath
        self.snapshot_every = (DEFAULT_SNAPSHOT_EVERY
                               if snapshot_every is None
                               else max(1, int(snapshot_every)))
        self._lock = threading.Lock()
        self._log = get_logger()
        os.makedirs(dirpath, exist_ok=True)
        # Crash recovery: adopt whatever a previous incarnation left
        # (repairing a torn final line in place), then resume its seq.
        self.state, self.seq, self._snap_seq = read_dir(dirpath)
        self._repair_torn_tail()
        self.term = max(int(term), self.state.get("term", 0))
        self.state["term"] = self.term
        self._entries = self._reload_entries()
        self._file = open(self._jpath, "ab")
        self._update_bytes()

    @property
    def _jpath(self):
        return os.path.join(self.dirpath, JOURNAL_FILE)

    @property
    def _spath(self):
        return os.path.join(self.dirpath, SNAPSHOT_FILE)

    def _repair_torn_tail(self):
        if not os.path.exists(self._jpath):
            return
        _, good, torn = _read_lines(self._jpath)
        if torn:
            self._log.warning(
                "journal %s: truncating torn final line at byte %d",
                self._jpath, good)
            with open(self._jpath, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())

    def _reload_entries(self):
        if not os.path.exists(self._jpath):
            return []
        entries, _, _ = _read_lines(self._jpath)
        return [e for e in entries if e["seq"] > self._snap_seq]

    # -- write side --------------------------------------------------------
    def record(self, op, **fields):
        """Journal one mutation and apply it to the tracked state.
        Returns the entry. fsync before return: an acknowledged entry
        is durable."""
        with self._lock:
            self.seq += 1
            entry = {"seq": self.seq, "term": self.term, "op": op}
            entry.update(fields)
            apply_entry(self.state, entry)
            line = json.dumps(entry, sort_keys=True,
                              separators=(",", ":")) + "\n"
            self._file.write(line.encode())
            self._file.flush()
            os.fsync(self._file.fileno())
            if len(self._entries) >= self.snapshot_every:
                self._snapshot_locked()
                # The entry that triggered rotation is inside the
                # snapshot; the in-memory window restarts empty.
            else:
                self._entries.append(entry)
            self._update_bytes()
            return entry

    def set_term(self, term):
        with self._lock:
            self.term = int(term)
            self.state["term"] = self.term

    def _snapshot_locked(self):
        tmp = self._spath + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"seq": self.seq, "term": self.term,
                       "state": self.state}, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._spath)
        dir_fd = os.open(self.dirpath, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._file.close()
        self._file = open(self._jpath, "wb")  # rotate: entries subsumed
        os.fsync(self._file.fileno())
        self._snap_seq = self.seq
        self._entries = []

    def snapshot(self):
        """Force a snapshot + journal rotation (also called on the
        snapshot_every cadence from record())."""
        with self._lock:
            self._snapshot_locked()
            self._update_bytes()

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def _update_bytes(self):
        total = 0
        for name in (self._jpath, self._spath):
            try:
                total += os.path.getsize(name)
            except OSError:
                pass
        _m_bytes().set(total)

    # -- read side (the /journal route) ------------------------------------
    def sync_payload(self, since_seq):
        """What a standby at ``since_seq`` needs to catch up: the
        snapshot too when the journal was rotated past it, else just
        the missing entries."""
        with self._lock:
            payload = {"term": self.term, "seq": self.seq,
                       "snapshot": None, "entries": []}
            if since_seq < self._snap_seq:
                # The journal was rotated past the replica's position:
                # ship the on-disk snapshot so the entry seqs line up
                # (fallback: the full live state at the current seq).
                try:
                    with open(self._spath) as f:
                        snap = json.load(f)
                    payload["snapshot"] = {"seq": snap["seq"],
                                           "state": snap["state"]}
                    payload["entries"] = list(self._entries)
                except (OSError, ValueError):
                    # DEEP COPY under the lock: the payload is JSON-
                    # serialized by the HTTP layer after we release it,
                    # and a concurrent record() mutates self.state.
                    payload["snapshot"] = {
                        "seq": self.seq,
                        "state": json.loads(json.dumps(self.state))}
            else:
                payload["entries"] = [e for e in self._entries
                                      if e["seq"] > since_seq]
            return payload

    def digest(self):
        with self._lock:
            return state_digest(self.state)


class JournalReplica:
    """The standby's in-memory copy, advanced by sync payloads."""

    def __init__(self):
        self.state = new_state()
        self.seq = 0
        self.term = 0
        self._lock = threading.Lock()

    def apply_payload(self, payload):
        """Apply one /journal response; returns entries applied."""
        applied = 0
        with self._lock:
            snap = payload.get("snapshot")
            if snap and snap.get("state") is not None \
                    and snap["seq"] >= self.seq:
                self.state = snap["state"]
                self.seq = snap["seq"]
                applied += 1
            for entry in payload.get("entries", ()):
                if entry["seq"] <= self.seq:
                    continue
                apply_entry(self.state, entry)
                self.seq = entry["seq"]
                applied += 1
            self.term = max(self.term, int(payload.get("term", 0)),
                            self.state.get("term", 0))
        return applied

    def digest(self):
        with self._lock:
            return state_digest(self.state)

    def snapshot_state(self):
        """Deep copy of the replica state for promotion."""
        with self._lock:
            return json.loads(json.dumps(self.state))


__all__ = ["DriverJournal", "JournalReplica", "JournalError",
           "StaleTermError", "DURABLE_SCOPES", "durable_key",
           "term_fences", "new_state", "apply_entry", "state_digest",
           "replay", "read_dir"]

"""Data-plane guardian: cross-rank consistency checks and the stuck-
collective watchdog (port of ``horovod_tpu/guardian.py``).

The reference refuses to compute garbage or hang silently on rank
divergence: its controller's message table rejects cross-rank shape and op
mismatches at negotiation (reference: horovod/common/controller.cc) and its
stall inspector names the ranks that never submitted a stuck tensor
(horovod/common/stall_inspector.cc). Two parts:

- **ConsistencyGuard** (``HVDTPU_CONSISTENCY_CHECK``): at submit each rank
  publishes a compact metadata digest of every named collective (kind, op,
  dtype, shapes, process set, scales, codec, shard) to a shared *board*;
  before dispatch the digests are compared, and a divergence fails the
  handle with ``CollectiveMismatchError`` naming the ranks and fields. ``1``
  checks every named collective, ``N > 1`` every Nth submission (the same
  slot on every rank of a correct program). A peer that publishes no
  digest within ``HVDTPU_CONSISTENCY_TIMEOUT`` fails the handle with
  ``CollectiveAbortError``: the check never lets an unchecked collective
  through (the JAX package logs a warning and dispatches).
- **Watchdog** (``HVDTPU_COLLECTIVE_TIMEOUT``): the coordinator's stall
  scan feeds it the in-flight set; it publishes this rank's view, reads
  the peers', and names the ranks that never submitted each stalled op.
  Past the timeout the coordinator aborts every in-flight operation with
  ``CollectiveAbortError`` and posts an abort notice on the board, so that
  peers abort too. Under elastic training the abort is a
  ``HorovodInternalError``: a restore and a reset, not a hang.

The board is the launcher's KV store, one scope per elastic version, in
multi-process jobs, and a process-global table otherwise. With both knobs
unset the coordinator holds ``None`` for each and the submit path pays one
attribute check.
"""

import json
import threading
import time

from .exceptions import CollectiveAbortError, CollectiveMismatchError
from .ops import reduce_ops
from .ops.zero import dtype_name
from .telemetry import core as telemetry
from .utils import envparse
from .utils.logging_util import get_logger

DEFAULT_CONSISTENCY_TIMEOUT_S = 10.0
# Board key prefixes: one digest key per (name, rank), overwritten at each
# occurrence, so storage stays bounded by the program's name set.
_DIGEST_PREFIX = "dg"
_INFLIGHT_PREFIX = "if"
_ABORT_KEY = "abort"


def _m_mismatches():
    return telemetry.counter(
        "hvd_collective_mismatch_total",
        "Cross-rank collective metadata mismatches detected")


# ---------------------------------------------------------------------------
# Boards: where digests, in-flight sets and abort notices live
# ---------------------------------------------------------------------------

_INPROC_TABLE = {}
_INPROC_LOCK = threading.Lock()


def _reset_inproc():
    """Test hook: drop the process-global table."""
    with _INPROC_LOCK:
        _INPROC_TABLE.clear()


class InProcBoard:
    """Process-global table for ranks that live in this process (tests)."""

    def __init__(self, scope):
        self._scope = scope

    def put(self, key, value):
        with _INPROC_LOCK:
            _INPROC_TABLE[(self._scope, key)] = value

    def get(self, key):
        with _INPROC_LOCK:
            return _INPROC_TABLE.get((self._scope, key))


class KVBoard:
    """The launcher's KV store. Each verb has a short retry budget: a verb
    that fails logs a warning and reads as "not published", so a flaky
    store shows as a missing digest (which the guard raises on) or a
    missing peer view, never as a dispatch blocked for the whole KV
    deadline."""

    RETRIES = 2
    DEADLINE_S = 3.0

    def __init__(self, addr, port, token, scope):
        self._addr = addr
        self._port = port
        self._token = token
        self._scope = scope
        self._log = get_logger()

    def put(self, key, value):
        from .runner import http_client
        try:
            http_client.put_kv(self._addr, self._port, self._scope, key,
                               value, token=self._token,
                               retries=self.RETRIES,
                               deadline=self.DEADLINE_S)
        except Exception as exc:  # noqa: BLE001 - shows as unpublished
            self._log.warning("guardian: board put %s failed: %s", key,
                              exc)

    def get(self, key):
        from .runner import http_client
        try:
            raw = http_client.get_kv(self._addr, self._port, self._scope,
                                     key, token=self._token,
                                     retries=self.RETRIES,
                                     deadline=self.DEADLINE_S)
        except Exception as exc:  # noqa: BLE001 - shows as unpublished
            self._log.warning("guardian: board get %s failed: %s", key,
                              exc)
            return None
        return raw.decode() if isinstance(raw, bytes) else raw


def _board_scope():
    """One scope per elastic membership version: a new cohort never reads
    the previous one's digests or abort notice."""
    ver = envparse.get_str(envparse.ELASTIC_VERSION, "0")
    return f"guardian.{ver}"


def make_board():
    """The KV board when the launcher's rendezvous is configured, the
    in-process table otherwise."""
    from .runner import rendezvous as rdv
    cfg = rdv.rendezvous_config()
    scope = _board_scope()
    if cfg is None:
        return InProcBoard(scope)
    addr, port, token = cfg
    return KVBoard(addr, port, token, scope)


def make_cross_process_board():
    """The KV board, or None without a launcher rendezvous (a digest in the
    in-process table would never reach a peer process)."""
    from .runner import rendezvous as rdv
    cfg = rdv.rendezvous_config()
    if cfg is None:
        return None
    addr, port, token = cfg
    return KVBoard(addr, port, token, _board_scope())


# ---------------------------------------------------------------------------
# Digests
# ---------------------------------------------------------------------------

# Fields compared across ranks, in reporting order (the JAX package's).
# "codec" is the compression stamp: ranks that disagree would run different
# wire pipelines for one named collective. "shard_index"/"shard_shape"
# cover the scatter and gather kinds. "index_dtype"/"dense_shape" cover
# sparse entries, whose per-rank nnz differs by construction (shapes None).
_DIGEST_FIELDS = ("kind", "op", "dtype", "shapes", "process_set",
                  "prescale", "postscale", "root_rank", "codec",
                  "shard_index", "shard_shape", "index_dtype",
                  "dense_shape")


def _codec_digest(entry):
    codec = getattr(entry, "codec", None)
    if codec is None:
        sparse = getattr(entry, "sparse", None)
        if sparse is not None and sparse.codec:
            return f"{sparse.codec}@rows"
        return None
    if isinstance(codec, tuple):
        name, block = codec
        return f"{name}@b{block}" if block else name
    return str(codec)


def _shard_fields(entry, shapes):
    """(shard_index, shard_shape) of the scatter and gather kinds, (None,
    None) otherwise. The port's reducescatter splits each tensor's dim 0
    across the set (the JAX package's input is stacked, ``(n, s0, ...)``,
    and splits ``s0``); an allgather's shard is each rank's tensor. The
    shard shape is published for even splits only: a ragged allgather
    (``uneven``) or an uneven reducescatter legitimately differs per rank.
    Sub-cohort sets publish neither (their set-relative rank would not
    match the global rank the peers are keyed by)."""
    if entry.kind not in ("reducescatter", "allgather"):
        return None, None
    if entry.process_set.process_set_id not in (None, 0):
        return None, None
    try:
        rank = entry.process_set.rank()
    except Exception:  # noqa: BLE001 - pre-init or a stub process set
        return None, None
    if getattr(entry, "uneven", False) or not shapes:
        return rank, None
    if entry.kind == "reducescatter":
        n = len(entry.process_set.ranks)
        if any(not s or s[0] % n for s in shapes):
            return rank, None
        return rank, [[s[0] // n] + s[1:] for s in shapes]
    return rank, [list(s) for s in shapes]


def entry_digest(entry):
    """Compact metadata digest of a TensorEntry: everything that must
    agree across ranks for the collective to be well formed. A ragged
    (``uneven``) allgather publishes its shapes with dim 0 as None."""
    dtype = None
    shapes = []
    index_dtype = dense_shape = None
    sparse = getattr(entry, "sparse", None)
    if sparse is not None:
        dtype = sparse.values_dtype
        shapes = None
        index_dtype = sparse.index_dtype
        dense_shape = [int(s) for s in sparse.dense_shape]
    else:
        uneven = getattr(entry, "uneven", False)
        for t in entry.tensors:
            if dtype is None:
                dtype = dtype_name(t.dtype)
            shape = [int(s) for s in t.shape]
            if uneven and shape:
                shape[0] = None
            shapes.append(shape)
    shard_index, shard_shape = _shard_fields(entry, shapes or [])
    return {
        "kind": entry.kind,
        "op": reduce_ops.op_name(entry.op) if entry.op is not None
        else None,
        "dtype": dtype,
        "shapes": shapes,
        "process_set": entry.process_set.process_set_id,
        "prescale": None if entry.prescale is None
        else float(entry.prescale),
        "postscale": None if entry.postscale is None
        else float(entry.postscale),
        "root_rank": entry.root_rank,
        "codec": _codec_digest(entry),
        "shard_index": shard_index,
        "shard_shape": shard_shape,
        "index_dtype": index_dtype,
        "dense_shape": dense_shape,
    }


def render_digest(digest):
    return json.dumps(digest, sort_keys=True, separators=(",", ":"))


def compare_digests(mine, theirs_by_rank):
    """Diff the local digest against each rank's published one. Returns
    ``[(rank, field, theirs, mine), ...]``, empty when consistent.
    ``shard_index`` must equal the publishing rank itself."""
    divergences = []
    for rank in sorted(theirs_by_rank):
        theirs = theirs_by_rank[rank]
        for field in _DIGEST_FIELDS:
            if field == "shard_index":
                peer_index = theirs.get(field)
                if peer_index is not None and peer_index != rank:
                    divergences.append((rank, field, peer_index, rank))
                continue
            if theirs.get(field) != mine.get(field):
                divergences.append((rank, field, theirs.get(field),
                                    mine.get(field)))
    return divergences


def mismatch_error(what, divergences, rank, advice):
    """The ``CollectiveMismatchError`` of ``divergences``."""
    _m_mismatches().inc()
    lines = [f"  rank {r}: {field} = {theirs!r} (rank {rank} submitted "
             f"{ours!r})" for r, field, theirs, ours in divergences]
    ranks = sorted({d[0] for d in divergences})
    fields = sorted({d[1] for d in divergences})
    return CollectiveMismatchError(
        f"{what} was submitted with divergent metadata by rank(s) {ranks} "
        f"(fields: {', '.join(fields)}):\n" + "\n".join(lines) + "\n"
        + advice, divergences=divergences)


def wait_digests(board, key_of, ranks, timeout_s, poll_s=0.01, occ=None):
    """Read each rank's published digest (``key_of(rank)``) until all are
    there or ``timeout_s`` passed. With ``occ`` the value is
    ``"<occurrence>|<digest>"`` and only that occurrence counts: an older
    one is waited past, a newer one means the peer overwrote it (the rank
    goes to ``ahead``). Returns ``(theirs_by_rank, waiting, ahead)``."""
    deadline = time.monotonic() + timeout_s
    waiting = set(ranks)
    theirs, ahead = {}, set()
    while waiting:
        for rank in sorted(waiting):
            raw = board.get(key_of(rank))
            if raw is None:
                continue
            blob = raw
            if occ is not None:
                peer_occ, _, blob = raw.partition("|")
                try:
                    peer_occ = int(peer_occ)
                except ValueError:
                    theirs[rank] = {"malformed": blob}
                    waiting.discard(rank)
                    continue
                if peer_occ < occ:
                    continue
                if peer_occ > occ:
                    ahead.add(rank)
                    waiting.discard(rank)
                    continue
            try:
                theirs[rank] = json.loads(blob)
            except ValueError:
                theirs[rank] = {"malformed": blob}
            waiting.discard(rank)
        if not waiting or time.monotonic() > deadline:
            break
        time.sleep(poll_s)
    return theirs, waiting, ahead


class ConsistencyGuard:
    """Publishes digests at submit, verifies them before dispatch.

    ``every``: 1 checks each named collective; N > 1 every Nth named
    submission (the sequence advances alike on every rank of a correct
    program, so the sampled slots line up)."""

    def __init__(self, rank, size, board, every=1, timeout_s=None,
                 poll_s=0.01):
        self.rank = rank
        self.size = size
        self.board = board
        self.every = max(1, int(every))
        self.timeout_s = (envparse.get_float(
            envparse.CONSISTENCY_TIMEOUT, DEFAULT_CONSISTENCY_TIMEOUT_S)
            if timeout_s is None else timeout_s)
        self._poll_s = poll_s
        self._seq = 0
        self._occ = {}
        self._lock = threading.Lock()
        self._log = get_logger()

    # -- submit side (framework threads) ---------------------------------
    def on_submit(self, entry):
        """Publish this entry's digest; arm ``entry.guard_token`` when this
        submission slot is one the pre-dispatch verify samples."""
        if not entry.name:
            return
        with self._lock:
            self._seq += 1
            seq = self._seq
            occ = self._occ.get(entry.name, 0) + 1
            self._occ[entry.name] = occ
        digest = entry_digest(entry)
        self.board.put(f"{_DIGEST_PREFIX}.{entry.name}.{self.rank}",
                       f"{occ}|{render_digest(digest)}")
        if seq % self.every == 0:
            entry.guard_token = (entry.name, occ, digest)

    # -- dispatch side (the cycle thread) --------------------------------
    def verify(self, entry):
        """Compare every rank's published digest for this entry with the
        local one. Raises ``CollectiveMismatchError`` on a divergence and
        ``CollectiveAbortError`` when a peer published none within the
        timeout. A peer already past this occurrence (it overwrote the key
        with a later one, legitimately) is skipped with a warning."""
        name, occ, mine = entry.guard_token
        theirs, waiting, ahead = wait_digests(
            self.board, lambda r: f"{_DIGEST_PREFIX}.{name}.{r}",
            range(self.size), self.timeout_s, self._poll_s, occ=occ)
        divergences = compare_digests(mine, theirs)
        if divergences:
            raise mismatch_error(
                f"collective {name!r} (occurrence {occ})", divergences,
                self.rank,
                "Every rank must submit the same op/dtype/shapes for a "
                "named collective (reference: message-table mismatch, "
                "horovod/common/controller.cc).")
        if waiting:
            raise CollectiveAbortError(
                f"consistency check of {name!r} (occurrence {occ}): "
                f"rank(s) {sorted(waiting)} published no digest within "
                f"{self.timeout_s:.1f}s (HVDTPU_CONSISTENCY_TIMEOUT); the "
                "collective was not dispatched")
        if ahead:
            self._log.warning(
                "guardian: consistency check for %r (occurrence %d) "
                "skipped rank(s) %s, which already overwrote this "
                "occurrence", name, occ, sorted(ahead))


# ---------------------------------------------------------------------------
# Stuck-collective watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Cluster view and abort policy for stalled collectives. The
    coordinator's stall scan calls ``observe`` with its in-flight set;
    this publishes the local view, reads the peers', and answers which
    ranks never submitted each stalled op and whether to abort (the
    timeout passed here, or a peer already aborted)."""

    def __init__(self, rank, size, timeout_s, board=None):
        self.rank = rank
        self.size = size
        self.timeout_s = timeout_s
        self.board = board
        self.last_missing = {}
        self._log = get_logger()

    def observe(self, inflight_names, stalled, now):
        """``stalled``: ``[(name, age_s)]``. Returns ``(missing,
        peer_abort)``: the ranks whose published in-flight view lacks each
        stalled name, and a peer's abort diagnostic when one fired. The
        local view is published on every call, so that peers never judge
        a stale snapshot; the peers are read only when something stalled
        here."""
        if self.board is None:
            return {}, None
        self.board.put(f"{_INFLIGHT_PREFIX}.{self.rank}",
                       ";".join(sorted(inflight_names)))
        if not stalled:
            return {}, None
        peer_view = {}
        unreported = []
        for rank in range(self.size):
            if rank == self.rank:
                peer_view[rank] = set(inflight_names)
                continue
            raw = self.board.get(f"{_INFLIGHT_PREFIX}.{rank}")
            if raw is None:
                unreported.append(rank)
                peer_view[rank] = None
            else:
                peer_view[rank] = {n for n in raw.split(";") if n}
        missing = {}
        for name, _age in stalled:
            absent = [r for r, names in peer_view.items()
                      if names is not None and name not in names]
            if absent or unreported:
                missing[name] = sorted(absent) + [f"{r}?" for r in
                                                  unreported]
        self.last_missing = missing
        if missing:
            # Flight-recorder breadcrumb: the postmortem bundle shows what
            # this rank believed about its peers before the abort.
            from . import tracing
            for name, ranks in sorted(missing.items()):
                tracing.trace_event("guardian", "stall_observe", coll=name,
                                    missing=[str(r) for r in ranks])
        return missing, self.board.get(_ABORT_KEY)

    def should_abort(self, oldest_age):
        return self.timeout_s > 0 and oldest_age > self.timeout_s

    def post_abort(self, diagnostic):
        from . import tracing
        tracing.trace_event("guardian", "post_abort",
                            detail=str(diagnostic)[:200])
        if self.board is not None:
            self.board.put(_ABORT_KEY, diagnostic)

    def describe_missing(self, name):
        """Human-readable missing-rank note for ``name`` from the last
        observation."""
        ranks = self.last_missing.get(name)
        if not ranks:
            return ""
        note = " — never submitted by rank(s) " + ", ".join(
            str(r) for r in ranks)
        if any(str(r).endswith("?") for r in ranks):
            note += " ('?' = no report yet)"
        return note


# ---------------------------------------------------------------------------
# Factories (called by the coordinator; None = off)
# ---------------------------------------------------------------------------

def make_guard(runtime):
    """A ConsistencyGuard when ``HVDTPU_CONSISTENCY_CHECK`` is set and the
    job has more than one process; otherwise None."""
    every = envparse.get_int(envparse.CONSISTENCY_CHECK, 0)
    if every <= 0:
        return None
    if (getattr(runtime, "mode", None) != "spmd"
            or runtime.topology.size < 2):
        # One process submits for every rank: nothing to disagree about.
        return None
    board = make_cross_process_board()
    if board is None:
        get_logger().warning(
            "HVDTPU_CONSISTENCY_CHECK is set but no launcher rendezvous "
            "is configured (HVDTPU_RENDEZVOUS_ADDR/PORT): the digests "
            "have nowhere to meet; the consistency check stays off")
        return None
    return ConsistencyGuard(runtime.topology.rank, runtime.topology.size,
                            board, every=every)


def make_watchdog(runtime):
    """A Watchdog when ``HVDTPU_COLLECTIVE_TIMEOUT`` > 0; its board only in
    a multi-process job."""
    timeout_s = envparse.get_float(envparse.COLLECTIVE_TIMEOUT, 0.0)
    if timeout_s <= 0:
        return None
    board = None
    if (getattr(runtime, "mode", None) == "spmd"
            and runtime.topology.size > 1):
        # None without a rendezvous: the watchdog still aborts locally; it
        # cannot gather the peers' views.
        board = make_cross_process_board()
    return Watchdog(runtime.topology.rank, runtime.topology.size,
                    timeout_s, board=board)

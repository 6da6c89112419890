"""``plan_redistribution(src, dst, tree_meta) -> Program`` (port of
``horovod_tpu/resharding/planner.py``).

The planner turns two :class:`~horovod_tpu_torch.resharding.spec.Spec`\\ s
into a deterministic sequence of bounded-size collective steps. The
synthesis is pure interval arithmetic: for every destination interval
(dst ownership) pick a source holder (src ownership), emit the element
copies, then chunk the copy list into steps none of whose per-rank
payload exceeds ``HVDTPU_RESHARD_BUCKET_BYTES`` — the memory bound of
arXiv:2112.01075: a full replica of a leaf is never staged, peak
scratch stays within shard + 2×bucket.

Two candidate chunkings are priced with the α–β cost model
(``analysis.costmodel.collective_time``) and the cheaper one wins:

- ``exchange`` — minimal bytes: each destination rank receives exactly
  the elements it lacks (all-to-all-shaped legs; legs whose payload is
  identical across receivers classify as all-gather; copies whose
  source IS the destination rank on the same mesh become zero-comm
  ``slice`` legs).
- ``gather`` — windowed all-gather of the source space: fewer, more
  uniform legs but every rank receives every window (wins only when
  the α·steps saving beats the β·bytes overshoot).

When the source spec carries ``pending_sum`` the values are unreduced
partial contributions and every leg becomes a reduce-scatter (the
executor sums per-holder windows into the destination).

Every Program carries a :meth:`~Program.signature` (cross-rank
identity, like ``ZeroPlan``) and guardian leg digests checked by
:meth:`~Program.verify_consistency` through the guardian's board, and
:meth:`~Program.prove` runs it through hvd-sim's lockstep matcher
(``analysis.simulate``): deadlock-freedom (HVD501) and digest agreement
(HVD502) at a symbolic world size, before any rank executes it.
"""

import hashlib
import json

from .spec import Spec, torch_dtype  # noqa: F401  (re-exported surface)
from ..utils import envparse

#: ``HVDTPU_RESHARD_BUCKET_BYTES`` default: 4 MiB windows — small
#: enough that scratch is negligible next to a shard, large enough
#: that the α term doesn't dominate a transition.
DEFAULT_RESHARD_BUCKET_BYTES = 4 * 1024 * 1024


class PlanError(ValueError):
    """A destination element no source rank holds (incompatible
    specs), or specs that disagree with the tree."""


class Copy:
    """``length`` elements from ``src_rank``'s buffer ``src_buf`` at
    ``src_off`` into ``dst_rank``'s ``dst_buf`` at ``dst_off``
    (``leaf`` = tree leaf index, for dtype and per-leaf grouping)."""

    __slots__ = ("leaf", "src_rank", "src_buf", "src_off",
                 "dst_rank", "dst_buf", "dst_off", "length")

    def __init__(self, leaf, src_rank, src_buf, src_off, dst_rank,
                 dst_buf, dst_off, length):
        self.leaf = leaf
        self.src_rank = src_rank
        self.src_buf = src_buf
        self.src_off = src_off
        self.dst_rank = dst_rank
        self.dst_buf = dst_buf
        self.dst_off = dst_off
        self.length = length

    def __repr__(self):
        return (f"Copy(leaf={self.leaf} r{self.src_rank}"
                f"{self.src_buf}[{self.src_off}:"
                f"{self.src_off + self.length}] -> r{self.dst_rank}"
                f"{self.dst_buf}[{self.dst_off}])")


class Step:
    """One collective leg: ``kind`` in slice / allgather / alltoall /
    reducescatter, ``nbytes`` = the largest per-rank payload (what the
    α–β model prices), ``total_bytes`` = sum over copies."""

    __slots__ = ("index", "kind", "op", "name", "nbytes",
                 "total_bytes", "copies")

    def __init__(self, index, kind, op, nbytes, total_bytes, copies):
        self.index = index
        self.kind = kind
        self.op = op
        self.name = None  # assigned once the program signature exists
        self.nbytes = int(nbytes)
        self.total_bytes = int(total_bytes)
        self.copies = copies

    def __repr__(self):
        return (f"Step({self.index}: {self.kind} "
                f"{len(self.copies)} copies, {self.nbytes}B/rank)")


class _ProgramEvent:
    """A Step viewed through hvd-sim's SimEvent duck type: ``slice``
    legs are local (``pset != 'global'`` completes immediately in the
    lockstep matcher); comm legs negotiate on the step name."""

    __slots__ = ("kind", "name", "pattern", "pset", "op", "file",
                 "line")

    def __init__(self, step):
        self.kind = step.kind
        self.name = step.name
        self.pattern = None
        self.pset = "local" if step.kind == "slice" else "global"
        self.op = step.op
        self.file = "<reshard-program>"
        self.line = step.index

    def slot(self):
        if self.name is not None:
            return ("n", self.name)
        return ("u", self.kind)

    def describe(self):
        out = f"`{self.kind}`"
        if self.name is not None:
            out += f"(name={self.name!r})"
        if self.op is not None:
            out += f" op={self.op}"
        return out


class Program:
    """A deterministic redistribution program. Identical on every rank
    that agrees on (src spec, dst spec, tree meta, bucket budget) —
    the cross-rank contract ``signature()`` pins and
    ``verify_consistency`` enforces through the guardian board."""

    __slots__ = ("src", "dst", "tree_meta", "bucket_bytes", "strategy",
                 "predicted_s", "steps", "sig8", "candidates")

    def __init__(self, src, dst, tree_meta, bucket_bytes, strategy,
                 predicted_s, steps, candidates):
        self.src = src
        self.dst = dst
        self.tree_meta = tree_meta
        self.bucket_bytes = int(bucket_bytes)
        self.strategy = strategy
        self.predicted_s = float(predicted_s)
        self.steps = steps
        self.candidates = candidates  # {strategy: predicted_s}
        self.sig8 = hashlib.sha1(
            json.dumps(self.signature(), sort_keys=True,
                       separators=(",", ":")).encode()
        ).hexdigest()[:8]
        for s in steps:
            s.name = f"reshard.{self.sig8}.{s.index:03d}"

    # -- identity ----------------------------------------------------------
    def signature(self):
        return {
            "version": 1,
            "src": self.src.signature(),
            "dst": self.dst.signature(),
            "meta": [[list(shape), dtype]
                     for shape, dtype in self.tree_meta],
            "bucket_bytes": self.bucket_bytes,
            "strategy": self.strategy,
            "steps": [{"kind": s.kind, "op": s.op,
                       "nbytes": s.nbytes,
                       "total_bytes": s.total_bytes,
                       "ncopies": len(s.copies)}
                      for s in self.steps],
        }

    def bytes_moved(self):
        """Wire bytes (non-slice legs only)."""
        return sum(s.total_bytes for s in self.steps
                   if s.kind != "slice")

    def comm_steps(self):
        return sum(1 for s in self.steps if s.kind != "slice")

    # -- guardian ----------------------------------------------------------
    def leg_digests(self, rank):
        """Guardian digests aggregated per leg kind — same field set
        as ``ZeroRuntime.leg_digests`` so ``guardian.compare_digests``
        applies unchanged."""
        digests = {}
        for kind in sorted({s.kind for s in self.steps}):
            ss = [s for s in self.steps if s.kind == kind]
            ops = sorted({s.op for s in ss if s.op is not None})
            dtypes = sorted({self.tree_meta[c.leaf][1]
                             for s in ss for c in s.copies})
            digests[f"reshard_{kind}"] = {
                "kind": f"reshard_{kind}",
                "op": ops[0] if ops else None,
                "dtype": ",".join(dtypes),
                "shapes": [[s.total_bytes] for s in ss],
                "process_set": 0,
                "prescale": None,
                "postscale": None,
                "root_rank": None,
                "codec": self.sig8,
                "shard_index": rank,
                "shard_shape": [[s.nbytes] for s in ss],
            }
        return digests

    def verify_consistency(self, board=None, rank=None, size=None,
                           timeout_s=None):
        """Cross-rank program check through the guardian board (a
        launcher job with ``HVDTPU_CONSISTENCY_CHECK`` on): publish this
        rank's leg digests, compare every peer's — a rank that derived a
        different program would exchange mismatched windows and corrupt
        the tree silently. Mirrors ``ZeroRuntime.verify_plan_consistency``:
        raises ``CollectiveMismatchError`` naming the divergent rank and
        field, ``CollectiveAbortError`` when a peer published nothing
        within ``HVDTPU_CONSISTENCY_TIMEOUT``."""
        from .. import basics, guardian
        from ..exceptions import CollectiveAbortError
        if board is None:
            if envparse.get_int(envparse.CONSISTENCY_CHECK, 0) <= 0:
                return
            if not basics.is_initialized():
                return
            rt = basics.runtime()
            if rt.mode != basics.MODE_SPMD or rt.topology.size <= 1:
                return
            board = guardian.make_cross_process_board()
            if board is None:
                return
            rank, size = rt.topology.rank, rt.topology.size
        if timeout_s is None:
            timeout_s = envparse.get_float(
                envparse.CONSISTENCY_TIMEOUT,
                guardian.DEFAULT_CONSISTENCY_TIMEOUT_S)
        mine = self.leg_digests(rank)
        for leg, digest in mine.items():
            board.put(f"reshard.plan.{leg}.{rank}",
                      guardian.render_digest(digest))
        for leg, digest in mine.items():
            theirs, waiting, _ = guardian.wait_digests(
                board, lambda r, leg=leg: f"reshard.plan.{leg}.{r}",
                set(range(size)) - {rank}, timeout_s)
            divergences = guardian.compare_digests(digest, theirs)
            if divergences:
                raise guardian.mismatch_error(
                    f"redistribution program {leg}", divergences, rank,
                    "Every rank must derive the identical program — check "
                    "the specs/tree/HVDTPU_RESHARD_BUCKET_BYTES agree on "
                    "all ranks.")
            if waiting:
                raise CollectiveAbortError(
                    f"redistribution program check of {leg}: rank(s) "
                    f"{sorted(waiting)} published no digest within "
                    f"{timeout_s:.1f}s (HVDTPU_CONSISTENCY_TIMEOUT)")

    # -- hvd-sim proof -----------------------------------------------------
    def sim_stream(self):
        """This program as one rank's hvd-sim event stream."""
        return [_ProgramEvent(s) for s in self.steps]

    def prove(self, world=None):
        """Run the program through hvd-sim's lockstep matcher
        (``analysis.simulate._lockstep``) at ``world`` symbolic ranks:
        returns ``[]`` when deadlock-freedom (HVD501) and digest
        agreement (HVD502) hold, else the proven Diagnostics."""
        if world is None:
            world = max(self.src.world, self.dst.world)
        world = max(2, int(world))
        streams = {r: self.sim_stream() for r in range(world)}
        return check_streams(streams)


def check_streams(streams):
    """Lockstep-match per-rank event streams; returns HVD501/HVD502
    Diagnostics (the same rules the schedule simulator proves) or
    ``[]``. Exposed separately so tests can corrupt a stream and watch
    the checker catch it."""
    from ..analysis.diagnostics import Diagnostic
    from ..analysis.simulate import _lockstep
    ranks = sorted(streams)
    result = _lockstep(streams, ranks)
    if result is None:
        return []
    blocked = {r: ev.describe() for r, ev in result["blocked"].items()}
    if result["type"] == "deadlock":
        return [Diagnostic.make(
            "HVD501",
            "redistribution program deadlocks: per-rank step "
            f"sequences diverge at {blocked}",
            file="<reshard-program>",
            trace={"blocked": blocked})]
    return [Diagnostic.make(
        "HVD502",
        f"redistribution program digest mismatch on "
        f"{result['field']}: {blocked}",
        file="<reshard-program>",
        trace={"blocked": blocked, "field": result["field"]})]


# ==========================================================================
# Synthesis
# ==========================================================================

def _source_cover(src, tree_meta, leaf):
    """Sorted coverage list ``(g0, g1, rank, buf, b0)`` of every src
    rank's holdings of ``leaf``."""
    cov = []
    for r in range(src.world):
        for iv in src.ownership(tree_meta, r)[leaf]:
            cov.append((iv.g0, iv.g0 + iv.length, r, iv.buf, iv.b0))
    cov.sort(key=lambda c: (c[0], c[2]))
    return cov


def _raw_copies(src, dst, tree_meta, same_mesh):
    """The minimal copy list: every destination interval filled from a
    deterministic source choice — the destination rank itself when the
    meshes coincide and it already holds the bytes (zero comm), else
    the lowest-numbered holder. With ``pending_sum`` EVERY holder
    contributes (the executor sums)."""
    copies = []
    for i in range(len(tree_meta)):
        cov = _source_cover(src, tree_meta, i)
        if not cov:
            # leaf has no source elements (size 0) — nothing to move.
            continue
        for dr in range(dst.world):
            for div in dst.ownership(tree_meta, dr)[i]:
                p, end = div.g0, div.g0 + div.length
                while p < end:
                    cands = [c for c in cov if c[0] <= p < c[1]]
                    if not cands:
                        raise PlanError(
                            f"leaf {i} element {p} is not held by any "
                            "source rank — specs are incompatible "
                            "with the tree")
                    if src.pending_sum:
                        take = min(end, min(c[1] for c in cands)) - p
                        chosen = cands
                    else:
                        chosen = None
                        if same_mesh:
                            for c in cands:
                                if c[2] == dr:
                                    chosen = c
                                    break
                        if chosen is None:
                            chosen = cands[0]
                        take = min(end, chosen[1]) - p
                        chosen = [chosen]
                    for g0, _, r, buf, b0 in chosen:
                        copies.append(Copy(
                            i, r, buf, b0 + (p - g0), dr, div.buf,
                            div.b0 + (p - div.g0), take))
                    p += take
    return copies


def _itemsize(tree_meta, leaf):
    return torch_dtype(tree_meta[leaf][1]).itemsize


def _split_large(copies, tree_meta, bucket_bytes):
    out = []
    for c in copies:
        isz = _itemsize(tree_meta, c.leaf)
        max_elems = max(1, bucket_bytes // isz)
        off = 0
        while off < c.length:
            take = min(c.length - off, max_elems)
            out.append(Copy(c.leaf, c.src_rank, c.src_buf,
                            c.src_off + off, c.dst_rank, c.dst_buf,
                            c.dst_off + off, take))
            off += take
    return out


def _copy_key(c):
    return (c.leaf, c.dst_rank, c.dst_buf, c.dst_off, c.src_rank)


def _classify(copies, op):
    """Leg kind of one sealed chunk of remote copies."""
    if op == "sum":
        return "reducescatter"
    by_dst = {}
    for c in copies:
        by_dst.setdefault(c.dst_rank, set()).add(
            (c.src_rank, c.src_buf, c.src_off, c.length))
    payloads = list(by_dst.values())
    if len(payloads) > 1 and all(p == payloads[0]
                                 for p in payloads[1:]):
        return "allgather"
    return "alltoall"


def _chunk_bytes(copies, tree_meta):
    per_rank = {}
    total = 0
    for c in copies:
        b = c.length * _itemsize(tree_meta, c.leaf)
        per_rank[c.dst_rank] = per_rank.get(c.dst_rank, 0) + b
        total += b
    return (max(per_rank.values()) if per_rank else 0), total


def _chunk_exchange(local, remote, tree_meta, bucket_bytes, op):
    """Exchange chunking: seal a step when any destination rank's
    received payload would exceed the bucket budget."""
    steps = []

    def seal(chunk, kind):
        if not chunk:
            return
        nbytes, total = _chunk_bytes(chunk, tree_meta)
        steps.append(Step(len(steps), kind, op if kind != "slice"
                          else None, nbytes, total, chunk))

    for group, forced_kind in ((remote, None), (local, "slice")):
        chunk, per_rank = [], {}
        for c in sorted(group, key=_copy_key):
            b = c.length * _itemsize(tree_meta, c.leaf)
            if chunk and per_rank.get(c.dst_rank, 0) + b \
                    > bucket_bytes:
                seal(chunk, forced_kind or _classify(chunk, op))
                chunk, per_rank = [], {}
            chunk.append(c)
            per_rank[c.dst_rank] = per_rank.get(c.dst_rank, 0) + b
        seal(chunk, forced_kind or _classify(chunk, op))
    return steps


def _chunk_gather(local, remote, tree_meta, bucket_bytes, op):
    """Gather chunking: windows walk the UNIQUE source bytes; every
    window is an all-gather (each destination receives the whole
    window). More bytes than exchange, fewer / more uniform legs."""
    steps = []
    order = sorted(remote, key=lambda c: (c.leaf, c.src_rank,
                                          c.src_buf, c.src_off))
    window_of, cum = {}, 0
    for c in order:
        key = (c.src_rank, c.src_buf, c.src_off, c.length)
        if key not in window_of:
            window_of[key] = cum // bucket_bytes
            cum += c.length * _itemsize(tree_meta, c.leaf)
    windows = {}
    for c in order:
        windows.setdefault(
            window_of[(c.src_rank, c.src_buf, c.src_off, c.length)],
            []).append(c)
    for w in sorted(windows):
        chunk = windows[w]
        uniq = {}
        for c in chunk:
            uniq[(c.src_rank, c.src_buf, c.src_off, c.length)] = \
                c.length * _itemsize(tree_meta, c.leaf)
        nbytes = sum(uniq.values())
        steps.append(Step(
            len(steps),
            "reducescatter" if op == "sum" else "allgather", op,
            nbytes, nbytes, chunk))
    if local:
        nbytes, total = _chunk_bytes(local, tree_meta)
        steps.append(Step(len(steps), "slice", None, nbytes, total,
                          local))
    return steps


def _price(steps, world, table):
    from ..analysis import costmodel
    return sum(costmodel.collective_time(s.kind, s.nbytes, world,
                                         table)
               for s in steps if s.kind != "slice")


def plan_redistribution(src_spec, dst_spec, tree_meta,
                        bucket_bytes=None, table=None):
    """Plan the (mesh, layout) → (mesh, layout) move of a tree whose
    leaves are ``tree_meta = [(shape, dtype), ...]`` (see
    :func:`~horovod_tpu.resharding.spec.tree_meta_of`). Returns the
    cheapest legal :class:`Program` under the α–β cost model."""
    tree_meta = [(tuple(int(d) for d in shape), str(dtype))
                 for shape, dtype in tree_meta]
    src_spec.validate(tree_meta)
    dst_spec.validate(tree_meta)
    if bucket_bytes is None:
        bucket_bytes = envparse.get_int(
            envparse.RESHARD_BUCKET_BYTES,
            DEFAULT_RESHARD_BUCKET_BYTES)
    bucket_bytes = max(int(bucket_bytes), 1)
    same_mesh = src_spec.mesh_signature() == dst_spec.mesh_signature()
    op = "sum" if src_spec.pending_sum else None
    copies = _split_large(
        _raw_copies(src_spec, dst_spec, tree_meta, same_mesh),
        tree_meta, bucket_bytes)
    local = [c for c in copies
             if same_mesh and c.src_rank == c.dst_rank
             and not src_spec.pending_sum]
    remote = [c for c in copies
              if not (same_mesh and c.src_rank == c.dst_rank)
              or src_spec.pending_sum]
    world = max(src_spec.world, dst_spec.world)
    candidates = {}
    exchange = _chunk_exchange(local, remote, tree_meta, bucket_bytes,
                               op)
    candidates["exchange"] = (_price(exchange, world, table), exchange)
    if remote:
        gather = _chunk_gather(local, remote, tree_meta, bucket_bytes,
                               op)
        candidates["gather"] = (_price(gather, world, table), gather)
    strategy = min(sorted(candidates),
                   key=lambda k: candidates[k][0])
    if not remote and all(s.kind == "slice" for s in exchange):
        candidates["local"] = candidates.pop("exchange")
        strategy = "local"
    predicted_s, steps = candidates[strategy]
    for idx, s in enumerate(steps):
        s.index = idx
    return Program(src_spec, dst_spec, tree_meta, bucket_bytes,
                   strategy, predicted_s,
                   steps, {k: v[0] for k, v in candidates.items()})

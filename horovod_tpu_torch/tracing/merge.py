"""Launcher-side merge: per-rank JSONL shards to one Perfetto/Chrome trace
(port of ``horovod_tpu/tracing/merge.py``; either package's shards).

Each rank's shard (recorder.py) carries wall-clock stamps and a meta
header with that rank's clock offset to the driver (clock.py). The
merger aligns every stamp onto the driver's clock, gives each rank its
own track (``pid`` = rank, with a ``process_name`` metadata event), and
emits:

- one complete-span (``ph: "X"``) per collective per rank, from submit
  to completion, laid out on greedily-allocated lanes so overlapping
  in-flight collectives render side by side instead of corrupting the
  nesting;
- **flow arrows** (``ph: "s"``/``"f"``) connecting every rank's span for
  the same correlation key (name × occurrence × elastic version) — the
  synthetic "collective" arrows that make cross-rank gating visible in
  the Perfetto UI;
- instant events for everything else (negotiation, guardian, chaos,
  elastic, flight-recorder records).

The output is a standard ``{"traceEvents": [...]}`` JSON object that
chrome://tracing and https://ui.perfetto.dev load directly.
"""

import json
import os
import zlib

SHARD_PREFIX = "shard."
POSTMORTEM_PREFIX = "postmortem."
# A submission with no completion record (aborted run, truncated shard)
# still gets a span: this floor keeps it visible in the UI.
_MIN_DUR_US = 1.0


def corr_id(name, occ, version):
    """The cross-rank correlation key, rendered."""
    return f"{name}#{occ}@v{version}"


def load_shard(path):
    """``{"meta": {...}, "events": [...], "path": ...}``. Malformed
    lines are skipped (a rank killed mid-write leaves a torn tail)."""
    meta, events = None, []
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("e") == "meta" and meta is None:
                meta = rec
            else:
                events.append(rec)
    return {"meta": meta or {}, "events": events, "path": path}


def shard_paths(paths, kinds=(SHARD_PREFIX, POSTMORTEM_PREFIX)):
    """Expand files/directories into shard file paths (sorted)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if name.startswith(tuple(kinds)) \
                        and name.endswith(".jsonl"):
                    out.append(os.path.join(p, name))
        else:
            out.append(p)
    return out


def load_paths(paths, kinds=(SHARD_PREFIX, POSTMORTEM_PREFIX)):
    """Load every shard under ``paths``. An unreadable file (crashed
    rank holding the handle, permissions, mid-collection truncation to
    a directory...) is warned about and SKIPPED — one bad shard must
    not kill a merge or a cost-model calibration over the survivors;
    torn tails inside a readable shard are already handled line-wise
    by :func:`load_shard`."""
    from ..utils.logging_util import get_logger
    out = []
    for p in shard_paths(paths, kinds):
        try:
            out.append(load_shard(p))
        except OSError as exc:
            get_logger().warning(
                "hvd-trace: skipping unreadable shard %s (%s)", p, exc)
    return out


def bundle_by_rank(shards, version=None):
    """Group loaded shards into one record per rank for forensic
    consumers (``hvd-lint explain``, report tooling): keep only the
    newest elastic ``version`` present (or the explicit one), and when
    a rank left several dumps for that version (respawns share a
    directory), keep the newest by meta timestamp. Returns
    ``(version, {rank: shard})``."""
    if not shards:
        return None, {}
    if version is None:
        version = max(s["meta"].get("ver", 0) or 0 for s in shards)
    by_rank = {}
    for s in shards:
        meta = s["meta"]
        if (meta.get("ver", 0) or 0) != version:
            continue
        rank = meta.get("rank")
        if rank is None:
            continue
        prev = by_rank.get(rank)
        if prev is None or (meta.get("t", 0)
                            > prev["meta"].get("t", 0)):
            by_rank[rank] = s
    return version, by_rank


def aligned(t, meta, align=True):
    """A local stamp moved onto the driver's clock."""
    return t - meta.get("off", 0.0) if align else t


def collective_spans(shard, align=True):
    """Pair sub/fin records: ``{(name, occ): {"sub": t, "fin": t|None,
    "kind": ..., "err": bool}}`` with aligned times."""
    meta = shard["meta"]
    spans = {}
    for rec in shard["events"]:
        e = rec.get("e")
        if e not in ("sub", "fin"):
            continue
        key = (rec.get("n"), rec.get("o", 0))
        t = aligned(rec.get("t", 0.0), meta, align)
        s = spans.setdefault(key, {"sub": None, "fin": None,
                                   "kind": rec.get("k"), "err": False,
                                   "bytes": None})
        if e == "sub":
            s["sub"] = t
            if rec.get("b"):
                s["bytes"] = rec["b"]
        else:
            s["fin"] = t
            s["err"] = bool(rec.get("err"))
    return spans


def _alloc_lane(lanes, start, end):
    """Greedy lane allocation so overlapping spans get distinct tids."""
    for i, busy_until in enumerate(lanes):
        if start >= busy_until - 1e-9:
            lanes[i] = end
            return i
    lanes.append(end)
    return len(lanes) - 1


def merge_shards(shards, align=True):
    """Merge loaded shards into one Chrome/Perfetto trace dict."""
    shards = [s for s in shards if s["events"] or s["meta"]]
    if not shards:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = None
    for s in shards:
        for rec in s["events"]:
            t = aligned(rec.get("t", 0.0), s["meta"], align)
            base = t if base is None else min(base, t)
    if base is None:
        base = 0.0

    def us(t):
        return (t - base) * 1e6

    events = []
    # corr -> [(rank, start_us, lane)] for the flow pass.
    flow_sites = {}
    for s in shards:
        meta = s["meta"]
        rank = meta.get("rank", 0)
        ver = meta.get("ver", 0)
        label = f"rank {rank}"
        if meta.get("kind") == "postmortem":
            label += " (postmortem)"
        events.append({"ph": "M", "pid": rank, "tid": 0,
                       "name": "process_name",
                       "args": {"name": label}})
        spans = collective_spans(s, align)
        lanes = []
        last_t = max((aligned(r.get("t", 0.0), meta, align)
                      for r in s["events"]), default=base)
        for (name, occ), sp in sorted(
                spans.items(), key=lambda kv: kv[1]["sub"] or 0.0):
            if sp["sub"] is None:
                continue
            start = us(sp["sub"])
            end = us(sp["fin"] if sp["fin"] is not None else last_t)
            dur = max(end - start, _MIN_DUR_US)
            lane = _alloc_lane(lanes, start, start + dur)
            cid = corr_id(name, occ, ver)
            args = {"corr": cid, "rank": rank,
                    "kind": sp["kind"] or "collective"}
            if sp["fin"] is None:
                args["unfinished"] = True
            if sp["err"]:
                args["error"] = True
            events.append({"ph": "X", "pid": rank, "tid": lane,
                           "ts": round(start, 3), "dur": round(dur, 3),
                           "cat": "collective", "name": name,
                           "args": args})
            flow_sites.setdefault(cid, []).append((rank, start, lane))
        # Non-collective records as instants on a dedicated lane.
        ev_tid = len(lanes) or 1
        for rec in s["events"]:
            if rec.get("e") != "ev":
                continue
            t = us(aligned(rec.get("t", 0.0), meta, align))
            args = {k: v for k, v in rec.items()
                    if k not in ("e", "t", "cat", "n")}
            events.append({"ph": "i", "pid": rank, "tid": ev_tid,
                           "ts": round(t, 3), "s": "t",
                           "cat": rec.get("cat", "event"),
                           "name": f"{rec.get('cat', 'ev')}:"
                                   f"{rec.get('n', '')}",
                           "args": args})

    # Flow arrows: one per correlation key spanning >= 2 ranks, from the
    # earliest-submitting rank to every other — submit-order gating made
    # visible ("which rank's late submit gated the group").
    for cid, sites in sorted(flow_sites.items()):
        if len(sites) < 2:
            continue
        fid = zlib.crc32(cid.encode())
        sites = sorted(sites, key=lambda site: site[1])
        first_rank, first_ts, first_lane = sites[0]
        events.append({"ph": "s", "id": fid, "pid": first_rank,
                       "tid": first_lane, "ts": round(first_ts, 3),
                       "cat": "collective", "name": cid})
        for rank, ts, lane in sites[1:]:
            events.append({"ph": "f", "bp": "e", "id": fid, "pid": rank,
                           "tid": lane, "ts": round(ts, 3),
                           "cat": "collective", "name": cid})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"tool": "hvd-trace",
                          "ranks": sorted({s["meta"].get("rank", 0)
                                           for s in shards}),
                          "aligned": bool(align)}}


def collect_shards(addr, port, token, version, out_dir, max_ranks=64,
                   kinds=("shard", "postmortem")):
    """Fetch pushed shards from the driver KV store into ``out_dir``;
    returns the written paths. EVERY slot under ``max_ranks`` is
    probed for every kind — shard pushes are explicitly best-effort on
    the worker side, so one rank's failed push must not hide the
    shards of every higher rank. A gap against the world size the
    collected metas declare is warned about, so a partial merge never
    masquerades as full coverage."""
    from ..runner import http_client
    from ..utils.logging_util import get_logger
    os.makedirs(out_dir, exist_ok=True)
    scope = f"trace.{version}"
    written = []
    shard_ranks, declared_size = [], 0
    for kind in kinds:
        for rank in range(max_ranks):
            raw = http_client.get_kv(addr, port, scope,
                                     f"{kind}.{rank}", token=token,
                                     retries=1, deadline=5.0)
            if raw is None:
                continue
            path = os.path.join(out_dir,
                                f"{kind}.r{rank}.v{version}.jsonl")
            with open(path, "wb") as f:
                f.write(raw if isinstance(raw, bytes) else raw.encode())
            written.append(path)
            if kind == "shard":
                shard_ranks.append(rank)
                try:
                    head = raw.split(b"\n", 1)[0]
                    declared_size = max(declared_size,
                                        int(json.loads(head)
                                            .get("size", 0)))
                except (ValueError, AttributeError):
                    pass
    if shard_ranks:
        expected = range(max(declared_size, max(shard_ranks) + 1))
        missing = sorted(set(expected) - set(shard_ranks))
        if missing:
            get_logger().warning(
                "hvd-trace collect: no pushed shard for rank(s) %s "
                "(world size %d per the collected metas) — the merge "
                "will cover a PARTIAL rank set", missing,
                len(expected))
    return written

"""Trace analysis: straggler attribution, critical path, comm breakdown
(port of ``horovod_tpu/tracing/analyze.py``).

Works on the loaded shards (merge.load_paths), joining every rank's
span for the same correlation key. Three questions, per the paper
motivation (PAPERS.md 2004.13336: per-step comm/compute attribution;
2506.17615: collective-timing methodology):

- **Straggler attribution** — for each collective, the rank whose LATE
  SUBMIT gated the group (everyone else was parked in negotiation until
  it arrived). The skew is only called a straggler when it clears the
  clock-alignment uncertainty (± max residual RTT/2 across the ranks
  involved): sub-RTT skews are measurement noise, not stragglers.
- **Critical path** — collectives sharing an occurrence number form a
  *step* (a training step submits the same names once each). Within a
  step the critical path is walked backward from the last completion:
  repeatedly pick the collective covering the cursor with the earliest
  start, count uncovered gaps as compute.
- **Comm breakdown** — per rank: union of in-flight collective
  intervals over the shard's span, plus the fraction of collective time
  overlapped with other collectives (reconcilable against the live
  ``hvd_overlap_fraction`` gauge when a metrics snapshot is supplied).

``publish_metrics`` feeds ``hvd_straggler_delay_seconds{rank}`` so the
offline attribution and the telemetry plane tell one story.
"""

from . import merge as merge_mod

# Sub-millisecond skews are below what KV-round-trip alignment can
# resolve even on a quiet localhost; never call them stragglers.
MIN_SKEW_FLOOR_S = 1e-3


def _span_table(shards, align=True):
    """{(ver, name, occ): {rank: {"sub", "fin", "kind"}}} over all
    shards. The elastic version is part of the join key — it is part
    of the correlation key for exactly this reason: occurrence
    counters restart with every cohort, so joining v0's ``grad#1``
    with v1's would overwrite same-rank spans and "discover" a
    straggler delayed by the whole inter-cohort gap."""
    table = {}
    for s in shards:
        rank = s["meta"].get("rank", 0)
        ver = s["meta"].get("ver", 0)
        for (name, occ), sp in \
                merge_mod.collective_spans(s, align).items():
            if sp["sub"] is None:
                continue
            table.setdefault((ver, name, occ), {})[rank] = sp
    return table


def _skew_floor(shards):
    """Alignment uncertainty: half the worst min-RTT across shards (the
    NTP error bound), floored at MIN_SKEW_FLOOR_S."""
    rtts = [s["meta"].get("rtt") for s in shards
            if s["meta"].get("rtt") is not None]
    return max(MIN_SKEW_FLOOR_S, max(rtts) / 2.0 if rtts else 0.0)


def _critical_path(colls):
    """Backward interval walk over one step's collectives. Each item:
    {"name", "occ", "start", "end", ...}. Returns (chain, comm_s,
    gap_s): chain is last-to-first, gaps are uncovered (compute)
    time."""
    items = [c for c in colls if c["end"] is not None]
    if not items:
        return [], 0.0, 0.0
    t0 = min(c["start"] for c in items)
    cursor = max(c["end"] for c in items)
    chain, comm_s, gap_s = [], 0.0, 0.0
    remaining = sorted(items, key=lambda c: c["end"], reverse=True)
    while cursor > t0 + 1e-9 and remaining:
        covering = [c for c in remaining
                    if c["start"] < cursor - 1e-9
                    and c["end"] >= cursor - 1e-6]
        if not covering:
            # Gap: nothing in flight ending at the cursor — compute (or
            # idle) time on the critical path.
            nxt = max((c for c in remaining
                       if c["end"] < cursor - 1e-9),
                      key=lambda c: c["end"], default=None)
            if nxt is None:
                break
            gap_s += cursor - nxt["end"]
            cursor = nxt["end"]
            continue
        pick = min(covering, key=lambda c: c["start"])
        chain.append(pick)
        comm_s += cursor - pick["start"]
        cursor = pick["start"]
        remaining = [c for c in remaining if c is not pick]
    return chain, comm_s, gap_s


def analyze(shards, align=True, metrics=None):
    """Full report dict over loaded shards (see module docstring)."""
    shards = [s for s in shards if s["meta"] or s["events"]]
    table = _span_table(shards, align)
    floor = _skew_floor(shards)
    ranks = sorted({s["meta"].get("rank", 0) for s in shards})

    collectives = []
    straggler = {r: {"delay_s": 0.0, "gated": 0} for r in ranks}
    for (ver, name, occ), by_rank in sorted(
            table.items(),
            key=lambda kv: min(sp["sub"] for sp in kv[1].values())):
        subs = {r: sp["sub"] for r, sp in by_rank.items()}
        first_sub = min(subs.values())
        last_rank = max(subs, key=subs.get)
        skew = subs[last_rank] - first_sub
        fins = [sp["fin"] for sp in by_rank.values()
                if sp["fin"] is not None]
        end = max(fins) if fins else None
        rec = {
            "name": name, "occ": occ, "version": ver,
            "ranks": sorted(by_rank),
            "start": first_sub, "end": end,
            "dur_s": (end - first_sub) if end is not None else None,
            "submit_skew_s": skew,
            "straggler_rank": (last_rank
                               if len(by_rank) > 1 and skew > floor
                               else None),
        }
        collectives.append(rec)
        if rec["straggler_rank"] is not None:
            straggler[last_rank]["delay_s"] += skew
            straggler[last_rank]["gated"] += 1

    # Steps: collectives grouped by (version, occurrence) — a training
    # loop submits the same name set once per step, so occurrence ==
    # step index within a cohort; a loop of per-step-unique names
    # degenerates to one step, which the per-collective table still
    # covers.
    steps = []
    by_step = {}
    for c in collectives:
        by_step.setdefault((c["version"], c["occ"]), []).append(c)
    for (ver, occ) in sorted(by_step):
        colls = by_step[(ver, occ)]
        chain, comm_s, gap_s = _critical_path(colls)
        ends = [c["end"] for c in colls if c["end"] is not None]
        t0 = min(c["start"] for c in colls)
        t1 = max(ends) if ends else None
        crit = chain[0] if chain else None
        steps.append({
            "step": occ,
            "version": ver,
            "collectives": len(colls),
            "duration_s": (t1 - t0) if t1 is not None else None,
            "critical_path": [{"name": c["name"],
                               "straggler_rank": c["straggler_rank"],
                               "submit_skew_s": c["submit_skew_s"]}
                              for c in chain],
            "critical_comm_s": comm_s,
            "critical_gap_s": gap_s,
            "gating_collective": crit["name"] if crit else None,
            "gating_rank": crit["straggler_rank"] if crit else None,
        })

    # Per-rank comm window: union of in-flight intervals, ACCUMULATED
    # across a rank's shards (elastic cohorts are disjoint in time, so
    # their unions add).
    comm = {}
    for s in shards:
        rank = s["meta"].get("rank", 0)
        spans = sorted(
            ((sp["sub"], sp["fin"]) for sp in
             merge_mod.collective_spans(s, align).values()
             if sp["sub"] is not None and sp["fin"] is not None),
            key=lambda iv: iv[0])
        total = sum(b - a for a, b in spans)
        union, cur = 0.0, None
        for a, b in spans:
            if cur is None or a > cur[1]:
                if cur is not None:
                    union += cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        if cur is not None:
            union += cur[1] - cur[0]
        ts = [merge_mod.aligned(r.get("t", 0.0), s["meta"], align)
              for r in s["events"]]
        wall = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
        acc = comm.setdefault(rank, {"collective_s": 0.0,
                                     "inflight_union_s": 0.0,
                                     "wall_s": 0.0})
        acc["collective_s"] += total
        acc["inflight_union_s"] += union
        acc["wall_s"] += wall
    for acc in comm.values():
        acc["comm_fraction"] = (acc["inflight_union_s"] / acc["wall_s"]
                                if acc["wall_s"] > 0 else None)
        # Fraction of collective time overlapped with OTHER in-flight
        # collectives — the trace-side view of what the live
        # hvd_overlap_fraction gauge measures.
        acc["overlap_fraction"] = (
            1.0 - acc["inflight_union_s"] / acc["collective_s"]
            if acc["collective_s"] > 0 else None)

    report = {
        "ranks": ranks,
        "collectives": len(collectives),
        "collective_table": collectives,
        "steps": steps,
        "stragglers": straggler,
        "comm": comm,
        "skew_floor_s": floor,
        "clock": [{"rank": s["meta"].get("rank", 0),
                   "ver": s["meta"].get("ver", 0),
                   "off": s["meta"].get("off", 0.0),
                   "rtt": s["meta"].get("rtt")}
                  for s in shards],
    }
    if metrics is not None:
        report["metrics_overlap_fraction"] = _gauge_value(
            metrics, "hvd_overlap_fraction")
    return report


def _gauge_value(snapshot, family):
    fam = (snapshot.get("families") or {}).get(family)
    if not fam:
        return None
    samples = fam.get("samples") or []
    return samples[0].get("value") if samples else None


def publish_metrics(report):
    """Feed the straggler attribution into the telemetry plane
    (``hvd_straggler_delay_seconds{rank}``) — NULL no-op when metrics
    are off."""
    from ..telemetry import core as telemetry
    gauge = telemetry.gauge(
        "hvd_straggler_delay_seconds",
        "Cumulative submit-skew delay attributed to each rank by the "
        "trace analyzer (which rank's late submit gated collectives)",
        labelnames=("rank",))
    for rank, rec in report["stragglers"].items():
        gauge.labels(rank=str(rank)).set(rec["delay_s"])
    return gauge


def render_report(report):
    """Human-readable summary (the ``hvd-trace report`` output)."""
    lines = []
    ranks = report["ranks"]
    lines.append(f"ranks: {ranks}  collectives: "
                 f"{report['collectives']}  "
                 f"skew floor: {report['skew_floor_s'] * 1e3:.2f} ms")
    clock = report.get("clock") or []
    if clock:
        cl = "  ".join(
            f"r{v['rank']}v{v.get('ver', 0)}: "
            f"off={v['off'] * 1e3:+.2f}ms"
            + (f" rtt={v['rtt'] * 1e3:.2f}ms" if v.get("rtt") else "")
            for v in sorted(clock,
                            key=lambda v: (v.get("ver", 0), v["rank"])))
        lines.append(f"clock: {cl}")
    versions = {st.get("version", 0) for st in report["steps"]}
    lines.append("")
    lines.append("per-step critical path:")
    lines.append("  step  colls  duration_ms  comm_ms  compute_ms  "
                 "gating collective (straggler)")
    for st in report["steps"]:
        dur = st["duration_s"]
        gate = st["gating_collective"] or "-"
        if st["gating_rank"] is not None:
            gate += f" (rank {st['gating_rank']})"
        label = (str(st["step"]) if len(versions) <= 1
                 else f"v{st.get('version', 0)}:{st['step']}")
        lines.append(
            f"  {label:>4}  {st['collectives']:>5}  "
            f"{(dur * 1e3 if dur is not None else 0):>11.2f}  "
            f"{st['critical_comm_s'] * 1e3:>7.2f}  "
            f"{st['critical_gap_s'] * 1e3:>10.2f}  {gate}")
    lines.append("")
    lines.append("straggler attribution (submit skew above the floor):")
    lines.append("  rank  gated_collectives  total_delay_ms")
    for rank in ranks:
        rec = report["stragglers"][rank]
        lines.append(f"  {rank:>4}  {rec['gated']:>17}  "
                     f"{rec['delay_s'] * 1e3:>14.2f}")
    lines.append("")
    lines.append("comm breakdown:")
    lines.append("  rank  collective_ms  inflight_ms  comm_frac  "
                 "overlap_frac")
    for rank in ranks:
        c = report["comm"].get(rank)
        if c is None:
            continue

        def fmt(x, scale=1.0):
            return f"{x * scale:.2f}" if x is not None else "-"

        lines.append(
            f"  {rank:>4}  {fmt(c['collective_s'], 1e3):>13}  "
            f"{fmt(c['inflight_union_s'], 1e3):>11}  "
            f"{fmt(c['comm_fraction']):>9}  "
            f"{fmt(c['overlap_fraction']):>12}")
    if report.get("metrics_overlap_fraction") is not None:
        lines.append(f"  live hvd_overlap_fraction gauge: "
                     f"{report['metrics_overlap_fraction']:.3f}")
    return "\n".join(lines)

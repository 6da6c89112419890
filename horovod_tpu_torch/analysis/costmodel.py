"""Calibrated α–β collective cost model on the symbolic executor (port of
``horovod_tpu/analysis/costmodel.py``).

Static step-time prediction for schedules the interprocedural verifier
(analysis/schedule.py) extracts. Each collective kind gets the standard
α–β decomposition (a per-hop latency term and a per-byte bandwidth term):

- ring allreduce:       ``2(n-1)·α + 2·((n-1)/n)·B/β``
- allgather / reduce-scatter / all-to-all: ``(n-1)·α + ((n-1)/n)·B/β``
- broadcast (binomial tree): ``ceil(log2 n)·(α + B/β)``
- barrier (dissemination): ``2·ceil(log2 n)·α``

``B`` is payload bytes, ``n`` the world size. The model is **calibrated**
by fitting sub→fin spans from the port's trace shards (``HVDTPU_TRACE=1``;
``python -m horovod_tpu_torch.analysis.cli perf --calibrate <trace-dir>``):
a per-kind least-squares fit of (α, 1/β) over the recorded (world, bytes,
duration) tuples, a compute baseline from the analyzer's per-step
critical-path gaps, then a step-level regression (``wall ≈ fixed_s +
serial_fraction × Σ span``) that pins the composed prediction to recorded
whole steps. Over NCCL on an H100 this fits the card's own table (see
``tests/test_torch_port_analysis_cuda.py``). :data:`DEFAULT_TABLE` is the
JAX package's cold-case table: its coefficients rank candidates and
place bucket optima before any calibration; they are not an H100
measurement. The redistribution planner prices with it, and the
autotuner's warm-start prior (``HVDTPU_COSTMODEL``) orders its probes by
it.

What the model deliberately ignores: link congestion from neighbours,
topology splits, per-dtype math throughput, and fusion-buffer padding
waste beyond the bucket-count term. It is a *ranking and cliff-finding*
model, not a cycle-accurate one.

On top of the prediction sit the HVD6xx static performance rules:

- **HVD601** — a literal ``HVDTPU_BUCKET_BYTES`` /
  ``HVDTPU_ZERO_BUCKET_BYTES`` assignment whose value is ≥2× away from
  the predicted bucket optimum at the largest target cohort.
- **HVD602** — a serialization point inside a step loop: a barrier
  co-resident with other collectives, or two-plus distinct synchronous
  per-tensor allreduce call sites (zero overlap opportunity either way).
- **HVD603** — a scale cliff: the predicted comm fraction crosses 50%
  between two probed cohort sizes (requires a calibrated compute
  baseline — the default table carries none, so this rule never fires
  cold).

Pure stdlib; the tracing modules it calibrates from are imported lazily
inside the calibration entry points.
"""

import ast
import json
import math
import os

from .diagnostics import Diagnostic, dedupe

# Default per-kind coefficients: sub-µs per-hop latency, ~1e11 B/s per
# link — enough to rank candidates and place bucket optima cold;
# calibration replaces them.
_DEF_ALPHA = 1e-6     # seconds per latency unit (per hop/round)
_DEF_BYTE_S = 1e-11   # seconds per byte per bandwidth unit (1/β)

MODEL_KINDS = ("allreduce", "allgather", "reducescatter", "broadcast",
               "alltoall", "barrier")

#: Cold-case table. ``compute_s`` is None on purpose: the default table
#: has no idea how long YOUR step computes, so every rule that needs a
#: compute baseline (HVD603) stays silent until calibration supplies
#: one. ``step_bytes`` is a 365M-param fp32 gradient set — the repo's
#: transformer target — used only to place bucket optima and seed
#: autotune priors when no calibration ran.
DEFAULT_TABLE = {
    "format": 1,
    "source": "default",
    "kinds": {k: {"alpha_s": _DEF_ALPHA, "byte_s": _DEF_BYTE_S}
              for k in MODEL_KINDS},
    "compute_s": None,
    "fixed_s": 0.0,
    "step_bytes": int(365e6 * 4),
    "serial_fraction": 1.0,
    "worlds": [],
    "spans": 0,
}

_BUCKET_KNOBS = ("HVDTPU_BUCKET_BYTES", "HVDTPU_ZERO_BUCKET_BYTES",
                 "HOROVOD_TPU_BUCKET_BYTES", "HOROVOD_BUCKET_BYTES")

_DOC_HINT = "see docs/lint.md (HVD6xx) and docs/performance.md " \
            "\"Predicted scaling\""


# -- kind canonicalization --------------------------------------------------
def canonical_kind(kind):
    """Map a terminal collective call name (schedule.ScheduleEvent.kind,
    trace-shard ``k`` field) onto a model kind. Unknown names fall back
    to the ring-allreduce shape — the conservative default."""
    k = (kind or "").lower().rstrip("_")
    if k.endswith("_async"):
        k = k[: -len("_async")]
    if k.startswith("grouped_"):
        k = k[len("grouped_"):]
    if "sparse" in k:
        # sparse_allreduce moves (indices, values) via allgather legs
        return "allgather"
    if "reducescatter" in k or "reduce_scatter" in k \
            or k == "psum_scatter":
        return "reducescatter"
    if "allgather" in k or k == "all_gather":
        return "allgather"
    if "alltoall" in k or k == "all_to_all" or k in ("ppermute",
                                                     "pshuffle"):
        return "alltoall"
    if "broadcast" in k:
        return "broadcast"
    if k in ("barrier", "join"):
        return "barrier"
    # allreduce, psum, pmean, pmax, pmin, and anything unrecognized
    return "allreduce"


def _terms(kind, world):
    """(latency_units, bandwidth_units): ``t = α·lat + B·byte_s·bw``."""
    n = max(2, int(world))
    if kind == "barrier":
        return 2.0 * math.ceil(math.log2(n)), 0.0
    if kind == "broadcast":
        hops = float(math.ceil(math.log2(n)))
        return hops, hops
    if kind in ("allgather", "reducescatter", "alltoall"):
        return float(n - 1), float(n - 1) / n
    # ring allreduce (reduce-scatter + allgather legs)
    return 2.0 * (n - 1), 2.0 * float(n - 1) / n


def _coeff(table, kind):
    row = (table.get("kinds") or {}).get(kind)
    if not row:
        row = DEFAULT_TABLE["kinds"][kind]
    return (float(row.get("alpha_s", _DEF_ALPHA)),
            float(row.get("byte_s", _DEF_BYTE_S)))


def collective_time(kind, nbytes, world, table=None):
    """Predicted wall seconds for one collective of ``nbytes`` payload
    at cohort size ``world``."""
    table = table or DEFAULT_TABLE
    kind = canonical_kind(kind)
    lat, bw = _terms(kind, world)
    alpha, byte_s = _coeff(table, kind)
    return alpha * lat + float(nbytes or 0) * byte_s * bw


def bucket_optimum(total_bytes, world, table=None, kind="allreduce"):
    """Bucket size minimizing exposed comm for ``total_bytes`` split
    into buckets: per-bucket latency overhead ``(T/B)·L`` trades
    against the un-overlappable last-bucket drain ``B·C`` — minimized
    at ``B* = sqrt(T·L/C)``, clamped to ``[64 KiB, T]``."""
    table = table or DEFAULT_TABLE
    total = max(1.0, float(total_bytes))
    lat, bw = _terms(canonical_kind(kind), world)
    alpha, byte_s = _coeff(table, kind)
    lat_s = alpha * lat
    per_byte = byte_s * bw
    if per_byte <= 0.0:
        return int(total)
    opt = math.sqrt(total * lat_s / per_byte)
    return int(min(total, max(64 * 1024, opt)))


# -- table IO ---------------------------------------------------------------
def _normalize_table(doc, source):
    table = dict(DEFAULT_TABLE)
    table["kinds"] = dict(DEFAULT_TABLE["kinds"])
    if isinstance(doc.get("kinds"), dict):
        for kind, row in doc["kinds"].items():
            if isinstance(row, dict):
                table["kinds"][kind] = {
                    "alpha_s": float(row.get("alpha_s", _DEF_ALPHA)),
                    "byte_s": float(row.get("byte_s", _DEF_BYTE_S)),
                }
    for key in ("compute_s", "fixed_s", "step_bytes",
                "serial_fraction", "worlds", "spans"):
        if key in doc:
            table[key] = doc[key]
    table["source"] = doc.get("source", source)
    return table


def load_table(path):
    """Load a model table JSON; raises ValueError on garbage."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"cost-model table {path}: not a JSON object")
    return _normalize_table(doc, source=path)


def save_table(table, path):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def resolve_table():
    """The session's model table: ``HVDTPU_COSTMODEL_TABLE`` when set
    and readable (unreadable warns and falls back — a stale export
    must not kill a lint run), else :data:`DEFAULT_TABLE`."""
    from ..utils import envparse
    path = envparse.get_str(envparse.COSTMODEL_TABLE)
    if path:
        try:
            return load_table(path)
        except (OSError, ValueError) as exc:
            import warnings
            warnings.warn(f"cost-model table {path!r} unusable ({exc}); "
                          "using the built-in default", stacklevel=2)
    return dict(DEFAULT_TABLE)


def target_ranks_from_env():
    from ..utils import envparse
    raw = envparse.get_str(envparse.PERF_TARGET_RANKS, "8,64,256,1024")
    ranks = []
    for part in raw.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            n = int(part)
        except ValueError:
            continue
        if n >= 2:
            ranks.append(n)
    return sorted(set(ranks)) or [8, 64, 256, 1024]


# -- calibration ------------------------------------------------------------
def _fit_kind(obs):
    """Least-squares (α, byte_s) for one kind over observations
    ``(lat_units, bw_byte_units, dur_s)`` where ``bw_byte_units`` is
    bytes × bandwidth-units (0/None when the span carried no payload
    record — the pre-PR16 shard format). Closed-form 2×2 normal
    equations; degenerate systems fall back to an α-only fit with the
    default byte term."""
    with_bytes = [(l, b, d) for (l, b, d) in obs if b]
    if len(with_bytes) >= 2:
        sxx = sum(l * l for l, _, _ in with_bytes)
        sxy = sum(l * b for l, b, _ in with_bytes)
        syy = sum(b * b for _, b, _ in with_bytes)
        sxd = sum(l * d for l, _, d in with_bytes)
        syd = sum(b * d for _, b, d in with_bytes)
        det = sxx * syy - sxy * sxy
        if det > 1e-30 * max(1.0, sxx) * max(1.0, syy):
            alpha = (sxd * syy - syd * sxy) / det
            byte_s = (syd * sxx - sxd * sxy) / det
            if alpha > 0.0 and byte_s > 0.0:
                return alpha, byte_s
    # α-only: every span's full duration charged to latency; keep the
    # default bandwidth term so payload still scales the prediction.
    rates = [d / l for (l, _, d) in obs if l > 0 and d > 0]
    alpha = sum(rates) / len(rates) if rates else _DEF_ALPHA
    return max(alpha, 1e-9), _DEF_BYTE_S


def _recalibrate_step_level(table, step_model_events, step_walls,
                            exposed):
    """Pin ``compute_s``/``serial_fraction`` to the STEP level: the
    per-kind α–β fit reconstructs individual sub→fin spans, but spans
    overlap (async pipelining) and the step pays fixed dispatch cost no
    span carries — so composing span times naively over- or
    under-shoots the wall step. For each run group's best recorded step
    (first submit → last completion, warm-up naturally excluded by
    taking the min) regress

        wall_step  ≈  compute_s  +  serial_fraction × Σ model span time

    With ≥2 groups at distinct sizes the 2-parameter least squares
    separates fixed cost from scaling cost; a single group solves the
    fraction against the gap-derived compute baseline; with no usable
    step the measured-exposed-comm ratio is the last resort. The
    intercept lands in ``fixed_s`` — per-step dispatch cost that sits
    on the critical path even for fully-async schedules — NOT in
    ``compute_s``, whose job is the hideable compute baseline
    (predict_step lets async comm overlap it)."""
    group_walls = {}         # group_key -> (model_sum, [walls])
    walls = {(k, o): w for (k, o, w) in step_walls}
    model_sums = {}
    for key, occ, events in step_model_events:
        model_sum = sum(collective_time(k, b, w, table)
                        for (k, b, w) in events)
        model_sums[(key, occ)] = model_sum
        wall = walls.get((key, occ))
        if model_sum <= 0.0 or not wall:
            continue
        group_walls.setdefault(key, (model_sum, []))[1].append(wall)

    # Per-group representative step: the MEDIAN wall — robust to both
    # the slow warm-up occurrences at the front of the shard and the
    # occasional straggler step, and the same statistic a calibration
    # job reports (tests/torch_port_analysis_worker.py), so residuals
    # compare like with like.
    pts = []
    for model_sum, ws in group_walls.values():
        ws.sort()
        mid = len(ws) // 2
        med = (ws[mid] if len(ws) % 2
               else (ws[mid - 1] + ws[mid]) / 2.0)
        pts.append((model_sum, med))
    pts.sort()
    if len(pts) >= 2 and pts[-1][0] > 1.001 * pts[0][0]:
        mean_x = sum(x for x, _ in pts) / len(pts)
        mean_y = sum(y for _, y in pts) / len(pts)
        var = sum((x - mean_x) ** 2 for x, _ in pts)
        cov = sum((x - mean_x) * (y - mean_y) for x, y in pts)
        frac = cov / var
        base = mean_y - frac * mean_x
        if base < 0.0:
            # Fixed cost cannot be negative: slope-only refit.
            base = 0.0
            frac = (sum(x * y for x, y in pts)
                    / sum(x * x for x, _ in pts))
        table["serial_fraction"] = min(1.2, max(0.01, frac))
        table["fixed_s"] = base
        if table["compute_s"] is None:
            table["compute_s"] = 0.0
        return
    if len(pts) == 1:
        # One run group: no leverage to split fixed from scaling cost —
        # fold everything into the fraction (exact reconstruction at
        # the calibrated size for async schedules, where predict_step's
        # hiding makes step = max(compute, serial·Σspan)).
        model_sum, wall = pts[0]
        table["serial_fraction"] = min(
            1.2, max(0.01, wall / model_sum))
        if table["compute_s"] is None:
            table["compute_s"] = 0.0
        return
    # No rank-0 step observed end-to-end: ratio of measured exposed
    # comm (critical-path attribution) over the model's summed span
    # time — async pipelines land well below 1.0, synchronous
    # per-tensor loops at ~1.0.
    fracs = []
    for (key, occ), meas in exposed.items():
        model_sum = model_sums.get((key, occ), 0.0)
        if model_sum > 0.0 and meas:
            fracs.append(min(1.2, max(0.01, meas / model_sum)))
    if fracs:
        table["serial_fraction"] = sum(fracs) / len(fracs)


def fit_shards(shards):
    """Fit a model table from loaded trace shards (merge.load_paths
    output). Returns the table dict (DEFAULT_TABLE shape, ``source:
    "calibrated"``)."""
    from ..tracing import analyze as analyze_mod
    from ..tracing import merge as merge_mod

    # A calibration dir may hold shards from SEVERAL runs (one per world
    # size, say). Occurrence counters
    # and rank ids restart per run, so the per-step analysis must stay
    # within one run: group by (directory, world size).
    groups = {}
    for shard in shards:
        meta = shard.get("meta") or {}
        world = int(meta.get("size") or 0) or 2
        key = (os.path.dirname(shard.get("path") or ""), world)
        groups.setdefault(key, []).append(shard)

    obs_by_kind = {}
    worlds = set()
    span_count = 0
    per_step_bytes = []
    step_model_events = []   # (group_key, occ) aligned step inputs
    step_walls = []          # (group_key, occ, first-sub -> last-fin)
    for key, group in sorted(groups.items()):
        world = key[1]
        worlds.add(world)
        for shard in group:
            rank = (shard.get("meta") or {}).get("rank", 0)
            spans = merge_mod.collective_spans(shard)
            by_occ = {}
            for (name, occ), sp in spans.items():
                if sp["sub"] is None or sp["fin"] is None or sp["err"]:
                    continue
                dur = sp["fin"] - sp["sub"]
                if dur <= 0.0:
                    continue
                kind = canonical_kind(sp.get("kind"))
                nbytes = sp.get("bytes")
                lat, bw = _terms(kind, world)
                obs_by_kind.setdefault(kind, []).append(
                    (lat, float(nbytes or 0) * bw, dur))
                span_count += 1
                if rank == 0:
                    by_occ.setdefault(occ, []).append(
                        (kind, nbytes, world, sp["sub"], sp["fin"]))
            for occ, evs in by_occ.items():
                events = [(k, b, w) for (k, b, w, _, _) in evs]
                total = sum(int(b or 0) for _, b, _ in events)
                if total > 0:
                    per_step_bytes.append(total)
                step_model_events.append((key, occ, events))
                wall = (max(f for *_, f in evs)
                        - min(s for *_, s, _ in evs))
                if wall > 0.0:
                    step_walls.append((key, occ, wall))

    table = dict(DEFAULT_TABLE)
    table["kinds"] = dict(DEFAULT_TABLE["kinds"])
    for kind, obs in obs_by_kind.items():
        alpha, byte_s = _fit_kind(obs)
        table["kinds"][kind] = {"alpha_s": alpha, "byte_s": byte_s}

    # Compute baseline + measured exposed comm from the analyzer's
    # per-step critical-path decomposition (2004.13336 attribution),
    # one run group at a time.
    gaps = []
    exposed = {}             # (group_key, occ) -> measured exposed comm
    for key, group in sorted(groups.items()):
        report = analyze_mod.analyze(group)
        for st in report.get("steps", []):
            if st.get("duration_s") is None:
                continue
            gaps.append(float(st.get("critical_gap_s") or 0.0))
            exposed[(key, st["step"])] = float(
                st.get("critical_comm_s") or 0.0)
    table["compute_s"] = (sum(gaps) / len(gaps)) if gaps else None

    if per_step_bytes:
        table["step_bytes"] = int(sum(per_step_bytes)
                                  / len(per_step_bytes))

    _recalibrate_step_level(table, step_model_events, step_walls,
                            exposed)
    table["source"] = "calibrated"
    table["worlds"] = sorted(worlds)
    table["spans"] = span_count
    return table


def fit_paths(paths):
    """``hvd-lint perf --calibrate``: load shards under ``paths`` and
    fit. Unreadable shard files are warned about and skipped
    (merge.load_paths); raises ValueError when no usable span
    survives."""
    from ..tracing import merge as merge_mod
    shards = merge_mod.load_paths(paths)
    table = fit_shards(shards)
    if not table["spans"]:
        raise ValueError(
            f"no usable collective spans under {paths!r} — nothing to "
            "calibrate (need shard.*.jsonl files from an "
            "HVDTPU_TRACE=1 run)")
    return table


# -- schedule extraction ----------------------------------------------------
class _StepLoop:
    """One loop body's directly-submitted collectives."""

    __slots__ = ("line", "events")

    def __init__(self, line):
        self.line = line
        self.events = []


def _walk_program(prog, top_events, loops, cur):
    """Collect direct ScheduleEvents per innermost loop (``loops``) and
    outside any loop (``top_events``)."""
    for node in prog:
        tag = node[0]
        if tag == "ev":
            (cur.events if cur is not None else top_events).append(
                node[1])
        elif tag == "br":
            _walk_program(node[2], top_events, loops, cur)
            _walk_program(node[3], top_events, loops, cur)
        elif tag == "loop":
            inner = _StepLoop(node[1].line)
            loops.append(inner)
            _walk_program(node[2], top_events, loops, inner)


def _entry_modules(verifier):
    """The modules the invocation NAMED, not the package modules the
    corpus pulled in through imports: perf findings and predictions
    stay scoped to the code under review (the self-sweep names the
    whole package, so nothing hides from CI)."""
    seen = set()
    out = []
    for mod in verifier.entries:
        if id(mod) not in seen:
            seen.add(id(mod))
            out.append(mod)
    return sorted(out, key=lambda m: m.path)


def extract_schedules(verifier):
    """Per-function step schedules over a fixpointed Verifier corpus's
    entry modules:
    ``[{"function", "file", "line", "events", "in_loop"}]`` where
    ``events`` is the list of ScheduleEvents submitted once per step
    (the busiest loop body, or the straight-line schedule when the
    function has no collective-bearing loop)."""
    verifier.fixpoint()
    out = []
    for mod in _entry_modules(verifier):
        for qual in sorted(mod.funcs):
            fn = mod.funcs[qual]
            top, loops = [], []
            _walk_program(fn.program, top, loops, None)
            with_events = [lp for lp in loops if lp.events]
            if with_events:
                step = max(with_events, key=lambda lp: len(lp.events))
                out.append({"function": qual, "file": mod.path,
                            "line": step.line, "events": step.events,
                            "in_loop": True, "loops": with_events})
            elif top:
                out.append({"function": qual, "file": mod.path,
                            "line": top[0].line, "events": top,
                            "in_loop": False, "loops": []})
    return out


def _is_async(event):
    return "async" in (event.kind or "")


def predict_step(events, world, table, step_bytes=None):
    """Predicted per-step decomposition at cohort size ``world``:
    ``{"comm_s", "step_s", "comm_fraction", "blocking", "by_kind"}``.
    Payload per event is an even split of ``step_bytes`` (default: the
    table's per-step byte budget). Async submissions hide under
    compute up to the compute baseline; synchronous ones serialize.
    The table's ``fixed_s`` (per-step dispatch/launch cost the
    step-level calibration separated out) is on the critical path
    regardless — async overlap cannot hide under it."""
    n_ev = max(1, len(events))
    per_event = float(step_bytes or table.get("step_bytes")
                      or DEFAULT_TABLE["step_bytes"]) / n_ev
    serial = float(table.get("serial_fraction") or 1.0)
    compute_s = table.get("compute_s")
    fixed_s = float(table.get("fixed_s") or 0.0)
    sync_s, async_s = 0.0, 0.0
    blocking = 0
    by_kind = {}
    for ev in events:
        kind = canonical_kind(ev.kind)
        nbytes = 0.0 if kind == "barrier" else per_event
        t = collective_time(kind, nbytes, world, table) * serial
        by_kind[kind] = by_kind.get(kind, 0.0) + t
        if _is_async(ev):
            async_s += t
        else:
            sync_s += t
            blocking += 1
    if compute_s is None:
        comm_s = sync_s + async_s
        step_s = comm_s + fixed_s
        fraction = comm_s / step_s if step_s > 0.0 else 0.0
    else:
        hidden = min(async_s, float(compute_s))
        comm_s = sync_s + (async_s - hidden)
        step_s = float(compute_s) + comm_s + fixed_s
        fraction = comm_s / step_s if step_s > 0.0 else 0.0
    return {"comm_s": comm_s, "step_s": step_s,
            "comm_fraction": fraction, "blocking": blocking,
            "by_kind": by_kind}


def analyze_corpus(verifier, table=None, target_ranks=None):
    """Predicted scaling for every extracted schedule: per function,
    per probed cohort size — step time, comm fraction, straggler
    sensitivity (seconds of step growth per second of submit skew ×
    blocking collectives), and the bucket optimum at the largest
    target cohort."""
    table = table or resolve_table()
    ranks = list(target_ranks or target_ranks_from_env())
    rows = []
    for sched in extract_schedules(verifier):
        if not sched["events"]:
            continue
        curve = {n: predict_step(sched["events"], n, table)
                 for n in ranks}
        top_n = ranks[-1]
        dominating = max(curve[top_n]["by_kind"].items(),
                         key=lambda kv: kv[1])[0]
        rows.append({
            "function": sched["function"],
            "file": sched["file"],
            "line": sched["line"],
            "in_loop": sched["in_loop"],
            "collectives": len(sched["events"]),
            "curve": curve,
            "dominating": dominating,
            # every blocking collective waits out the slowest rank —
            # step growth per unit submit skew
            "straggler_sensitivity": curve[top_n]["blocking"],
            "bucket_optimum_bytes": bucket_optimum(
                table.get("step_bytes")
                or DEFAULT_TABLE["step_bytes"], top_n, table),
        })
    return {"table": {k: table.get(k) for k in ("source", "compute_s",
                                                "fixed_s", "step_bytes",
                                                "serial_fraction")},
            "target_ranks": ranks, "functions": rows}


def render_report(report):
    """Human-readable predicted-scaling block (``hvd-lint perf`` text
    output)."""
    if not report["functions"]:
        return ""
    lines = [f"predicted scaling (table: {report['table']['source']}, "
             f"n = {'/'.join(str(n) for n in report['target_ranks'])})"]
    for row in report["functions"]:
        loc = f"{row['file']}:{row['line']}"
        lines.append(f"  {row['function']}  [{loc}]  "
                     f"{row['collectives']} collective(s)/step, "
                     f"dominated by {row['dominating']}")
        for n in report["target_ranks"]:
            c = row["curve"][n]
            lines.append(
                f"    n={n:<5d} step {c['step_s'] * 1e3:8.3f} ms   "
                f"comm {c['comm_s'] * 1e3:8.3f} ms "
                f"({c['comm_fraction'] * 100.0:5.1f}%)   "
                f"{c['blocking']} blocking")
    return "\n".join(lines)


# -- HVD6xx rules -----------------------------------------------------------
def _parse_bytes_literal(value):
    """Bytes from a literal knob value: int, or '16 MiB'/'4m'/'65536'
    strings. None when unparseable."""
    if isinstance(value, bool):
        return None
    if isinstance(value, int):
        return value
    if not isinstance(value, str):
        return None
    text = value.strip().lower()
    mult = 1
    for suffix, m in (("gib", 1 << 30), ("gb", 1 << 30), ("g", 1 << 30),
                      ("mib", 1 << 20), ("mb", 1 << 20), ("m", 1 << 20),
                      ("kib", 1 << 10), ("kb", 1 << 10), ("k", 1 << 10),
                      ("b", 1)):
        if text.endswith(suffix):
            text = text[: -len(suffix)].strip()
            mult = m
            break
    try:
        return int(float(text) * mult)
    except ValueError:
        return None


def _env_subscript_name(node):
    """'HVDTPU_X' for ``os.environ["HVDTPU_X"]`` / ``environ[...]``."""
    if not isinstance(node, ast.Subscript):
        return None
    base = node.value
    is_environ = (isinstance(base, ast.Attribute)
                  and base.attr == "environ") \
        or (isinstance(base, ast.Name) and base.id == "environ")
    if not is_environ:
        return None
    key = node.slice
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        return key.value
    return None


def _literal_bucket_configs(mod):
    """(knob, bytes, line) for every literal bucket-knob write in one
    module: ``os.environ[K] = <const>`` and
    ``os.environ.setdefault(K, <const>)``. Computed values (e.g.
    ``str(256 * 1024)``) are invisible on purpose — the rule only
    speaks when it can read the number."""
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.value, ast.Constant):
            name = _env_subscript_name(node.targets[0])
            if name in _BUCKET_KNOBS:
                nbytes = _parse_bytes_literal(node.value.value)
                if nbytes:
                    out.append((name, nbytes, node.lineno))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "setdefault" \
                and isinstance(node.func.value, ast.Attribute) \
                and node.func.value.attr == "environ" \
                and len(node.args) == 2 \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[1], ast.Constant):
            name = node.args[0].value
            if name in _BUCKET_KNOBS:
                nbytes = _parse_bytes_literal(node.args[1].value)
                if nbytes:
                    out.append((name, nbytes, node.lineno))
    return out


_SYNC_PER_TENSOR = frozenset({"allreduce", "allreduce_"})
#: Distinct synchronous submit sites in one loop body before HVD602
#: calls it a serialization point (the unrolled per-layer shape).
_SYNC_SITE_THRESHOLD = 3


def _rule_601(verifier, table, ranks):
    diags = []
    top_n = ranks[-1]
    step_bytes = table.get("step_bytes") or DEFAULT_TABLE["step_bytes"]
    for mod in _entry_modules(verifier):
        if not any(fn.has_coll for fn in mod.funcs.values()):
            continue
        for knob, configured, line in _literal_bucket_configs(mod):
            kind = "reducescatter" if "ZERO" in knob else "allreduce"
            opt = bucket_optimum(step_bytes, top_n, table, kind=kind)
            ratio = max(configured / opt, opt / configured)
            if ratio < 2.0:
                continue
            diags.append(Diagnostic.make(
                "HVD601",
                f"{knob}={configured} is predicted ~{ratio:.1f}x away "
                f"from the model's bucket optimum (~{opt} bytes) at "
                f"n={top_n}: too-small buckets pay the per-collective "
                "latency once per bucket; too-large ones serialize the "
                "last bucket's drain behind compute",
                file=mod.path, line=line,
                hint="size buckets near sqrt(step_bytes * latency / "
                     "per_byte_cost) for the cohort you deploy at, or "
                     "let the autotuner sweep it; " + _DOC_HINT))
    return diags


def _rule_602(verifier):
    diags = []
    for mod in _entry_modules(verifier):
        for qual in sorted(mod.funcs):
            fn = mod.funcs[qual]
            top, loops = [], []
            _walk_program(fn.program, top, loops, None)
            for loop in loops:
                if not loop.events:
                    continue
                barriers = [e for e in loop.events
                            if canonical_kind(e.kind) == "barrier"]
                others = [e for e in loop.events
                          if canonical_kind(e.kind) != "barrier"]
                if barriers and others:
                    ev = barriers[0]
                    diags.append(Diagnostic.make(
                        "HVD602",
                        f"barrier inside the step loop of {qual} "
                        f"serializes {len(others)} co-resident "
                        "collective(s): every rank drains the full "
                        "negotiation round trip with zero overlap "
                        "opportunity, once per step",
                        file=mod.path, line=ev.line,
                        hint="drop the per-step barrier (collectives "
                             "already synchronize) or move it out of "
                             "the loop; " + _DOC_HINT))
                    continue
                sync_sites = sorted({
                    e.line for e in loop.events
                    if e.kind in _SYNC_PER_TENSOR
                    and not _is_async(e)})
                # Three distinct sites is the hand-unrolled per-layer
                # gradient shape; a couple of per-iteration scalar
                # metric reductions (epoch loss + val loss) are real
                # programs and stay clean.
                if len(sync_sites) >= _SYNC_SITE_THRESHOLD:
                    diags.append(Diagnostic.make(
                        "HVD602",
                        f"{len(sync_sites)} synchronous per-tensor "
                        f"allreduce call sites in one step loop of "
                        f"{qual} (lines "
                        f"{', '.join(str(s) for s in sync_sites)}): "
                        "each blocks before the next submits, so the "
                        "predicted critical path is their serial sum "
                        "at every cohort size",
                        file=mod.path, line=sync_sites[0],
                        hint="switch to allreduce_async + synchronize "
                             "(or grouped_allreduce) so transfers "
                             "pipeline; " + _DOC_HINT))
    return diags


def _rule_603(verifier, table, ranks):
    if table.get("compute_s") is None or len(ranks) < 2:
        # No calibrated compute baseline — a 50% comm fraction claim
        # would be fiction. The default table never fires this rule.
        return []
    diags = []
    for sched in extract_schedules(verifier):
        if not sched["events"] or not sched["in_loop"]:
            continue
        curve = [(n, predict_step(sched["events"], n, table))
                 for n in ranks]
        for (n_lo, lo), (n_hi, hi) in zip(curve, curve[1:]):
            if lo["comm_fraction"] < 0.5 <= hi["comm_fraction"]:
                dominating = max(hi["by_kind"].items(),
                                 key=lambda kv: kv[1])[0]
                diags.append(Diagnostic.make(
                    "HVD603",
                    f"predicted scale cliff in {sched['function']}: "
                    f"comm fraction crosses 50% between n={n_lo} "
                    f"({lo['comm_fraction'] * 100.0:.0f}%) and "
                    f"n={n_hi} ({hi['comm_fraction'] * 100.0:.0f}%), "
                    f"dominated by {dominating} — past that cohort "
                    "the step is communication-bound and more chips "
                    "stop buying speedup",
                    file=sched["file"], line=sched["line"],
                    hint="overlap or shrink the dominating "
                         "collective (async submits, compression, "
                         "larger per-rank batch), or cap deployment "
                         "below the cliff; " + _DOC_HINT))
                break
    return diags


def perf_diagnostics(verifier, table=None, target_ranks=None):
    """The HVD6xx stream over a (shared) Verifier corpus, suppression
    comments applied. Reuses the invocation's fixpoint — never re-runs
    it."""
    from .schedule import _suppress
    table = table or resolve_table()
    ranks = list(target_ranks or target_ranks_from_env())
    verifier.fixpoint()
    diags = (_rule_601(verifier, table, ranks)
             + _rule_602(verifier)
             + _rule_603(verifier, table, ranks))
    return dedupe(sorted(_suppress(diags, verifier.corpus),
                         key=Diagnostic.sort_key))


# -- autotuner warm-start priors --------------------------------------------
def _prior_cost(arm_name, candidate, world, table):
    """Predicted per-step cost of one candidate (lower probes first).
    Deliberately coarse — it only has to ORDER the sweep; measured
    scores still decide."""
    step_bytes = float(table.get("step_bytes")
                       or DEFAULT_TABLE["step_bytes"])
    if arm_name == "host":
        fusion, cycle_ms, _min_bucket = candidate
        fusion = max(1.0, float(fusion or 1))
        buckets = max(1.0, math.ceil(step_bytes / fusion))
        per = collective_time("allreduce", fusion, world, table)
        # each fused buffer waits out half a negotiation cycle on
        # average before it ships
        return buckets * (per + float(cycle_ms or 0.0) / 2e3)
    if arm_name in ("overlap", "zero"):
        kind = "reducescatter" if arm_name == "zero" else "allreduce"
        bucket = max(1.0, float(candidate))
        buckets = max(1.0, math.ceil(step_bytes / bucket))
        lat, bw = _terms(kind, world)
        alpha, byte_s = _coeff(table, kind)
        # (T/B)·latency overhead + un-overlappable last-bucket drain
        return buckets * alpha * lat + bucket * byte_s * bw
    if arm_name == "compression":
        codec, _threshold = candidate
        ratio = {"none": 1.0, "fp16": 0.5, "bf16": 0.5,
                 "int8": 0.25, "fp8": 0.25}.get(str(codec), 0.5)
        return collective_time("allreduce", step_bytes * ratio, world,
                               table)
    return 0.0


def predicted_cost(arm_name, candidate, world, table=None):
    """Public face of the per-candidate prior (autotune's ``predicted``
    store field): predicted per-step seconds for one arm candidate."""
    return _prior_cost(arm_name, candidate, max(2, int(world or 2)),
                       table or resolve_table())


def rank_candidates(arm_name, candidates, world, table=None):
    """Autotune warm-start prior: candidate indices ordered by
    predicted cost (ascending), ties broken by original grid order so
    the result is deterministic and identical on every rank."""
    table = table or resolve_table()
    world = max(2, int(world or 2))
    costs = [(_prior_cost(arm_name, cand, world, table), i)
             for i, cand in enumerate(candidates)]
    return [i for _, i in sorted(costs)]

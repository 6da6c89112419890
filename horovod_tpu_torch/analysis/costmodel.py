"""α–β collective cost model (port of ``horovod_tpu/analysis/costmodel.py``),
the parts the redistribution planner prices with and the autotuner's
warm-start prior (``HVDTPU_COSTMODEL``) orders its probes by.

``t = α·lat(kind, n) + B·byte_s·bw(kind, n)`` per collective: ring
allreduce 2(n−1) latency units and 2(n−1)/n bandwidth units, (n−1)-relay
allgather / reducescatter / alltoall, ⌈log₂n⌉ broadcast and barrier.
``canonical_kind`` folds the call-name spellings onto those kinds. The
cold-case table is the JAX package's (its coefficients rank candidates;
they are not an H100 measurement).

``load_table`` reads a table JSON as the JAX package writes it
(``HVDTPU_COSTMODEL_TABLE``). Not ported yet (ROADMAP item 15):
calibration from traces, ``save_table``, ``bucket_optimum``, step
prediction and the HVD6xx diagnostics.
"""

import json
import math

# Default per-kind coefficients: sub-µs per-hop latency, ~1e11 B/s per
# link — enough to rank candidates; calibration replaces them.
_DEF_ALPHA = 1e-6     # seconds per latency unit (per hop/round)
_DEF_BYTE_S = 1e-11   # seconds per byte per bandwidth unit (1/β)

MODEL_KINDS = ("allreduce", "allgather", "reducescatter", "broadcast",
               "alltoall", "barrier")

#: Cold-case table, the JAX package's ``DEFAULT_TABLE``.
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


def canonical_kind(kind):
    """Map a collective call name onto a model kind. Unknown names fall
    back to the ring-allreduce shape, the conservative default."""
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

"""α–β collective cost model (port of ``horovod_tpu/analysis/costmodel.py``),
the part the redistribution planner prices with.

``t = α·lat(kind, n) + B·byte_s·bw(kind, n)`` per collective: ring
allreduce 2(n−1) latency units and 2(n−1)/n bandwidth units, (n−1)-relay
allgather / reducescatter / alltoall, ⌈log₂n⌉ broadcast and barrier.
``canonical_kind`` folds the call-name spellings onto those kinds. The
cold-case table is the JAX package's (its coefficients rank candidates;
they are not an H100 measurement).

Not ported yet (ROADMAP item 15): calibration from traces, table IO,
``bucket_optimum``, step prediction and the HVD6xx diagnostics.
"""

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

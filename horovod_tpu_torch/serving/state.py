"""Train layout → inference layout: ``load_for_inference`` (port of
``horovod_tpu/serving/state.py``).

The serving plane consumes the same parameters ZeRO-1 training
produced, but in a different geometry: training's portable layout is
*flat bucket shards* — each of ``n`` train ranks owns contiguous
``shard_len`` slices of the padded fusion buckets ``ops.zero.plan_zero``
derived — while inference wants *per-leaf* tensors, replicated across
the serving cohort or row-sharded over ``serving_world`` hosts.

The transform is a source-spec × target-spec range program
(:func:`plan_inference_ranges`, on the port's redistribution planner) —
for every (serving host, leaf), the exact ``(bucket, src_rank,
src_offset, length)`` ranges that assemble it. A (host, leaf) pair whose
ranges all land in ONE source shard is **gather-free**: the leaf is a
copy out of a single rank's shard, no cross-rank assembly at all.

Two entry points, both device-resident (the JAX package returns host
numpy; the port keeps tensors where they are):

- :func:`load_from_shards` — from per-rank flat bucket shards (the
  checkpointed form), assembling each leaf by range copies on the
  shards' device;
- :func:`load_for_inference` — from a live tree of tensors (a module's
  ``state_dict()``, say): replicated leaves are the tensors themselves,
  ``rows`` leaves views of their row slices. No copy, no host trip.
"""

import torch

from ..utils import tree as _tree

REPLICATED = "replicated"
ROWS = "rows"


class _Range:
    """One copy instruction: ``length`` elements from
    ``shards[src_rank][bucket]`` at ``src_offset`` into the assembled
    leaf at ``dst_offset``."""

    __slots__ = ("bucket", "src_rank", "src_offset", "length",
                 "dst_offset")

    def __init__(self, bucket, src_rank, src_offset, length, dst_offset):
        self.bucket = bucket
        self.src_rank = src_rank
        self.src_offset = src_offset
        self.length = length
        self.dst_offset = dst_offset

    def __repr__(self):
        return (f"_Range(b{self.bucket} r{self.src_rank}"
                f"[{self.src_offset}:{self.src_offset + self.length}] "
                f"-> dst[{self.dst_offset}])")


def row_slice(dim0, world, host):
    """Contiguous near-even row range [lo, hi) of host ``host``."""
    dim0, world, host = int(dim0), int(world), int(host)
    return (dim0 * host) // world, (dim0 * (host + 1)) // world


def _check_layout(layout):
    if layout not in (REPLICATED, ROWS):
        raise ValueError(f"unknown inference layout {layout!r}")


def serving_spec(nleaves, serving_world, layout):
    """The inference layout as a planner Spec over axis ``s``:
    replicated, or near-even dim-0 rows over ``serving_world`` hosts."""
    from .. import resharding
    _check_layout(layout)
    if layout == ROWS:
        return resharding.Spec(
            {"s": int(serving_world)},
            [resharding.Sharded("s", 0, even=False)
             for _ in range(nleaves)])
    return resharding.replicated_spec(nleaves, {"s": int(serving_world)})


def plan_inference_ranges(plan, serving_world, layout=REPLICATED):
    """The redistribution program: ``ranges[host][leaf]`` = list of
    :class:`_Range`, plus ``gather_free[host][leaf]`` flags (True when
    the leaf assembles from a single source shard).

    A thin wrapper over the redistribution planner: source = the ZeRO
    flat-shard layout of ``plan``, destination = replicated or near-even
    dim-0 rows over ``serving_world`` hosts; the planner's copies —
    adjacent windows re-merged, since serving consumes whole ranges —
    are the ranges."""
    from .. import resharding
    serving_world = int(serving_world)
    if serving_world < 1:
        raise ValueError("serving_world must be >= 1")
    _check_layout(layout)
    meta = list(zip(plan.leaf_shapes, plan.leaf_dtypes))
    src = resharding.zero_flat_spec(plan, axis="z")
    dst = serving_spec(len(meta), serving_world, layout)
    program = resharding.plan_redistribution(src, dst, meta)
    per_host = [[[] for _ in meta] for _ in range(serving_world)]
    for step in program.steps:
        for c in step.copies:
            per_host[c.dst_rank][c.leaf].append(c)
    ranges, gather_free = [], []
    for host in range(serving_world):
        host_ranges, host_free = [], []
        for i in range(len(meta)):
            leaf_ranges = []
            for c in sorted(per_host[host][i],
                            key=lambda c: c.dst_off):
                k = c.src_buf[1]
                prev = leaf_ranges[-1] if leaf_ranges else None
                if prev is not None and prev.bucket == k \
                        and prev.src_rank == c.src_rank \
                        and prev.src_offset + prev.length \
                        == c.src_off \
                        and prev.dst_offset + prev.length \
                        == c.dst_off:
                    prev.length += c.length
                else:
                    leaf_ranges.append(_Range(k, c.src_rank,
                                              c.src_off, c.length,
                                              c.dst_off))
            host_ranges.append(leaf_ranges)
            host_free.append(len({rg.src_rank for rg in leaf_ranges})
                             <= 1)
        ranges.append(host_ranges)
        gather_free.append(host_free)
    return ranges, gather_free


def leaf_shape(shape, layout, serving_world, serving_rank):
    """A leaf's shape on serving host ``serving_rank``: its row slice
    under ``rows`` (leaves of rank 0 or with no rows stay whole)."""
    if layout == ROWS and len(shape) >= 1 and shape[0] >= 1:
        lo, hi = row_slice(shape[0], serving_world, serving_rank)
        return (hi - lo,) + tuple(shape[1:])
    return tuple(shape)


def _leaf_from_ranges(leaf_ranges, shards, dtype, device):
    total = sum(r.length for r in leaf_ranges)
    out = torch.empty((total,), dtype=dtype, device=device)
    for r in leaf_ranges:
        src = shards[r.src_rank][r.bucket].reshape(-1)
        out[r.dst_offset:r.dst_offset + r.length] = \
            src[r.src_offset:r.src_offset + r.length]
    return out


def load_from_shards(shards, plan, serving_world=1, serving_rank=0,
                     layout=REPLICATED, treedef=None):
    """Assemble THIS serving host's parameter leaves from per-rank flat
    bucket shards.

    ``shards``: mapping ``src_rank -> [per-bucket (shard_len,) tensors]``
    (only the ranks the range program touches need to be present — a
    gather-free host passes exactly one). Each leaf is assembled by range
    copies on the shards' device. Returns ``(leaves_or_tree, report)``;
    leaves are reshaped to the (possibly row-sliced) leaf shapes, and
    ``report['gather_free']`` lists the per-leaf flags. ``treedef``
    (``utils.tree.structure``) rebuilds the tree.
    """
    from ..resharding.spec import torch_dtype
    ranges, free = plan_inference_ranges(plan, serving_world, layout)
    host_ranges = ranges[int(serving_rank)]
    host_free = free[int(serving_rank)]
    device = next(iter(next(iter(shards.values())))).device \
        if shards else torch.device("cpu")
    leaves = []
    for i, (leaf_ranges, shape) in enumerate(
            zip(host_ranges, plan.leaf_shapes)):
        needed = {r.src_rank for r in leaf_ranges}
        missing = needed - set(shards)
        if missing:
            raise KeyError(
                f"leaf {i} needs source shard(s) from rank(s) "
                f"{sorted(missing)} which were not provided")
        flat = _leaf_from_ranges(leaf_ranges, shards,
                                 torch_dtype(plan.leaf_dtypes[i]), device)
        leaves.append(flat.reshape(leaf_shape(shape, layout, serving_world,
                                              serving_rank)))
    report = {
        "layout": layout,
        "serving_world": int(serving_world),
        "serving_rank": int(serving_rank),
        "gather_free": list(host_free),
        "gather_free_leaves": sum(bool(f) for f in host_free),
        "total_leaves": len(host_free),
    }
    if treedef is not None:
        return _tree.unflatten(treedef, leaves), report
    return leaves, report


def load_for_inference(params, serving_world=1, serving_rank=0,
                       layout=REPLICATED):
    """Transform a live (train-layout) tree of tensors — a module's
    ``state_dict()``, say — into this serving host's inference layout,
    on the tensors' own device.

    ``replicated``: every host gets the full tree, each leaf the tensor
    itself (detached). ``rows``: dim-0 contiguous row slices per host,
    each a view of its leaf — gather-free by construction, no copy, no
    collective. (The JAX package returns host numpy copies.)
    """
    _check_layout(layout)
    serving_world = int(serving_world)
    serving_rank = int(serving_rank)
    if not 0 <= serving_rank < serving_world:
        raise ValueError(
            f"serving_rank {serving_rank} outside world {serving_world}")

    def place(_, leaf):
        t = leaf.detach() if torch.is_tensor(leaf) else torch.as_tensor(leaf)
        if layout == ROWS and t.dim() >= 1 and t.shape[0] >= 1:
            lo, hi = row_slice(t.shape[0], serving_world, serving_rank)
            return t[lo:hi]
        return t

    return _tree.map_with_path(place, params)

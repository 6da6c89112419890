"""(mesh, layout) specs for the redistribution planner (port of
``horovod_tpu/resharding/spec.py``).

A :class:`Spec` names WHERE every element of a pytree lives: an ordered
set of mesh axes, a per-leaf tensor layout (:class:`Replicated` or
:class:`Sharded` along one tensor dimension over one mesh axis), and an
optional tree-wide :class:`ZeroFlat` stage — the ZeRO-1 pad-and-split
flat-bucket layout of ``ops.zero.ZeroPlan`` — over another mesh axis.
The two stages compose: a rank's ZeRO shard is a window of the packed
buckets built from its TENSOR-LOCAL leaf slices, which is exactly the
2D (data × tensor) geometry ``parallel/twod.py`` trains in.

The planner consumes specs through one question — *which global flat
elements of leaf ``i`` does rank ``r`` hold, and at what offset of
which local buffer?* — answered by :meth:`Spec.ownership` as a list of
:class:`Interval` runs. Everything else (program synthesis, chunking,
cost ranking) is interval arithmetic over those runs, the portable-
collectives formulation of arXiv:2112.01075.

Local buffers are keyed ``("leaf", i)`` (the rank's possibly-sliced
leaf, flattened) or ``("bucket", k)`` (the rank's ``shard_len`` window
of padded fusion bucket ``k``) — the same buffer identities the ZeRO
checkpoint form and the serving range programs already speak.

The ZeRO stage reads the port's own ``ops.zero.ZeroPlan``: for the same
leaves and ``n`` a spec's ``signature()`` equals the JAX package's.
Dtypes are numpy's spellings (``"float32"``, ``"bfloat16"``), as the
plan's signature writes them.
"""

import torch

from ..ops.zero import dtype_name
from ..utils import tree as _tree


class Replicated:
    """Every rank on the mesh holds the full leaf."""

    __slots__ = ()

    def signature(self):
        return {"kind": "replicated"}

    def __repr__(self):
        return "Replicated()"


class Sharded:
    """Leaf split along tensor dimension ``dim`` over mesh axis
    ``axis``. ``even=True`` (the jit/GSPMD contract of
    ``parallel.sharding._spec_fits``) requires the dimension to divide
    the axis size; ``even=False`` uses the serving plane's near-even
    contiguous ranges (``serving.state.row_slice``). Scalars and
    leaves whose rank does not reach ``dim`` degrade to replicated —
    the same rule the serving ROWS layout applies."""

    __slots__ = ("axis", "dim", "even")

    def __init__(self, axis, dim=0, even=True):
        self.axis = axis
        self.dim = int(dim)
        self.even = bool(even)

    def signature(self):
        return {"kind": "sharded", "axis": self.axis, "dim": self.dim,
                "even": self.even}

    def __repr__(self):
        return (f"Sharded(axis={self.axis!r}, dim={self.dim}, "
                f"even={self.even})")


class ZeroFlat:
    """Tree-wide ZeRO-1 flat-dense stage: the leaves (after the tensor
    stage) pack into ``plan``'s padded fusion buckets and mesh axis
    ``axis`` owns contiguous ``shard_len`` windows — the exact
    ``ops.zero.ZeroPlan`` geometry, so checkpointed train shards ARE
    this layout's local buffers."""

    __slots__ = ("axis", "plan")

    def __init__(self, axis, plan):
        self.axis = axis
        self.plan = plan

    def signature(self):
        return {"kind": "zero", "axis": self.axis,
                "plan": self.plan.signature()}

    def __repr__(self):
        return f"ZeroFlat(axis={self.axis!r}, n={self.plan.n})"


class Interval:
    """``length`` elements of a leaf's global flat space starting at
    ``g0``, held by some rank at offset ``b0`` of local buffer
    ``buf`` (``("leaf", i)`` or ``("bucket", k)``)."""

    __slots__ = ("g0", "length", "buf", "b0")

    def __init__(self, g0, length, buf, b0):
        self.g0 = g0
        self.length = length
        self.buf = buf
        self.b0 = b0

    def __repr__(self):
        return (f"Interval([{self.g0}:{self.g0 + self.length}) "
                f"@ {self.buf}+{self.b0})")


def torch_dtype(name):
    """The torch dtype of a numpy dtype name (``"bfloat16"`` included)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def leaf_offsets(plan):
    """leaf index -> (bucket index, flat offset inside the packed
    bucket buffer); packing order is the bucket's ``indices`` order
    (``ops.bucketing._pack``)."""
    out = {}
    for k, b in enumerate(plan.buckets):
        off = 0
        for i in b.indices:
            out[i] = (k, off)
            off += _prod(plan.leaf_shapes[i])
    return out


class Spec:
    """One side of a redistribution: mesh axes (ordered name -> size,
    ranks enumerate row-major over that order), per-leaf tensor
    layouts, and an optional tree-wide :class:`ZeroFlat` stage.
    ``pending_sum=True`` marks the held values as unreduced partial
    contributions — every holder of an element must be summed (the
    gradient case), which forces reduce-scatter legs in the planner.
    """

    __slots__ = ("mesh_axes", "leaves", "zero", "pending_sum")

    def __init__(self, mesh_axes, leaves, zero=None, pending_sum=False):
        self.mesh_axes = {str(k): int(v) for k, v in
                          dict(mesh_axes).items()}
        if any(v < 1 for v in self.mesh_axes.values()):
            raise ValueError(f"mesh axis sizes must be >= 1: "
                             f"{self.mesh_axes}")
        self.leaves = list(leaves)
        self.zero = zero
        self.pending_sum = bool(pending_sum)
        if zero is not None and zero.axis not in self.mesh_axes:
            raise ValueError(f"zero stage axis {zero.axis!r} not in "
                             f"mesh axes {list(self.mesh_axes)}")
        for lay in self.leaves:
            if isinstance(lay, Sharded) \
                    and lay.axis not in self.mesh_axes:
                raise ValueError(f"sharded axis {lay.axis!r} not in "
                                 f"mesh axes {list(self.mesh_axes)}")

    # -- rank geometry -----------------------------------------------------
    @property
    def world(self):
        return _prod(self.mesh_axes.values())

    def coords(self, rank):
        """Row-major coordinates of ``rank`` over the axis order."""
        out, rem = {}, int(rank)
        for name in reversed(list(self.mesh_axes)):
            size = self.mesh_axes[name]
            out[name] = rem % size
            rem //= size
        return out

    def mesh_signature(self):
        return [[name, size] for name, size in self.mesh_axes.items()]

    def signature(self):
        return {
            "mesh": self.mesh_signature(),
            "leaves": [lay.signature() for lay in self.leaves],
            "zero": None if self.zero is None
            else self.zero.signature(),
            "pending_sum": self.pending_sum,
        }

    # -- validation --------------------------------------------------------
    def validate(self, tree_meta):
        if len(self.leaves) != len(tree_meta):
            raise ValueError(
                f"spec has {len(self.leaves)} leaf layouts for "
                f"{len(tree_meta)} tree leaves")
        for i, (shape, _) in enumerate(tree_meta):
            lay = self.leaves[i]
            if isinstance(lay, Sharded) and lay.even \
                    and lay.dim < len(shape) and shape[lay.dim] >= 1:
                nt = self.mesh_axes[lay.axis]
                if shape[lay.dim] % nt:
                    raise ValueError(
                        f"leaf {i} shape {shape} dim {lay.dim} does "
                        f"not divide mesh axis {lay.axis!r}={nt} "
                        f"(even sharding); use even=False for "
                        "near-even ranges")
        if self.zero is not None:
            plan = self.zero.plan
            if plan.n != self.mesh_axes[self.zero.axis]:
                raise ValueError(
                    f"zero plan n={plan.n} != mesh axis "
                    f"{self.zero.axis!r}="
                    f"{self.mesh_axes[self.zero.axis]}")
            local = [self.local_shape(i, shape, 0)
                     for i, (shape, _) in enumerate(tree_meta)]
            if [tuple(s) for s in local] \
                    != [tuple(s) for s in plan.leaf_shapes]:
                raise ValueError(
                    "zero plan leaf shapes do not match the spec's "
                    f"tensor-local shapes: plan={plan.leaf_shapes} "
                    f"vs local={local}")

    # -- tensor stage ------------------------------------------------------
    def _dim_slice(self, lay, extent, rank):
        nt = self.mesh_axes[lay.axis]
        t = self.coords(rank)[lay.axis]
        if lay.even:
            step = extent // nt
            return t * step, (t + 1) * step
        return (extent * t) // nt, (extent * (t + 1)) // nt

    def local_shape(self, i, shape, rank):
        """The rank's tensor-local leaf shape (what the zero stage
        packs; equal across ranks for even sharding)."""
        lay = self.leaves[i]
        if not isinstance(lay, Sharded) or lay.dim >= len(shape) \
                or shape[lay.dim] < 1:
            return tuple(shape)
        lo, hi = self._dim_slice(lay, shape[lay.dim], rank)
        out = list(shape)
        out[lay.dim] = hi - lo
        return tuple(out)

    def _tensor_runs(self, i, shape, rank):
        """Merged runs ``(g0, l0, length)`` mapping the rank's tensor-
        local flat space (offset ``l0``) onto the leaf's global flat
        space (offset ``g0``)."""
        size = _prod(shape)
        if size == 0:
            return []
        lay = self.leaves[i]
        if not isinstance(lay, Sharded) or lay.dim >= len(shape) \
                or shape[lay.dim] < 1:
            return [(0, 0, size)]
        lo, hi = self._dim_slice(lay, shape[lay.dim], rank)
        if hi <= lo:
            return []
        if (lo, hi) == (0, shape[lay.dim]):
            return [(0, 0, size)]
        inner = _prod(shape[lay.dim + 1:])
        outer = _prod(shape[:lay.dim])
        run = (hi - lo) * inner
        stride = shape[lay.dim] * inner
        return [(o * stride + lo * inner, o * run, run)
                for o in range(outer)]

    # -- ownership ---------------------------------------------------------
    def ownership(self, tree_meta, rank):
        """Per leaf: the :class:`Interval` runs rank ``rank`` holds."""
        out = []
        if self.zero is None:
            for i, (shape, _) in enumerate(tree_meta):
                out.append([Interval(g0, ln, ("leaf", i), l0)
                            for g0, l0, ln
                            in self._tensor_runs(i, shape, rank)])
            return out
        plan = self.zero.plan
        offsets = leaf_offsets(plan)
        d = self.coords(rank)[self.zero.axis]
        for i, (shape, _) in enumerate(tree_meta):
            runs = self._tensor_runs(i, shape, rank)
            k, off = offsets[i]
            sl = plan.shards[k].shard_len
            lo_sh, hi_sh = d * sl, (d + 1) * sl
            local_size = sum(r[2] for r in runs)
            a, b = max(off, lo_sh), min(off + local_size, hi_sh)
            ivs = []
            if a < b:
                tl_a, tl_b = a - off, b - off
                for g0, l0, ln in runs:
                    s, e = max(tl_a, l0), min(tl_b, l0 + ln)
                    if s < e:
                        ivs.append(Interval(
                            g0 + (s - l0), e - s, ("bucket", k),
                            off + s - lo_sh))
            out.append(ivs)
        return out

    def local_buffers(self, tree_meta, rank):
        """Ordered ``buf_key -> (n_elements, dtype_str)`` of the
        rank's local buffers under this spec."""
        out = {}
        if self.zero is not None:
            plan = self.zero.plan
            for k, (b, s) in enumerate(zip(plan.buckets, plan.shards)):
                out[("bucket", k)] = (s.shard_len, dtype_name(b.dtype))
            return out
        for i, (shape, dtype) in enumerate(tree_meta):
            n = sum(r[2] for r in self._tensor_runs(i, shape, rank))
            if n:
                out[("leaf", i)] = (n, str(dtype))
        return out


def tree_meta_of(tree):
    """``[(shape, dtype), ...]`` for a tree (``utils.tree``: dicts in
    sorted-key order) of torch tensors, numpy arrays or anything with
    ``shape`` and ``dtype`` — the planner's view of the tree."""
    out = []
    for leaf in _tree.leaves(tree):
        dt = leaf.dtype
        out.append((tuple(int(d) for d in leaf.shape),
                    dtype_name(dt) if isinstance(dt, torch.dtype)
                    else str(dt)))
    return out


def zero_flat_spec(plan, axis="hvd", extra_axes=None):
    """The ZeRO-1 train layout as a Spec: flat bucket shards of
    ``plan`` over ``axis`` (tensor stage replicated)."""
    mesh = dict(extra_axes or {})
    mesh[axis] = plan.n
    return Spec(mesh, [Replicated() for _ in plan.leaf_shapes],
                zero=ZeroFlat(axis, plan))


def replicated_spec(nleaves, mesh_axes):
    """Fully-replicated layout over ``mesh_axes``."""
    return Spec(mesh_axes, [Replicated() for _ in range(nleaves)])

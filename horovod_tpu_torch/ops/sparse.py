"""Sparse/embedding gradient plane (port of ``horovod_tpu/ops/sparse.py``).

Embedding gradients touch a small fraction of a table's rows per step.
Reducing them dense pays the whole table on the wire; gathering the
(indices, values) slices pays per-row bytes that grow with the number of
ranks. Per rank (PAPERS.md 1905.04035):

    dense  (ring allreduce)   ~ 2 * R * W * b_v           bytes
    gather (allgather-v)      ~ (n-1) * nnz * (W*b_v + b_i) bytes

with R table rows, W row width, b_v value bytes, b_i index bytes and nnz
locally touched (deduplicated) rows. Gather wins while the row density
d = nnz/R stays under

    d* = theta * 2*W*b_v / ((n-1) * (W*b_v + b_i))

``HVDTPU_SPARSE`` selects the path per tensor::

    HVDTPU_SPARSE=auto                       # measured density vs d*
    HVDTPU_SPARSE=gather                     # always allgather the slices
    HVDTPU_SPARSE='embed*=gather;dense'      # glob rules, first wins

``auto`` smooths the density with a per-name EMA (``HVDTPU_SPARSE_EMA``);
``HVDTPU_SPARSE_THRESHOLD`` is theta.

Disabled contract: with ``HVDTPU_SPARSE`` unset :func:`make_plane` returns
None and every sparse gradient densifies into the dense allreduce path,
bit-identically.

With a ``HVDTPU_COMPRESSION`` rule selecting int8 for a gather-path name
in a set of more than one rank, its values travel row-quantized (one
float32 scale per row); indices are always exact. The gather path is the
plain allgathers of the slices, so every data plane runs it.
"""

import fnmatch
import re

import numpy as np
import torch

from ..analysis import sanitizer
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger
from . import reduce_ops

DEFAULT_THRESHOLD = 1.0   # theta: scales the crossover density
DEFAULT_EMA = 0.8         # history weight of the per-name density EMA
_MODES = ("auto", "gather", "dense")
# The one wire codec the gather path carries on values (row-quantized).
_WIRE_CODECS = ("int8",)


# ==========================================================================
# SparseGradient: (indices, values, dense_shape)
# ==========================================================================

class SparseGradient:
    """Row-sparse gradient: ``values[k]`` is the gradient of row
    ``indices[k]`` of a ``dense_shape`` parameter (TF's IndexedSlices; a
    torch COO tensor with one sparse dim, which :meth:`from_coo` views)."""

    __slots__ = ("indices", "values", "dense_shape")

    def __init__(self, indices, values, dense_shape):
        self.indices = indices
        self.values = values
        self.dense_shape = tuple(int(s) for s in dense_shape)

    @classmethod
    def from_coo(cls, tensor):
        """The coalesced rows of a COO tensor with one sparse dim
        (``nn.Embedding(sparse=True)``'s gradient)."""
        t = tensor.coalesce()
        if t.sparse_dim() != 1:
            raise ValueError(
                f"SparseGradient views a COO tensor with one sparse dim, "
                f"got {t.sparse_dim()}")
        return cls(t.indices()[0], t.values(), t.shape)

    def to_coo(self):
        return torch.sparse_coo_tensor(self.indices.reshape(1, -1),
                                       self.values, self.dense_shape)

    @property
    def nnz(self):
        return int(self.indices.shape[0])

    def densify(self):
        """Scatter-add into the dense shape (duplicate indices
        accumulate)."""
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.indices.to(out.device), self.values)

    def deduplicate(self):
        """Sorted unique indices, duplicate rows summed."""
        t = self.to_coo().coalesce()
        return SparseGradient(t.indices()[0].to(self.indices.dtype),
                              t.values(), self.dense_shape)

    def __repr__(self):
        return (f"SparseGradient(nnz={self.nnz}, "
                f"dense_shape={self.dense_shape})")


def is_sparse(x):
    return isinstance(x, SparseGradient)


# ==========================================================================
# Row-wise int8 wire codec (values only; indices are always exact)
# ==========================================================================

def encode_rows(values):
    """Symmetric per-row int8: one float32 scale per row (scale =
    max|row|/127, round-trip error <= max|row|/254). Per row, not per
    256-block, because gathered slices are ragged across ranks."""
    v = values.to(torch.float32).reshape(values.shape[0], -1)
    maxabs = v.abs().amax(dim=1) if v.shape[1] else \
        torch.zeros(v.shape[0], device=v.device)
    scales = torch.where(maxabs > 0, maxabs / 127.0,
                         torch.ones_like(maxabs))
    q = torch.round(v / scales[:, None]).clamp_(-127, 127).to(torch.int8)
    return q.reshape(values.shape), scales


def decode_rows(q, scales, dtype):
    qf = q.to(torch.float32).reshape(q.shape[0], -1)
    out = qf * scales.to(torch.float32)[:, None]
    return out.reshape(q.shape).to(dtype)


# ==========================================================================
# Policy: the HVDTPU_SPARSE grammar, the crossover and the per-name EMA
# ==========================================================================

def crossover_density(world, row_bytes, index_bytes, threshold):
    """Density below which gathering the slices beats densify-then-
    allreduce; inf at ``world <= 1`` (no wire either way)."""
    if world <= 1:
        return float("inf")
    return (threshold * 2.0 * row_bytes
            / ((world - 1) * (row_bytes + index_bytes)))


def parse_rules(spec):
    """``spec`` -> [(glob, mode)]; malformed specs raise."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            glob, _, mode = part.partition("=")
            glob, mode = glob.strip(), mode.strip()
            if not glob or not mode:
                raise ValueError(
                    f"malformed HVDTPU_SPARSE rule {part!r}: expected "
                    "'<name-glob>=<gather|dense|auto>'")
        else:
            glob, mode = "*", part
        if mode not in _MODES:
            raise ValueError(
                f"unknown HVDTPU_SPARSE mode {mode!r} in rule {part!r} "
                f"(expected one of {', '.join(_MODES)})")
        rules.append((glob, mode))
    return rules


class SparsePolicy:
    """Per-tensor path selection: explicit rules win; ``auto`` compares
    the smoothed measured density with the crossover."""

    def __init__(self, rules, threshold=DEFAULT_THRESHOLD, ema=DEFAULT_EMA):
        self.rules = list(rules)
        self.threshold = float(threshold)
        if not (self.threshold > 0.0 and np.isfinite(self.threshold)):
            raise ValueError(
                "HVDTPU_SPARSE_THRESHOLD must be a positive finite "
                f"number, got {threshold}")
        if not 0.0 <= float(ema) < 1.0:
            raise ValueError(
                f"HVDTPU_SPARSE_EMA must be in [0, 1), got {ema}")
        self.ema = float(ema)

    @classmethod
    def from_env(cls):
        return cls(parse_rules(envparse.get_str(envparse.SPARSE, "")),
                   threshold=envparse.get_float(envparse.SPARSE_THRESHOLD,
                                                DEFAULT_THRESHOLD),
                   ema=envparse.get_float(envparse.SPARSE_EMA, DEFAULT_EMA))

    def mode_for_name(self, name):
        for glob, mode in self.rules:
            if fnmatch.fnmatchcase(name or "", glob):
                return mode
        return "dense"


_AUTO_OCCURRENCE = re.compile(r"#\d+$")


def _ema_key(name):
    """Density-state key of a name: an auto name's '#count' occurrence
    suffix is dropped (density belongs to the call site)."""
    if name and ".auto." in name:
        return _AUTO_OCCURRENCE.sub("", name)
    return name


class SparsePlane:
    """Policy, per-name density EMA and metrics of one coordinator
    (rebuilt at every ``init()``: EMA state never crosses cohorts)."""

    def __init__(self, pol):
        self.policy = pol
        self._lock = sanitizer.make_lock("sparse.plane")
        self._ema = {}
        self.path_counts = {"gather": 0, "dense": 0}
        self._log = get_logger()
        self._metrics_on = telemetry.enabled()
        self._m_density = telemetry.gauge(
            "hvd_sparse_density",
            "EMA-smoothed nnz-rows/total-rows of a sparse gradient",
            labelnames=("name",))
        self._m_path = telemetry.counter(
            "hvd_sparse_path_total", "Sparse-allreduce path decisions",
            labelnames=("path",))
        self._m_saved = telemetry.counter(
            "hvd_sparse_bytes_saved_total",
            "Wire bytes kept off the fabric by gather-path sparse "
            "collectives vs the densified allreduce")
        self._wire_policy = None
        if envparse.get_str(envparse.COMPRESSION, ""):
            from ..compression.policy import CompressionPolicy
            self._wire_policy = CompressionPolicy.from_env()

    def select(self, name, nnz_rows, total_rows, row_bytes, index_bytes,
               world, smooth=True):
        """gather or dense for one submission (``nnz_rows`` after dedup);
        explicit rules skip the EMA."""
        mode = self.policy.mode_for_name(name)
        if mode == "auto":
            observed = nnz_rows / max(1, total_rows)
            if smooth:
                key = _ema_key(name)
                with self._lock:
                    prev = self._ema.get(key)
                    smoothed = (observed if prev is None else
                                self.policy.ema * prev
                                + (1.0 - self.policy.ema) * observed)
                    self._ema[key] = smoothed
                if self._metrics_on and key:
                    self._m_density.labels(name=key).set(smoothed)
            else:
                smoothed = observed
            path = ("gather" if smoothed < crossover_density(
                world, row_bytes, index_bytes, self.policy.threshold)
                else "dense")
        else:
            path = mode
        with self._lock:
            self.path_counts[path] += 1
        self._m_path.labels(path=path).inc()
        return path

    def density(self, name):
        """The EMA of a name (None before its first auto observation)."""
        with self._lock:
            return self._ema.get(_ema_key(name))

    def wire_codec_for(self, name, values_dtype):
        """int8 when the HVDTPU_COMPRESSION policy selects a wire codec for
        this name's values; indices never compress."""
        if self._wire_policy is None or not values_dtype.is_floating_point:
            return None
        codec_name = self._wire_policy.codec_for_name(name)
        return codec_name if codec_name in _WIRE_CODECS else None

    def record_gather(self, dense_wire_bytes, gather_wire_bytes):
        if self._metrics_on:
            self._m_saved.inc(max(0, int(dense_wire_bytes)
                                  - int(gather_wire_bytes)))


def make_plane():
    """A SparsePlane when ``HVDTPU_SPARSE`` is set; None otherwise."""
    spec = envparse.get_str(envparse.SPARSE, "")
    if not spec:
        return None
    return SparsePlane(SparsePolicy.from_env())


def _plane():
    """The live coordinator's sparse plane (None when off or before
    init)."""
    from .. import basics
    if not basics.is_initialized():
        return None
    return basics.runtime().coordinator._sparse


def enabled():
    return _plane() is not None


# ==========================================================================
# sparse_allreduce
# ==========================================================================

class SparseMeta:
    """What the reduction of a gather-path entry needs beyond the gathered
    tensors."""

    __slots__ = ("dense_shape", "index_dtype", "values_dtype", "codec")

    def __init__(self, dense_shape, index_dtype, values_dtype, codec=None):
        self.dense_shape = tuple(int(s) for s in dense_shape)
        self.index_dtype = index_dtype
        self.values_dtype = values_dtype
        self.codec = codec


def _validate_op(op, name):
    if op not in (reduce_ops.Sum, reduce_ops.Average):
        raise ValueError(
            f"sparse_allreduce {name!r} supports Sum/Average only, got "
            f"{reduce_ops.op_name(op)}: Adasum needs exact per-tensor dot "
            "products of dense gradients, and Min/Max/Product have no "
            "scatter-add formulation")


def _cohort_nnz(name, nnz, process_set):
    """The largest local nnz of the set, so that every rank feeds the
    ``auto`` decision the same density (a split decision would pair a
    gather on some ranks with a dense allreduce on others and stall)."""
    from . import collectives as _c
    out = _c.allreduce(torch.tensor([nnz], dtype=torch.int64),
                       name=f"{name}.nnz", op=reduce_ops.Max,
                       process_set=process_set)
    return int(out.reshape(-1)[0])


def choose_path(plane, name, nnz, dense_shape, values_itemsize,
                index_itemsize, process_set):
    """``gather`` or ``dense`` for one submission of ``name`` with ``nnz``
    local (deduplicated) rows; under ``auto`` every rank of a multi-rank
    set decides on the set's largest nnz."""
    nset = len(process_set.ranks)
    if nset > 1 and plane.policy.mode_for_name(name) == "auto":
        nnz = _cohort_nnz(name, nnz, process_set)
    return plane.select(name, nnz, dense_shape[0],
                        row_elems(dense_shape) * values_itemsize,
                        index_itemsize, nset)


def gather_async(name, parts, process_set, combine):
    """Allgather each ``(suffix, tensor)`` of ``parts`` as
    ``name.suffix`` (ragged first dims: every plane negotiates per-rank
    row counts); the handle resolves to ``combine(gathered tensors)``."""
    from . import collectives as _c
    handles = [_c.allgather_async(t.contiguous(), name=f"{name}.{sfx}",
                                  process_set=process_set)
               for sfx, t in parts]
    return _c.then_all(handles, lambda *gathered: combine(list(gathered)))


def sparse_allreduce_async(sparse, average=None, name=None, op=None,
                           process_set=None):
    """Async allreduce of this rank's :class:`SparseGradient` (or a COO
    tensor with one sparse dim); the handle resolves to the dense reduced
    tensor, every rank's rows scatter-added (divided by the set's size for
    Average). The path comes from the ``HVDTPU_SPARSE`` policy; with the
    knob unset, or a dense decision, the gradient densifies into the dense
    allreduce path. The gather path is the plain allgathers of the slices
    (:func:`gather_async`), so every data plane runs it; the int8 row codec
    applies only where there is a wire (a set of more than one rank)."""
    from . import collectives as _c
    from ..process_sets import global_process_set

    if process_set is None:
        process_set = global_process_set
    op = reduce_ops.handle_average_backwards_compatibility(op, average)
    name = name or _c._auto_name("sparse_allreduce")
    _validate_op(op, name)
    if isinstance(sparse, torch.Tensor) and sparse.is_sparse:
        sparse = SparseGradient.from_coo(sparse)
    if not is_sparse(sparse):
        raise ValueError(
            f"sparse_allreduce {name!r} takes this rank's SparseGradient "
            "or a COO tensor")
    nset = len(process_set.ranks)
    plane = _plane()
    if plane is None:
        path = "dense"
    else:
        if plane.policy.mode_for_name(name) != "dense":
            sparse = sparse.deduplicate()
        path = choose_path(plane, name, sparse.nnz, sparse.dense_shape,
                           sparse.values.element_size(),
                           sparse.indices.element_size(), process_set)
    if path == "dense":
        return _c.allreduce_async(sparse.densify(), name=name, op=op,
                                  process_set=process_set)
    codec = (plane.wire_codec_for(name, sparse.values.dtype) if nset > 1
             else None)
    meta = SparseMeta(sparse.dense_shape, sparse.indices.dtype,
                      sparse.values.dtype, codec=codec)

    def reduce(gathered):
        if nset > 1:
            _record_gather(plane, meta, gathered[0].shape[0], nset)
        return reduce_gathered(meta, gathered, nset, op)
    return gather_async(name, gather_tensors(sparse.indices, sparse.values,
                                             codec),
                        process_set, reduce)


def sparse_allreduce(sparse, average=None, name=None, op=None,
                     process_set=None):
    """Blocking :func:`sparse_allreduce_async`."""
    from . import collectives as _c
    return _c.synchronize(sparse_allreduce_async(
        sparse, average=average, name=name, op=op, process_set=process_set))


# ==========================================================================
# Execution helpers of the gather path
# ==========================================================================

def scatter_add_dense(indices, values, dense_shape, world, op, dtype=None):
    """Gathered (indices, values) -> the dense reduction: scatter-add
    (duplicates across ranks accumulate), then / world for Average."""
    vals = values if dtype is None else values.to(dtype)
    out = torch.zeros(dense_shape, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, indices.to(device=vals.device, dtype=torch.int64),
                   vals.reshape((-1,) + tuple(dense_shape[1:])))
    if op == reduce_ops.Average:
        out = (out / world).to(vals.dtype)
    return out


def row_elems(dense_shape):
    """Elements per row (the product of the trailing dims)."""
    return int(np.prod(dense_shape[1:])) if len(dense_shape) > 1 else 1


def gather_wire_bytes(nnz_total, row_elems, values_itemsize, index_itemsize,
                      world, codec=None):
    """Model wire bytes per rank of the gather path: every rank receives
    the other ranks' slices ((n-1)/n of the gathered total); with the int8
    row codec values carry 1 byte per element and one float32 scale per
    row."""
    if codec == "int8":
        per_row = row_elems + 4 + index_itemsize
    else:
        per_row = row_elems * values_itemsize + index_itemsize
    frac = (world - 1) / world if world > 1 else 0.0
    return int(nnz_total * per_row * frac)


def dense_wire_bytes(dense_shape, values_itemsize):
    """Model wire bytes per rank of the densified ring allreduce (about
    twice the payload: reduce-scatter and allgather legs)."""
    return int(2 * int(np.prod(dense_shape)) * values_itemsize)


def gather_tensors(idx, vals, codec):
    """(name suffix, tensor) of each allgather of a gather-path entry:
    indices and values, or indices, int8 rows and row scales under the
    int8 row codec."""
    if codec == "int8":
        q, s = encode_rows(vals)
        return [("idx", idx), ("q", q), ("s", s)]
    return [("idx", idx), ("val", vals)]


def _record_gather(plane, meta, nnz_total, n):
    """Bytes-saved accounting of one gather-path entry, from the exact
    gathered row count."""
    val_isize = torch.empty((), dtype=meta.values_dtype).element_size()
    idx_isize = torch.empty((), dtype=meta.index_dtype).element_size()
    plane.record_gather(
        dense_wire_bytes(meta.dense_shape, val_isize),
        gather_wire_bytes(int(nnz_total), row_elems(meta.dense_shape),
                          val_isize, idx_isize, n, codec=meta.codec))


def reduce_gathered(meta, gathered, world, op):
    """The dense reduction of the gathered tensors of a gather-path entry
    (``gather_tensors``'s order, concatenated over ranks)."""
    tail = tuple(meta.dense_shape[1:])
    idx = gathered[0].reshape(-1)
    if meta.codec == "int8":
        vals = decode_rows(gathered[1].reshape((-1,) + tail),
                           gathered[2].reshape(-1), meta.values_dtype)
    else:
        vals = gathered[1].reshape((-1,) + tail)
    return scatter_add_dense(idx, vals, meta.dense_shape, world, op,
                             dtype=meta.values_dtype)


# ==========================================================================
# ZeRO composition: embedding optimizer state sharded by row range
# ==========================================================================

def plan_row_shards(nrows, world):
    """Contiguous near-even row ranges, one per rank: ``[(lo, hi), ...]``
    (earlier ranks take the remainder, the reducescatter convention).
    Deterministic in (nrows, world)."""
    base, rem = divmod(int(nrows), int(world))
    bounds, start = [], 0
    for r in range(world):
        end = start + base + (1 if r < rem else 0)
        bounds.append((start, end))
        start = end
    return bounds


def rowsharded_update(update, gathered, param_shard, state_shard, lo, hi):
    """Apply the gathered sparse gradient to THIS rank's row range
    ``[lo, hi)`` of an embedding table whose optimizer state lives
    row-sharded (1/n per rank). ``gathered`` is the allgathered
    :class:`SparseGradient` of every rank; rows outside the range belong to
    other shards and are dropped here, and only the touched local rows
    step (untouched rows keep their state, like torch's SparseAdam).

    ``update(grad_rows, state_rows, param_rows) -> (updates,
    new_state_rows)`` is the elementwise optimizer (optax's ``update``
    contract, as a function: torch has no optax); ``state_shard`` maps
    names to tensors whose first dim is the shard's rows, or to scalars,
    which it receives as they are. Returns ``(new_param_shard,
    new_state_shard)``; the inputs are left alone."""
    # Cross-rank dedup: a row touched by several ranks appears once per
    # toucher in the gathered set; the write-back below would keep only
    # the last duplicate's update without the segment sum.
    gathered = gathered.deduplicate()
    idx = gathered.indices.to(param_shard.device)
    mask = (idx >= lo) & (idx < hi)
    local_idx = idx[mask] - lo
    local_vals = gathered.values.to(param_shard.device)[mask]
    if int(local_idx.shape[0]) == 0:
        return param_shard, state_shard
    rows_of = param_shard.shape[0]

    def is_rows(v):
        return torch.is_tensor(v) and v.dim() and v.shape[0] == rows_of

    rows = param_shard[local_idx]
    row_state = {k: v[local_idx] if is_rows(v) else v
                 for k, v in state_shard.items()}
    updates, new_row_state = update(local_vals, row_state, rows)
    new_param = param_shard.index_put((local_idx,), rows + updates)
    new_state = {k: (v.index_put((local_idx,), new_row_state[k])
                     if is_rows(v) else new_row_state[k])
                 for k, v in state_shard.items()}
    return new_param, new_state

"""ZeRO-1: the cross-replica sharded weight update (port of
``horovod_tpu/ops/zero.py``; ``HVDTPU_ZERO``; arXiv:2004.13336).

In the replicated update every rank holds the whole optimizer state and
computes the whole update. Here the gradient reduction lands each rank only
its 1/n slice (a reduce-scatter), the optimizer steps that slice with 1/n of
the state, and the updated slices are gathered back (an allgather). The two
legs move the bytes of one allreduce.

The JAX package runs this inside ``shard_map`` over a mesh axis. The port
runs one process per GPU, and its way to span GPUs is the process group
behind the coordinator, so that group plays the mesh axis: ``psum_scatter``
becomes a named reducescatter, ``all_gather`` a named allgather and
``all_to_all`` a named alltoall. In a launcher job the native core
negotiates every leg and NCCL (gloo, the TCP ring on the CPU) moves the
bytes.

- **The plan** (:func:`plan_zero`): the leaves go into fusion buckets
  (``ops/bucketing.py``, reversed leaf order); each bucket is padded to a
  multiple of n × block and split into n equal shards. Every rank that
  agrees on the leaf shapes, the world size, the budget and the block
  derives the same plan, and ``ZeroPlan.signature()`` equals the JAX
  package's.
- **The state is born sharded.** :meth:`ZeroRuntime.init_state` copies this
  rank's slice of each bucket's parameters into a persistent ``(shard_len,)``
  tensor and builds a fresh instance of the wrapped optimizer's class over
  those tensors (the inner optimizer). The wrapped optimizer never steps, so
  it never gets state. Its hyperparameters are copied into the inner one at
  every step, so that an ``lr_scheduler`` attached to it keeps working.
- **Elementwise state only.** Sharding a flat vector is sound only where
  every state tensor mirrors its parameter. A probe step of the optimizer's
  class on small tensors, one of each parameter rank, checks it before the
  plan is used (``torch.optim.Adafactor`` keeps factored row and column
  statistics for a matrix and is refused), and so does a look at the inner
  optimizer's state after its first step.
- **The legs** (:meth:`ZeroRuntime._run`). The native core fuses
  allreduces only, and each response costs the delegated plane host time
  (124 buckets of the flagship TransformerLM cost 248 responses a step), so
  the legs fuse the buckets themselves: consecutive buckets of one dtype
  form a chunk under the fusion threshold (:func:`plan_chunks`,
  ``HVDTPU_FUSION_THRESHOLD``), laid out rank-major, so that one
  collective moves the shards of all its buckets. All chunks of a step are
  submitted as one grouped reducescatter (``zero.rs.<c>``) before the
  first wait, the inner optimizer steps every shard, and one grouped
  allgather (``zero.ag.<c>``) brings the new parameters back into the
  model's parameters in place. ``Compression.fp16``/``bf16`` ride both
  legs in the narrow dtype. ``int8``/``fp8`` follow EQuARX: each chunk's
  ``(n, width)`` rows are encoded (a block never spans two buckets), the
  payload and the scales cross in an alltoall each (``zero.rs.<c>.q``,
  ``.s``), the decoded rows are summed in float32, the update is
  requantized and allgathered (``zero.ag.<c>.q``, ``.s``) and decoded;
  the error-feedback residuals (per chunk: its buckets' side by side) are
  part of the sharded state. A CUDA alltoall is staged through pinned host
  memory by the NCCL plane. At the first step of a multi-rank job a tiny
  reduce-scatter whose width is a digest of the plan (``zero.rs.plan``)
  makes ranks with different plans fail in the negotiation, when the
  consistency check is off; with ``HVDTPU_CONSISTENCY_CHECK`` on,
  :meth:`ZeroRuntime.verify_plan_consistency` compares every rank's leg
  digests through the guardian's board at ``init_state`` instead and names
  the divergent rank and field.

Numerics: with no codec the sharded update is bit-identical to the
replicated update of the same plane for fp32 Sum and Average wherever the
plane sums the reduce-scatter in the order of its allreduce (any order at
n <= 2): Average goes through the plane, which divides as its allreduce
does, and an elementwise optimizer acts per element. With a codec the
gathered update is the shard's new value minus its old one, as the inner
optimizer wrote it (optax returns the update itself).

**A new world size goes through a checkpoint.** Each process holds only
its own shard, so the in-place elastic reshard (the JAX package's
``reshard_state`` and ``_shard_reader``) is not ported: a membership change
under built state raises :data:`RESHARD_ERROR`. The route instead:
:meth:`ZeroRuntime.full_state_dict` (``DistributedOptimizer.state_dict()``
in ZeRO mode, every rank calls it) assembles on rank 0, by named
allgathers through the coordinator (``zero.ckpt.<slot>.<chunk>``), the
world-size-independent state the JAX package's ``unshard_moments``
returns: per state slot, each leaf's moments with the padding stripped,
plus the scalar slots. ``checkpoint.save_step`` writes rank 0's copy;
:meth:`ZeroRuntime.load_full_state_dict` places each rank's windows of it
under a fresh plan at any world size, as ``reshard_state`` does. The
error-feedback residuals start from zero there (they never cross cohorts).
"""

import inspect
import itertools

import numpy as np
import torch

from .. import basics
from ..utils import envparse
from . import reduce_ops
from .bucketing import DEFAULT_BUCKET_BYTES, plan_buckets

#: ``HVDTPU_ZERO_BUCKET_BYTES`` default: the JAX package's overlap bucket.
DEFAULT_ZERO_BUCKET_BYTES = DEFAULT_BUCKET_BYTES

RESHARD_ERROR = (
    "zero: cannot reshard optimizer state in place — each process holds "
    "only its own state shard, and the elastic membership version moved "
    "under it (the in-place reshard is not ported). Restore from a "
    "checkpoint after the elastic restart instead: while the cohort is "
    "whole, every rank calls "
    "checkpoint.save_step(directory, step, {'opt': dist_opt.state_dict(), "
    "...}) (the world-size-independent ZeRO state, assembled on rank 0); "
    "after the restart, dist_opt.load_state_dict(checkpoint.restore_latest("
    "directory)[1]['opt']) places each rank's windows under a fresh plan "
    "at the new world size.")


def _m_state_bytes():
    from ..telemetry import core as telemetry
    return telemetry.gauge(
        "hvd_zero_state_bytes",
        "Per-replica optimizer-state bytes under ZeRO-1 sharding "
        "(moments + scalars; ~1/n of the replicated footprint)")


def _m_reshard_hist():
    from ..telemetry import core as telemetry
    return telemetry.histogram(
        "hvd_zero_reshard_seconds",
        "Deterministic optimizer-state reshard on elastic world-size "
        "change")


def _host_tensor(t):
    """A CPU copy of ``t`` in a dtype numpy has (16-bit floats other than
    float16 widen exactly to float32)."""
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.to(torch.float32)
    return t.detach().cpu()


def _host(t):
    return _host_tensor(t).numpy()


def dtype_name(dtype):
    """numpy's spelling of a torch dtype (``"float32"``, ``"bfloat16"``),
    as the JAX package's plan signature writes it."""
    return str(dtype).replace("torch.", "")


# ==========================================================================
# Shard plan
# ==========================================================================

class BucketShard:
    """Shard geometry of one fusion bucket: ``size`` payload elements,
    padded to ``padded`` (a multiple of n × block, so that every rank owns
    a whole number of quantization blocks), ``shard_len`` = padded / n
    elements per rank."""

    __slots__ = ("size", "padded", "shard_len")

    def __init__(self, size, padded, shard_len):
        self.size = size
        self.padded = padded
        self.shard_len = shard_len

    def __repr__(self):
        return (f"BucketShard(size={self.size}, padded={self.padded}, "
                f"shard_len={self.shard_len})")


class ZeroPlan:
    """Deterministic pad-and-split shard plan: identical on every rank that
    agrees on the leaf shapes, world size, bucket budget and block."""

    __slots__ = ("n", "bucket_bytes", "block", "buckets", "shards",
                 "leaf_shapes", "leaf_dtypes")

    def __init__(self, n, bucket_bytes, block, buckets, shards,
                 leaf_shapes, leaf_dtypes):
        self.n = n
        self.bucket_bytes = bucket_bytes
        self.block = block
        self.buckets = buckets
        self.shards = shards
        self.leaf_shapes = leaf_shapes
        self.leaf_dtypes = leaf_dtypes

    def signature(self):
        """JSON-able identity of the plan: what every rank must agree on."""
        return {
            "n": self.n,
            "bucket_bytes": int(self.bucket_bytes),
            "block": int(self.block),
            "buckets": [
                {"indices": list(b.indices), "dtype": dtype_name(b.dtype),
                 "padded": s.padded, "shard_len": s.shard_len}
                for b, s in zip(self.buckets, self.shards)],
        }


def plan_zero(leaves, n, bucket_bytes=DEFAULT_ZERO_BUCKET_BYTES, block=1):
    """The shard plan of ``leaves`` (tensors) over ``n`` ranks: fusion
    buckets from :func:`bucketing.plan_buckets`, each padded to a multiple
    of ``n × block`` and split into ``n`` equal shards."""
    from ..compression.codecs import padded_len
    n = int(n)
    if n < 1:
        raise ValueError(f"world size must be >= 1, got {n}")
    block = max(int(block), 1)
    buckets = plan_buckets(leaves, bucket_bytes)
    shards = []
    for b in buckets:
        size = sum(leaves[i].numel() for i in b.indices)
        padded = padded_len(size, n, block)
        shards.append(BucketShard(size, padded, padded // n))
    return ZeroPlan(n, bucket_bytes, block, buckets, shards,
                    [tuple(leaf.shape) for leaf in leaves],
                    [dtype_name(leaf.dtype) for leaf in leaves])


# ==========================================================================
# The elementwise-state contract
# ==========================================================================

def _elementwise_error(path, shape, want, what):
    return ValueError(
        f"ZeRO-1 requires elementwise optimizer state; leaf {path} has "
        f"shape {tuple(shape)} != {tuple(want)} ({what}). Use "
        "make_train_step without HVDTPU_ZERO for optimizers with "
        "non-per-parameter state (factored moments, per-layer masks, "
        "global-norm state, schedule tables).")


def _check_state(optimizer, params, what):
    """Every state tensor of ``optimizer`` with ndim >= 1 must have its
    parameter's shape."""
    for i, p in enumerate(params):
        for key, v in optimizer.state.get(p, {}).items():
            if torch.is_tensor(v) and v.dim() >= 1 and v.shape != p.shape:
                raise _elementwise_error(f"[{i}][{key!r}]", v.shape,
                                         p.shape, what)


def _ctor_kwargs(cls, group):
    """The keys of a param group that ``cls.__init__`` takes."""
    sig = inspect.signature(cls.__init__)
    if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
        return {k: v for k, v in group.items() if k != "params"}
    return {k: v for k, v in group.items()
            if k != "params" and k in sig.parameters}


def _probe_elementwise(optimizer, ndims):
    """One step of a fresh optimizer of ``optimizer``'s class and settings,
    on the CPU, over one small tensor of each parameter rank in ``ndims``
    (dims 2, 3, 4, ...): its state must mirror each parameter."""
    cls = type(optimizer)
    kw = _ctor_kwargs(cls, optimizer.param_groups[0])
    for flag in ("foreach", "fused", "capturable", "differentiable"):
        if flag in kw:
            kw[flag] = False if flag != "foreach" else None
    if torch.is_tensor(kw.get("lr")):
        kw["lr"] = float(kw["lr"])
    probes = [torch.zeros(tuple(range(2, 2 + d)), requires_grad=True)
              for d in sorted(ndims)]
    probe = cls(probes, **kw)
    for p in probes:
        p.grad = torch.ones_like(p)
    probe.step()
    _check_state(probe, probes, "the parameter it belongs to, on a probe "
                 "step of the wrapped optimizer's class")


def _same(a, b):
    if torch.is_tensor(a) or torch.is_tensor(b):
        return (torch.is_tensor(a) and torch.is_tensor(b)
                and a.shape == b.shape and bool(torch.equal(a, b)))
    return a == b


def check_uniform_groups(optimizer):
    """One set of hyperparameters for every param group: a bucket spans
    groups, and the sharded step cannot keep them apart."""
    first = optimizer.param_groups[0]
    for g in optimizer.param_groups[1:]:
        keys = (set(first) | set(g)) - {"params"}
        diff = sorted(k for k in keys if not _same(first.get(k),
                                                   g.get(k)))
        if diff:
            raise ValueError(
                "ZeRO-1 (HVDTPU_ZERO) needs one set of hyperparameters for "
                "every param group of the wrapped optimizer: a bucket "
                "spans groups, and the sharded step cannot keep them "
                f"apart (groups differ in {', '.join(diff)})")


# ==========================================================================
# Transport: buckets fused into chunks, laid out rank-major
# ==========================================================================

class Chunk:
    """One transport unit of the legs: consecutive plan buckets of one dtype
    fused under the fusion threshold, as the native core fuses allreduces
    (it fuses no reduce-scatter or allgather). Row r of the chunk's ``(n,
    width)`` reduce-scatter input holds rank r's shard of each of its
    buckets side by side, bucket ``buckets[j]`` at column ``cols[j]``, so
    that one collective moves them all. ``pieces`` map the leaves into that
    layout, ``(leaf, start in the flat leaf, rank, column, length)``. Cut in
    rank-major order, the pieces and the buckets' padding tile the flat
    ``(n * width,)`` buffer: ``segments`` are their lengths in that order,
    ``pad_segments`` the pads' places among them, and ``leaves[i]`` says,
    for leaf ``i``, the lengths of its parts in leaf order, each part's
    segment and its rank."""

    __slots__ = ("buckets", "dtype", "cols", "width", "pieces", "segments",
                 "pad_segments", "leaves")

    def __init__(self, buckets, dtype):
        self.buckets = buckets
        self.dtype = dtype
        self.cols = []
        self.width = 0
        self.pieces = []
        self.segments = []
        self.pad_segments = []
        self.leaves = {}

    def _index(self, pads):
        cut = sorted([(r * self.width + col, length, (i, at, r))
                      for i, at, r, col, length in self.pieces]
                     + [(r * self.width + col, length, None)
                        for r, col, length in pads])
        parts = {}
        for t, (_, length, who) in enumerate(cut):
            self.segments.append(length)
            if who is None:
                self.pad_segments.append(t)
            else:
                parts.setdefault(who[0], []).append((who[1], length, t,
                                                     who[2]))
        for i, ps in parts.items():
            ps.sort()
            self.leaves[i] = ([length for _, length, _, _ in ps],
                              [t for _, _, t, _ in ps],
                              [r for _, _, _, r in ps])


def _parts(flat, lengths):
    """``flat`` cut into consecutive views of ``lengths``."""
    return (flat,) if len(lengths) == 1 else torch.split(flat, lengths)


def _spans(start, stop, shard_len):
    """[start, stop) of a padded bucket cut at its shard boundaries:
    (rank, column in the shard, length) each."""
    j = start
    while j < stop:
        r, col = divmod(j, shard_len)
        length = min(stop - j, shard_len - col)
        yield r, col, length
        j += length


def plan_chunks(plan, numels, fusion_bytes):
    """The transport chunks of ``plan``: buckets of one dtype, in plan
    order, fused while a chunk's padded bytes stay within ``fusion_bytes``
    (a bucket larger than that alone). Deterministic in the plan, the
    leaves' sizes and the threshold."""
    chunks, open_ = [], {}
    for k, (b, s) in enumerate(zip(plan.buckets, plan.shards)):
        nbytes = s.padded * torch.empty((), dtype=b.dtype).element_size()
        key = str(b.dtype)
        cur = open_.get(key)
        if cur is not None and cur[1] + nbytes > fusion_bytes:
            chunks.append(cur[0])
            cur = None
        if cur is None:
            cur = (Chunk([], b.dtype), 0)
        cur[0].buckets.append(k)
        open_[key] = (cur[0], cur[1] + nbytes)
    chunks += [c for c, _ in open_.values()]
    for ch in chunks:
        pads = []
        for k in ch.buckets:
            b, s = plan.buckets[k], plan.shards[k]
            ch.cols.append(ch.width)
            off = 0
            for i in b.indices:
                for r, col, length in _spans(off, off + numels[i],
                                             s.shard_len):
                    ch.pieces.append((i, r * s.shard_len + col - off, r,
                                      ch.width + col, length))
                off += numels[i]
            pads += [(r, ch.width + col, length)
                     for r, col, length in _spans(s.size, s.padded,
                                                  s.shard_len)]
            ch.width += s.shard_len
        ch._index(pads)
    return chunks


# ==========================================================================
# Runtime: the inner optimizer × plan × process group × codec
# ==========================================================================

class ZeroRuntime:
    """Everything the sharded update needs, bound once: the wrapped
    optimizer (its parameters, class and hyperparameters), the shard plan
    and its transport chunks (built from the parameters at the first use),
    the inner optimizer over this rank's shards, and the codec
    configuration. Owned by ``train.DistributedOptimizer`` when ``zero`` is
    on. ``n`` and ``rank`` come from the global process set."""

    def __init__(self, optimizer, op=reduce_ops.Average,
                 bucket_bytes=DEFAULT_ZERO_BUCKET_BYTES, codec=None,
                 block=0, error_feedback=None, prescale=None,
                 postscale=None):
        from ..compression import codecs as _codecs
        if op not in (reduce_ops.Average, reduce_ops.Sum):
            raise ValueError(
                "ZeRO-1 supports Average/Sum gradient reductions only "
                f"(got {reduce_ops.op_name(op)}: Adasum's per-tensor "
                "scale-invariant combination does not reduce-scatter)")
        check_uniform_groups(optimizer)
        self.optimizer = optimizer
        self.op = op
        self.bucket_bytes = int(bucket_bytes)
        self.codec = (_codecs.get_codec(codec) if isinstance(codec, str)
                      else codec)
        self.block = (int(block) or _codecs.DEFAULT_BLOCK) \
            if self.codec is not None and self.codec.wire else 0
        if error_feedback is None:
            error_feedback = envparse.get_bool(
                envparse.COMPRESSION_ERROR_FEEDBACK, True)
        self.error_feedback = bool(error_feedback) \
            and self.codec is not None and self.codec.wire
        self.prescale = prescale
        self.postscale = postscale
        self.n = None
        self.rank = None
        self.plan = None
        self.chunks = None
        self.inner = None       # the optimizer over this rank's shards
        self.shards = None      # per bucket, this rank's parameter shard
        self.res_s = None       # per chunk, (n, width) float32
        self.res_g = None       # per chunk, (width,) float32
        self._flat = None       # per chunk, this rank's shards side by side
        self._views = None
        self._checked_state = False
        self._probed = False
        #: elastic membership version this runtime's plan belongs to.
        self.version = envparse.get_str(envparse.ELASTIC_VERSION, "0")

    def stale_version(self):
        return (envparse.get_str(envparse.ELASTIC_VERSION, "0")
                != self.version)

    def params(self):
        """The wrapped optimizer's parameters, group by group: the leaves
        of the plan."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    # -- plan --------------------------------------------------------------
    def ensure_plan(self, params):
        if self.plan is None:
            rt = basics.runtime()
            self.n, self.rank = rt.topology.size, rt.topology.rank
            _probe_elementwise(self.optimizer, {p.dim() for p in params})
            self.plan = plan_zero(params, self.n, self.bucket_bytes,
                                  block=self.block if self.block else 1)
            self.chunks = plan_chunks(self.plan,
                                      [p.numel() for p in params],
                                      rt.coordinator.fusion_threshold)
        elif [tuple(p.shape) for p in params] != self.plan.leaf_shapes:
            raise ValueError(
                "ZeRO-1 shard plan was built for a different parameter "
                "tree (leaf shapes changed); build a fresh "
                "DistributedOptimizer for the new model")
        return self.plan

    def _digest(self):
        """A 32-bit digest of everything the ranks must agree on: the plan,
        the chunks, the op and the codec."""
        import json
        import zlib
        ident = {"plan": self.plan.signature(),
                 "chunks": [ch.buckets for ch in self.chunks],
                 "op": reduce_ops.op_name(self.op),
                 "codec": None if self.codec is None else self.codec.name,
                 "block": self.block}
        return zlib.crc32(json.dumps(ident, sort_keys=True).encode())

    def _param_parts(self, params):
        """Per leaf, the views of its parts (``Chunk.leaves``) of the
        parameters, kept while the parameters' storage stays."""
        key = tuple(p.data_ptr() for p in params)
        if self._views is None or self._views[0] != key:
            parts = {}
            for ch in self.chunks:
                for i, (lengths, _, _) in ch.leaves.items():
                    parts[i] = _parts(params[i].detach().view(-1), lengths)
            self._views = (key, parts, None)
        return self._views[1]

    def _load_windows(self, params):
        """Copy this rank's slice of every parameter bucket into the
        shards."""
        parts = self._param_parts(params)
        if self._views[2] is None:
            dst, src = [], []
            for ch, flat in zip(self.chunks, self._flat):
                # This rank's row of the chunk: a range of its segments.
                starts = list(itertools.accumulate([0] + ch.segments))
                first = starts.index(self.rank * ch.width)
                last = starts.index((self.rank + 1) * ch.width)
                segs = torch.split(flat, ch.segments[first:last])
                for i, (_, where, ranks) in ch.leaves.items():
                    for j, (t, r) in enumerate(zip(where, ranks)):
                        if r == self.rank:
                            dst.append(segs[t - first])
                            src.append(parts[i][j])
            self._views = self._views[:2] + ((dst, src),)
        dst, src = self._views[2]
        if dst:
            torch._foreach_copy_(dst, src)

    # -- init --------------------------------------------------------------
    @torch.no_grad()
    def init_state(self):
        """Build the sharded state: this rank's ``(shard_len,)`` parameter
        shard per bucket (views of one flat tensor per chunk) and the inner
        optimizer over them; the replicated state never exists.
        Idempotent."""
        if self.inner is not None:
            return self
        params = self.params()
        plan = self.ensure_plan(params)
        self.verify_plan_consistency()
        self._flat, self.shards = [], [None] * len(plan.buckets)
        self._views = None
        for ch in self.chunks:
            dev = params[plan.buckets[ch.buckets[0]].indices[0]].device
            flat = torch.zeros(ch.width, dtype=ch.dtype, device=dev)
            self._flat.append(flat)
            for k, col in zip(ch.buckets, ch.cols):
                self.shards[k] = flat[col:col + plan.shards[k].shard_len]
        self._load_windows(params)
        cls = type(self.optimizer)
        self.inner = cls(self.shards, **_ctor_kwargs(
            cls, self.optimizer.param_groups[0]))
        self._sync_hyperparameters()
        if self.error_feedback:
            self.res_s = [torch.zeros((self.n, f.numel()),
                                      dtype=torch.float32, device=f.device)
                          for f in self._flat]
            self.res_g = [torch.zeros(f.numel(), dtype=torch.float32,
                                      device=f.device) for f in self._flat]
        return self

    def _sync_hyperparameters(self):
        """The wrapped optimizer's hyperparameters (an ``lr_scheduler``
        steps them there) into the inner optimizer's group."""
        group = self.inner.param_groups[0]
        for k, v in self.optimizer.param_groups[0].items():
            if k != "params":
                group[k] = v

    def state_bytes(self):
        """This rank's optimizer-state bytes: the inner optimizer's state
        tensors (1/n of the moments, plus its scalars); the error-feedback
        residuals are compression state and not counted."""
        if self.inner is None:
            return 0
        return sum(v.numel() * v.element_size()
                   for st in self.inner.state.values()
                   for v in st.values() if torch.is_tensor(v))

    def state_dict(self):
        """This rank's sharded state, keyed by the plan and the rank it
        belongs to: for the same plan (an elastic commit); a checkpoint
        takes :meth:`full_state_dict`."""
        self.init_state()
        return {"plan": self.plan.signature(), "rank": self.rank,
                "inner": self.inner.state_dict(),
                "scatter_residuals": list(self.res_s or ()),
                "gather_residuals": list(self.res_g or ())}

    def load_state_dict(self, state):
        self.init_state()
        if state["plan"] != self.plan.signature() \
                or state["rank"] != self.rank:
            raise ValueError(
                "ZeRO-1 state_dict belongs to another shard plan or rank "
                f"(rank {state['rank']} of {state['plan']['n']}; this is "
                f"rank {self.rank} of {self.n}): each rank loads its own "
                "shard of the same plan")
        self.inner.load_state_dict(state["inner"])
        for mine, theirs in ((self.res_s, state["scatter_residuals"]),
                             (self.res_g, state["gather_residuals"])):
            for r, v in zip(mine or (), theirs):
                r.copy_(v)

    # -- the world-size-independent state (checkpoints) ----------------------
    def _vector_slots(self):
        """Names of the inner optimizer's per-element state slots, and its
        scalar slots with their values (the first bucket's: every bucket
        steps together)."""
        first = self.inner.state.get(self.shards[0], {})
        vectors = sorted(k for k, v in first.items()
                         if torch.is_tensor(v) and v.dim() >= 1)
        scalars = {k: (_host(v) if torch.is_tensor(v) else v)
                   for k, v in first.items() if k not in vectors}
        return vectors, scalars

    @torch.no_grad()
    def full_state_dict(self):
        """The world-size-independent state (collective: every rank calls
        it). Returns ``{"zero": {...}}`` with the leaf shapes and dtypes,
        the wrapped optimizer's hyperparameters, ``scalars`` (``step``)
        and ``slots``: per state slot, each leaf's moments as a flat numpy
        array, padding stripped (the JAX package's ``unshard_moments``).
        Each chunk's slot vector is gathered through the coordinator
        (``zero.ckpt.<slot>.<chunk>``); only rank 0 keeps the moments, the
        other ranks' ``slots`` is None: ``checkpoint.save`` writes rank
        0's copy."""
        from .collectives import allgather_async, synchronize
        self.init_state()
        vectors, scalars = self._vector_slots()
        nleaves = len(self.plan.leaf_shapes)
        keep = self.rank == 0
        slots = {slot: [None] * nleaves for slot in vectors} if keep \
            else None
        for slot in vectors:
            for c, ch in enumerate(self.chunks):
                vec = torch.cat([self.inner.state[self.shards[k]][slot]
                                 for k in ch.buckets])
                got = synchronize(allgather_async(
                    vec, name=f"zero.ckpt.{slot}.{c}"))
                if not keep:
                    continue
                segs = torch.split(_host_tensor(got), ch.segments)
                for i, (_, where, _) in ch.leaves.items():
                    slots[slot][i] = torch.cat(
                        [segs[t] for t in where]).numpy()
        hyper = {k: v for k, v in self.optimizer.param_groups[0].items()
                 if k != "params"}
        return {"zero": {
            "leaf_shapes": [list(s) for s in self.plan.leaf_shapes],
            "leaf_dtypes": list(self.plan.leaf_dtypes),
            "hyper": hyper, "scalars": scalars, "slots": slots}}

    @torch.no_grad()
    def load_full_state_dict(self, state):
        """Place this rank's windows of a :meth:`full_state_dict` under the
        current plan, at this world size (a fresh plan when the elastic
        version moved since this runtime planned); the error-feedback
        residuals start from zero. Observed into
        ``hvd_zero_reshard_seconds``."""
        from ..telemetry import span as tele_span
        with tele_span(["zero"], "ZERO_RESHARD",
                       histogram=_m_reshard_hist()):
            self._load_full_state_dict(state)

    def _load_full_state_dict(self, state):
        z = state["zero"]
        if z["slots"] is None:
            raise ValueError(
                "this ZeRO-1 state holds no moments (a rank other than 0 "
                "built it): restore it with checkpoint.restore, which "
                "broadcasts rank 0's copy")
        if self.stale_version():
            self.plan = self.inner = None
            self.version = envparse.get_str(envparse.ELASTIC_VERSION, "0")
        self.inner = None
        self.init_state()
        if [list(s) for s in z["leaf_shapes"]] != \
                [list(s) for s in self.plan.leaf_shapes]:
            raise ValueError(
                "ZeRO-1 state was saved for another parameter tree (leaf "
                f"shapes {z['leaf_shapes']}, this optimizer's "
                f"{[list(s) for s in self.plan.leaf_shapes]})")
        for k, v in z["hyper"].items():
            for group in self.optimizer.param_groups:
                group[k] = v
        self._sync_hyperparameters()
        inner_state = {}
        for ch in self.chunks:
            for k, col0 in zip(ch.buckets, ch.cols):
                sl = self.plan.shards[k].shard_len
                entry = {}
                for slot, leaves in z["slots"].items():
                    vec = torch.zeros(sl, dtype=torch.float32)
                    for i, at, r, col, length in ch.pieces:
                        if r == self.rank and col0 <= col < col0 + sl:
                            vec[col - col0:col - col0 + length] = \
                                torch.from_numpy(np.ascontiguousarray(
                                    leaves[i][at:at + length]))
                    entry[slot] = vec
                for slot, v in z["scalars"].items():
                    # A copy per bucket: AdamW counts its step in place.
                    entry[slot] = torch.tensor(v) \
                        if isinstance(v, np.ndarray) else v
                inner_state[k] = entry
        self.inner.load_state_dict({
            "state": inner_state,
            "param_groups": self.inner.state_dict()["param_groups"]})
        self._checked_state = False

    # -- guardian ------------------------------------------------------------
    def leg_digests(self, rank):
        """The guardian's digests of the plan's two legs (the JAX
        package's): every rank must derive the same padded sizes and shard
        shapes and hold its own shard index; a rank with another
        ``HVDTPU_ZERO_BUCKET_BYTES`` would reduce mismatched buffers."""
        sig = self.plan.signature()
        codec = None
        if self.codec is not None:
            codec = (f"{self.codec.name}@b{self.block}" if self.block
                     else self.codec.name)
        common = {
            "op": reduce_ops.op_name(self.op),
            "dtype": ",".join(dtype_name(b.dtype)
                              for b in self.plan.buckets),
            "shapes": [[b["padded"]] for b in sig["buckets"]],
            "process_set": 0,
            "prescale": None if self.prescale is None
            else float(self.prescale),
            "postscale": None if self.postscale is None
            else float(self.postscale),
            "root_rank": None,
            "codec": codec,
            "shard_index": rank,
            "shard_shape": [[b["shard_len"]] for b in sig["buckets"]],
        }
        return {
            "zero_reduce_scatter": dict(common, kind="zero_reduce_scatter"),
            "zero_allgather": dict(common, kind="zero_allgather"),
        }

    def verify_plan_consistency(self, board=None, rank=None, size=None,
                                timeout_s=None):
        """Cross-rank plan check through the guardian's board (a launcher
        job with ``HVDTPU_CONSISTENCY_CHECK`` on; otherwise the
        ``zero.rs.plan`` probe at the first step is the check): publish
        this rank's leg digests, compare every peer's. Raises
        ``CollectiveMismatchError`` naming the divergent rank and field,
        and ``CollectiveAbortError`` when a peer published none within
        ``HVDTPU_CONSISTENCY_TIMEOUT``."""
        from .. import guardian
        from ..exceptions import CollectiveAbortError
        if board is None:
            if envparse.get_int(envparse.CONSISTENCY_CHECK, 0) <= 0:
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
        self._probed = True   # the digests replace the probe
        mine = self.leg_digests(rank)
        for leg, digest in mine.items():
            board.put(f"zero.plan.{leg}.{rank}",
                      guardian.render_digest(digest))
        for leg, digest in mine.items():
            theirs, waiting, _ = guardian.wait_digests(
                board, lambda r, leg=leg: f"zero.plan.{leg}.{r}",
                set(range(size)) - {rank}, timeout_s)
            divergences = guardian.compare_digests(digest, theirs)
            if divergences:
                raise guardian.mismatch_error(
                    f"ZeRO-1 {leg} shard plan", divergences, rank,
                    "Every rank must derive the same pad-and-split plan: "
                    "check that HVDTPU_ZERO_BUCKET_BYTES and "
                    "HVDTPU_COMPRESSION agree on all ranks.")
            if waiting:
                raise CollectiveAbortError(
                    f"ZeRO-1 plan check of {leg}: rank(s) "
                    f"{sorted(waiting)} published no digest within "
                    f"{timeout_s:.1f}s (HVDTPU_CONSISTENCY_TIMEOUT)")

    # -- the sharded update ------------------------------------------------
    def _grads(self, params):
        grads = []
        for p in params:
            g = p.grad
            if g is not None and g.is_sparse:
                raise ValueError(
                    "zero=True (HVDTPU_ZERO) does not accept sparse "
                    "gradients: the ZeRO plan shards the FLAT dense state "
                    "— densify the gradient, or keep the embedding on the "
                    "sparse plane's row-sharded state "
                    "(ops/sparse.plan_row_shards)")
            # A parameter without a gradient steps with a zero one: its
            # slice of a flat shard cannot be skipped.
            grads.append(torch.zeros_like(p) if g is None else g)
        return grads

    def _packed(self, grads):
        """Each chunk's ``(n, width)`` reduce-scatter input: the gradients
        in the rank-major layout, padding zeroed, prescaled."""
        bufs = []
        dst, src, pads = [], [], []
        for ch, flat in zip(self.chunks, self._flat):
            buf = torch.empty((self.n, ch.width), dtype=ch.dtype,
                              device=flat.device)
            bufs.append(buf)
            segs = torch.split(buf.view(-1), ch.segments)
            for i, (lengths, where, _) in ch.leaves.items():
                dst += [segs[t] for t in where]
                src += _parts(grads[i].reshape(-1), lengths)
            pads += [segs[t] for t in ch.pad_segments]
        torch._foreach_copy_(dst, src)
        if pads:
            torch._foreach_zero_(pads)
        if self.prescale is not None:
            torch._foreach_mul_(bufs, self.prescale)
        return bufs

    def _submit_probe(self):
        """At the first step of a multi-rank job: a tiny reduce-scatter
        whose width is a digest of the plan, so that ranks that derived
        different plans (another ``HVDTPU_ZERO_BUCKET_BYTES``, fusion
        threshold or codec) fail in the negotiation, naming
        ``zero.rs.plan``, before any mis-aligned leg is applied."""
        from .collectives import reducescatter_async
        if self._probed or self.n == 1:
            return None
        self._probed = True
        probe = torch.zeros((self.n, 1 + self._digest() % 4093),
                            dtype=torch.int32, device=self._flat[0].device)
        return reducescatter_async(probe, op=reduce_ops.Sum,
                                   name="zero.rs.plan")

    def _reduce_scatter(self, grads):
        """The reduce-scatter leg of every chunk: this rank's reduced
        gradient shards side by side, one ``(width,)`` tensor per chunk
        (Average, prescale, postscale applied)."""
        from .collectives import (alltoall_async,
                                  grouped_reducescatter_async, synchronize)
        n = self.n
        average = self.op == reduce_ops.Average
        probe = self._submit_probe()
        bufs = self._packed(grads)
        if self.codec is not None and self.codec.wire:
            handles = []
            for c, buf in enumerate(bufs):
                rows = buf.to(torch.float32)
                if self.error_feedback:
                    rows = rows + self.res_s[c]
                q, sc = self.codec.encode(rows, self.block)
                if self.error_feedback:
                    self.res_s[c] = rows - self.codec.decode(q, sc,
                                                             self.block)
                # Rank r receives row r of every rank.
                handles.append((alltoall_async(q, name=f"zero.rs.{c}.q"),
                                alltoall_async(sc, name=f"zero.rs.{c}.s")))
            del bufs
            if probe is not None:
                synchronize(probe)
            out = []
            for (hq, hs), ch in zip(handles, self.chunks):
                g = self.codec.decode(synchronize(hq)[0],
                                      synchronize(hs)[0],
                                      self.block).sum(dim=0)
                if average:
                    g = g / n
                out.append(g.to(ch.dtype))
        elif self.codec is not None:
            # Cast codec: the narrow dtype rides the collective, summed
            # there, and is divided after it is widened again.
            h = grouped_reducescatter_async(
                [self.codec.encode(buf, 0)[0] for buf in bufs],
                op=reduce_ops.Sum, name="zero.rs")
            del bufs
            if probe is not None:
                synchronize(probe)
            out = [self.codec.decode(g.reshape(-1), None, 0, dtype=ch.dtype)
                   for g, ch in zip(synchronize(h), self.chunks)]
            if average:
                out = [g / n for g in out]
        else:
            # Average goes through the plane, which divides as its
            # allreduce does: bit-identical to the replicated path.
            h = grouped_reducescatter_async(bufs, op=self.op, name="zero.rs")
            del bufs
            if probe is not None:
                synchronize(probe)
            out = [g.reshape(-1) for g in synchronize(h)]
        if self.postscale is not None:
            out = [g * self.postscale for g in out]
        return out

    def _gather(self, sent):
        """The allgather leg of every chunk: from this rank's ``(width,)``
        tensor per chunk (new parameter shards, or updates) to every
        rank's, as ``(n, width)`` in the bucket dtype."""
        from .collectives import (allgather_async, grouped_allgather_async,
                                  synchronize)
        n = self.n
        if self.codec is not None and self.codec.wire:
            handles = []
            for c, u in enumerate(sent):
                u = u.to(torch.float32)
                if self.error_feedback:
                    u = u + self.res_g[c]
                q, sc = self.codec.encode(u, self.block)
                if self.error_feedback:
                    self.res_g[c] = u - self.codec.decode(q, sc, self.block)
                handles.append((allgather_async(q, name=f"zero.ag.{c}.q"),
                                allgather_async(sc, name=f"zero.ag.{c}.s")))
            return [self.codec.decode(synchronize(hq).view(n, -1),
                                      synchronize(hs).view(n, -1),
                                      self.block).to(ch.dtype)
                    for (hq, hs), ch in zip(handles, self.chunks)]
        if self.codec is not None:
            got = synchronize(grouped_allgather_async(
                [self.codec.encode(u, 0)[0] for u in sent], name="zero.ag"))
            return [self.codec.decode(g, None, 0,
                                      dtype=ch.dtype).view(n, -1)
                    for g, ch in zip(got, self.chunks)]
        got = synchronize(grouped_allgather_async(list(sent),
                                                  name="zero.ag"))
        return [g.view(n, -1) for g in got]

    def _scatter_into(self, gathered, parts, add):
        """Every rank's gathered shards into the leaves whose part views
        (``Chunk.leaves``) ``parts`` holds, copied or, with ``add``,
        added."""
        dst, src = [], []
        for ch, g in zip(self.chunks, gathered):
            segs = torch.split(g.reshape(-1), ch.segments)
            for i, (_, where, _) in ch.leaves.items():
                dst += parts[i]
                src += [segs[t] for t in where]
        if add:
            torch._foreach_add_(dst, src)
        else:
            torch._foreach_copy_(dst, src)

    @torch.no_grad()
    def _run(self, gather_params):
        """One sharded update: reduce-scatter every chunk, step the inner
        optimizer over this rank's shards, allgather back.

        ``gather_params=True`` (the train step) gathers the new parameter
        shards and writes them into the model's parameters, or, with a
        codec, gathers the updates and adds them to every rank's
        parameters alike. ``gather_params=False`` (``update``) gathers the
        updates and returns them, one tensor per parameter, leaving the
        parameters alone."""
        if self.stale_version():
            if self.inner is not None:
                raise RuntimeError(RESHARD_ERROR)
            # No state yet: plan afresh at the new membership.
            self.plan = None
            self.version = envparse.get_str(envparse.ELASTIC_VERSION, "0")
        params = self.params()
        self.ensure_plan(params)
        self.init_state()
        g_flat = self._reduce_scatter(self._grads(params))
        self._load_windows(params)
        delta = not gather_params or self.codec is not None
        old = [f.clone() for f in self._flat] if delta else None
        for ch, g in zip(self.chunks, g_flat):
            for k, col in zip(ch.buckets, ch.cols):
                self.shards[k].grad = g[col:col +
                                        self.plan.shards[k].shard_len]
        del g_flat
        self._sync_hyperparameters()
        self.inner.step()
        # What an lr_scheduler reads to tell that the wrapped optimizer
        # stepped before it (the inner one steps in its place).
        self.optimizer._opt_called = True
        for shard in self.shards:
            shard.grad = None
        if not self._checked_state:
            _check_state(self.inner, self.shards,
                         "the per-replica parameter shard")
            self._checked_state = True
            _m_state_bytes().set(self.state_bytes())
        if delta:
            sent = [f - o for f, o in zip(self._flat, old)]
            del old
        else:
            sent = self._flat
        gathered = self._gather(sent)
        del sent
        if not gather_params:
            outs = [torch.empty_like(p) for p in params]
            self._scatter_into(gathered, {
                i: _parts(outs[i].view(-1), lengths)
                for ch in self.chunks
                for i, (lengths, _, _) in ch.leaves.items()}, add=False)
            return outs
        self._scatter_into(gathered, self._param_parts(params),
                           add=self.codec is not None)
        return None

    def apply(self):
        """The train-step path: reduce, step and write the new parameters
        in place."""
        self._run(gather_params=True)

    def update(self):
        """The optax ``update`` contract: the gathered updates, one tensor
        per parameter of the wrapped optimizer; the parameters are left
        alone."""
        return self._run(gather_params=False)


def unshard_moments(runtime):
    """Host view of this rank's sharded optimizer state: ``(per_leaf,
    scalars, windows)``. ``per_leaf[slot][i]`` is a numpy copy of state
    ``slot`` (``"exp_avg"``, ``"momentum_buffer"``, ...) over the elements
    of leaf ``i`` that this rank's shard holds, padding stripped, or None
    where it holds none; ``windows[i]`` says which: ``(start, stop)`` in the
    flattened leaf, or None. At n = 1 every window is the whole leaf.
    ``scalars[slot]`` is a scalar state (``"step"``) of the first bucket.
    The tests' building block against the JAX package's
    ``unshard_moments``."""
    if runtime.inner is None:
        raise RuntimeError("ZeRO-1 state is not built yet (call init)")
    nleaves = len(runtime.plan.leaf_shapes)
    per_leaf, scalars = {}, {}
    windows = [None] * nleaves
    for ch in runtime.chunks:
        for k, col0 in zip(ch.buckets, ch.cols):
            sl = runtime.plan.shards[k].shard_len
            state = runtime.inner.state.get(runtime.shards[k], {})
            for slot, v in state.items():
                if not torch.is_tensor(v):
                    continue
                if v.dim() == 0:
                    scalars.setdefault(slot, v.detach().cpu().numpy())
                    continue
                vec = v.detach().cpu().numpy()
                rows = per_leaf.setdefault(slot, [None] * nleaves)
                for i, at, r, col, length in ch.pieces:
                    if r == runtime.rank and col0 <= col < col0 + sl:
                        rows[i] = np.array(vec[col - col0:col - col0
                                               + length])
                        windows[i] = (at, at + length)
    return per_leaf, scalars, windows

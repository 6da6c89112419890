"""Mesh axes as torch process groups.

The port's counterpart of the ``jax.lax`` collectives a ``shard_map`` body
calls (``ppermute``, ``all_to_all``, ``psum``, ``pmean``, ``all_gather``,
``psum_scatter``) and of
``utils/jax_compat.py``'s ``axis_size``, ``vary_replicated`` and ``pvary``.
An axis is a ``torch.distributed`` process group (NCCL for CUDA tensors,
gloo for CPU tensors): the world group, a ``new_group`` or a dimension of a
``DeviceMesh`` (``mesh["sp"]``, or its ``get_group()``).

JAX derives each collective's transpose from its varying-types rule; eager
PyTorch derives none, so each collective here is a
``torch.autograd.Function`` whose backward is that transpose:

- ``ppermute``: the inverse permutation.
- ``all_to_all`` (``lax.all_to_all(..., tiled=True)``): the inverse
  all_to_all, split and concat axes swapped.
- ``psum`` / ``pmean`` to a replicated result: the identity (``pmean``'s
  divided by the axis size). A loss computed from the result on every rank
  counts once; a rank-dependent use of it goes through ``vary_replicated``
  first, which JAX inserts by itself.
- ``vary_replicated``: the identity forward, a sum over the axis backward,
  so that a replicated input's gradient comes out whole on every rank.
- ``all_gather`` (tiled) and ``psum_scatter`` (tiled): each other's
  transpose. ``all_gather_invariant``: this rank's block of the cotangent,
  for a gathered value every rank uses alike.

Every rank must call the same collectives in the same order, forward and
backward: a collective's backward runs only where its output reached the
loss, so code that masks per rank does so with ``torch.where``, never with
a Python branch that leaves a collective out of one rank's graph. A gloo
group refuses CUDA tensors and an NCCL group CPU tensors: nothing is staged
through the host.
"""

import torch
import torch.distributed as dist


def _group(axis):
    """The process group of ``axis``: a ``ProcessGroup`` or a 1-D
    ``DeviceMesh``."""
    if axis is None:
        raise ValueError("an axis is a process group or a 1-D DeviceMesh, "
                         "not None (use torch.distributed.group.WORLD for "
                         "the world group)")
    return axis.get_group() if hasattr(axis, "get_group") else axis


def axis_size(axis):
    """Number of ranks on ``axis`` (``jax_compat.axis_size``)."""
    return dist.get_world_size(_group(axis))


def axis_index(axis):
    """This rank's index on ``axis`` (``lax.axis_index``)."""
    return dist.get_rank(_group(axis))


def _check(tensors, group, what):
    backend = str(dist.get_backend(group))
    for t in tensors:
        if t.is_cuda and "nccl" not in backend:
            raise ValueError(
                f"{what}: a CUDA tensor on a {backend} group; CUDA tensors "
                "need an NCCL group (nothing is staged through the host)")
        if not t.is_cuda and backend == "nccl":
            raise ValueError(f"{what}: a {t.device} tensor on an NCCL group")


# ---------------------------------------------------------------------------
# ppermute
# ---------------------------------------------------------------------------

def _check_perm(perm, n):
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= r < n for r in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a permutation of some of "
                         f"the {n} ranks (each rank sends at most once and "
                         "receives at most once)")


def _send_recv(xs, perm, group):
    """Start one ``batch_isend_irecv`` that moves every tensor of ``xs`` along
    ``perm``. Returns the outputs (zeros on a rank that receives nothing, as
    ``lax.ppermute`` gives), the works and the send buffers to keep alive
    until they finish. A self-edge is a local copy."""
    me = dist.get_rank(group)
    outs = [None] * len(xs)
    ops, keep = [], []
    for src, dst in perm:
        if src == me and dst == me:
            outs = [x.clone() for x in xs]
        elif src == me:
            peer = dist.get_global_rank(group, dst)
            for x in xs:
                x = x.contiguous()
                keep.append(x)
                ops.append(dist.P2POp(dist.isend, x, peer, group=group))
        elif dst == me:
            peer = dist.get_global_rank(group, src)
            for i, x in enumerate(xs):
                outs[i] = torch.empty(x.shape, dtype=x.dtype, device=x.device)
                ops.append(dist.P2POp(dist.irecv, outs[i], peer, group=group))
    outs = [torch.zeros_like(x) if o is None else o for o, x in zip(outs, xs)]
    works = dist.batch_isend_irecv(ops) if ops else []
    return outs, works, keep


class Pending:
    """A ``ppermute`` in flight (``async_op=True``): :meth:`wait` makes the
    current stream (CUDA) or the host (gloo) wait for it and returns the
    outputs, which must not be read before."""

    def __init__(self):
        self._works, self._keep, self._outs = [], [], None

    def wait(self):
        for w in self._works:
            w.wait()
        self._works, self._keep = [], []
        return self._outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, group, pending, *xs):
        ctx.perm, ctx.group = perm, group
        outs, works, keep = _send_recv(xs, perm, group)
        if pending is None:
            for w in works:
                w.wait()
        else:
            pending._works, pending._keep = works, keep
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        inverse = tuple((d, s) for s, d in ctx.perm)
        outs, works, _ = _send_recv([g.contiguous() for g in grads], inverse,
                                    ctx.group)
        for w in works:
            w.wait()
        return (None, None, None, *outs)


def ppermute(xs, perm, axis, *, async_op=False):
    """``lax.ppermute``: rank ``src`` sends ``xs`` to rank ``dst`` for each
    ``(src, dst)`` in ``perm`` (indices on ``axis``); a rank that receives
    nothing gets zeros. ``xs`` is a tensor or a sequence of tensors, all
    moved by one ``batch_isend_irecv``. With ``async_op`` it returns a
    :class:`Pending` whose ``wait()`` gives the outputs, so that the
    transfer overlaps what the caller does meanwhile. The backward moves the
    gradients along the inverse permutation."""
    single = isinstance(xs, torch.Tensor)
    xs = (xs,) if single else tuple(xs)
    group = _group(axis)
    perm = tuple((int(s), int(d)) for s, d in perm)
    _check_perm(perm, dist.get_world_size(group))
    _check(xs, group, "ppermute")
    pending = Pending() if async_op else None
    outs = _PPermute.apply(perm, group, pending, *xs)
    outs = outs[0] if single else outs
    if pending is None:
        return outs
    pending._outs = outs
    return pending


# ---------------------------------------------------------------------------
# all_to_all (tiled)
# ---------------------------------------------------------------------------

def _all_to_all(x, group, split_axis, concat_axis):
    """Chunk ``j`` of ``split_axis`` goes to rank ``j``; the chunk from rank
    ``i`` lands at position ``i`` of ``concat_axis``."""
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} is not divisible by the axis size "
                         f"{n}")
    inp = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    c = inp.shape[0] // n
    # (n, *x.shape with split_axis cut to c): block i came from rank i.
    blocks = out.view(n, c, *inp.shape[1:]).movedim(1, split_axis + 1)
    shape = list(x.shape)
    shape[split_axis] = c
    shape[concat_axis] *= n
    return blocks.movedim(0, concat_axis).reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def all_to_all(x, axis, split_axis, concat_axis):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`` over
    one ``all_to_all_single``; the backward is the inverse all_to_all."""
    group = _group(axis)
    _check((x,), group, "all_to_all")
    nd = x.dim()
    return _AllToAll.apply(x, group, split_axis % nd, concat_axis % nd)


# ---------------------------------------------------------------------------
# psum / pmean / vary_replicated
# ---------------------------------------------------------------------------

def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        y = _all_reduce(x, group)
        return y if scale == 1.0 else y * scale

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1.0 else g * ctx.scale), None, None


def psum(x, axis):
    """Sum over ``axis`` to a replicated value; the backward is the identity
    (JAX's transpose of a psum whose result is invariant)."""
    group = _group(axis)
    _check((x,), group, "psum")
    return _Psum.apply(x, group, 1.0)


def pmean(x, axis):
    """Mean over ``axis``; the backward divides by the axis size."""
    group = _group(axis)
    _check((x,), group, "pmean")
    return _Psum.apply(x, group, 1.0 / dist.get_world_size(group))


class _VaryReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def vary_replicated(x, axis):
    """Declare a replicated value (the same on every rank of ``axis``) before
    a rank-dependent use: the identity forward, and a sum of the gradient
    over ``axis`` backward (``jax_compat.vary_replicated``, the ``pvary``
    that varying-types JAX inserts). Without it, a replicated parameter's
    gradient holds only this rank's part."""
    group = _group(axis)
    _check((x,), group, "vary_replicated")
    return _VaryReplicated.apply(x, group)


# ---------------------------------------------------------------------------
# all_gather / psum_scatter (tiled)
# ---------------------------------------------------------------------------

def _gather_fn():
    return getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor


def _scatter_fn():
    return getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor


def _all_gather(x, group, dim):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    inp = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * inp.shape[0],) + tuple(inp.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _gather_fn()(out, inp, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, group, dim):
    """The sum over ranks of ``x``, this rank's block of ``dim``."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dimension {dim} of "
                         f"{tuple(x.shape)} is not divisible by the axis "
                         f"size {n}")
    inp = x.movedim(dim, 0).contiguous()
    out = torch.empty((inp.shape[0] // n,) + tuple(inp.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _scatter_fn()(out, inp, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _own_block(x, group, dim):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, invariant):
        ctx.args = (group, dim, invariant)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, invariant = ctx.args
        g = _own_block(g, group, dim) if invariant \
            else _reduce_scatter(g, group, dim)
        return g, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


def all_gather(x, axis, dim=0):
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in rank order. The backward is
    ``psum_scatter`` of the cotangent: each rank's block gets the sum of
    every rank's cotangent for it, as when each rank uses the gathered
    value on its own data (FSDP's weight gather)."""
    group = _group(axis)
    _check((x,), group, "all_gather")
    return _AllGather.apply(x, group, dim % x.dim(), False)


def all_gather_invariant(x, axis, dim=0):
    """The forward of :func:`all_gather`, for a result every rank uses
    alike (the same loss from it on each rank, the invariant result that
    GSPMD's partitioner gives a replicated output). The backward takes
    this rank's block of the cotangent, with no sum: Megatron's gather of
    column-parallel outputs."""
    group = _group(axis)
    _check((x,), group, "all_gather_invariant")
    return _AllGather.apply(x, group, dim % x.dim(), True)


def psum_scatter(x, axis, dim=0):
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the sum over ranks, this rank's block of ``dim``. The backward is the
    tiled ``all_gather`` of the cotangent."""
    group = _group(axis)
    _check((x,), group, "psum_scatter")
    return _PsumScatter.apply(x, group, dim % x.dim())

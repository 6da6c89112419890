"""Gradient bucketing (port of ``horovod_tpu/ops/bucketing.py``).

:func:`plan_buckets` is the JAX package's planner as written: buckets are
planned over the REVERSED leaf order (gradients become ready roughly
last-layer-first), one open bucket per dtype, at most ``bucket_bytes`` of
payload each, and a tensor is never split. A bucket's gradients are packed
into one flat buffer, reduced by one async collective, and unpacked in
place when the reduction is waited for.

- :class:`GradBuckets` launches each bucket from gradient hooks, as soon
  as the last of its members has its gradient, while backward still runs:
  the stand-in for the Coordinator's fusion by name
  (``coordinator.py:840``) until the Coordinator is ported. Buckets
  launch in the order their members become ready, which is the same on
  every rank that runs the same backward.
- :func:`bucketed_allreduce_` reduces a list of tensors after the fact,
  every bucket in flight at once.

Numerics: reducing a concatenation performs the identical per-element
cross-rank reduction, so both are bit-identical to reducing each tensor on
its own for Sum/Average, pre- and postscale included. Adasum is per tensor
and cannot be bucketed.
"""

import torch

from .. import basics
from ..process_sets import global_process_set
from . import reduce_ops
from .collectives import grouped_allreduce_async_

DEFAULT_BUCKET_BYTES = 16 * 1024 * 1024


class Bucket:
    """One planned fusion bucket: leaf indices (all sharing ``dtype``)
    and the payload byte count."""

    __slots__ = ("indices", "dtype", "nbytes")

    def __init__(self, indices, dtype, nbytes):
        self.indices = indices
        self.dtype = dtype
        self.nbytes = nbytes

    def __repr__(self):
        return (f"Bucket(n={len(self.indices)}, dtype={self.dtype}, "
                f"bytes={self.nbytes})")


def plan_buckets(leaves, bucket_bytes=DEFAULT_BUCKET_BYTES, reverse=True):
    """Group leaf indices into per-dtype buckets of at most
    ``bucket_bytes`` payload (a single leaf larger than the budget gets
    its own bucket — tensors are never split). ``reverse`` walks the
    leaves last-to-first so bucket order approximates backprop
    availability order; the relative order WITHIN the returned index
    lists is always ascending, so unbucketing is a stable scatter.
    """
    bucket_bytes = max(int(bucket_bytes), 1)
    order = range(len(leaves) - 1, -1, -1) if reverse \
        else range(len(leaves))
    open_buckets = {}   # dtype -> (indices, nbytes)
    closed = []
    for i in order:
        leaf = leaves[i]
        nbytes = leaf.numel() * leaf.element_size()
        cur = open_buckets.get(leaf.dtype)
        if cur is not None and cur[1] + nbytes > bucket_bytes:
            closed.append(Bucket(sorted(cur[0]), leaf.dtype, cur[1]))
            cur = None
        if cur is None:
            cur = ([], 0)
        cur[0].append(i)
        open_buckets[leaf.dtype] = (cur[0], cur[1] + nbytes)
    for dtype, (indices, nbytes) in open_buckets.items():
        closed.append(Bucket(sorted(indices), dtype, nbytes))
    return closed


def _check_op(op):
    if op not in (reduce_ops.Average, reduce_ops.Sum):
        raise ValueError(
            "bucketed reduction supports Average/Sum only (Adasum's "
            "per-tensor combination cannot be bucketed); got "
            f"{reduce_ops.op_name(op)}")


def _launch(tensors, op, prescale, postscale, process_set):
    """Pack ``tensors`` into one buffer and launch its async allreduce;
    returns a function that waits and unpacks in place."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    work = grouped_allreduce_async_([flat], op=op, prescale_factor=prescale,
                                    postscale_factor=postscale,
                                    process_set=process_set)

    def finish():
        work.wait()
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return finish


def bucketed_allreduce_(tensors, op, *, bucket_bytes=DEFAULT_BUCKET_BYTES,
                        prescale=None, postscale=None,
                        process_set=global_process_set):
    """Reduce ``tensors`` across the set in place, one collective per
    bucket of :func:`plan_buckets`, all in flight together."""
    _check_op(op)
    if basics.size() == 1:
        # Across one rank the reduction is the scaling alone: packing
        # would only copy every gradient twice.
        return grouped_allreduce_async_(
            tensors, op=op, prescale_factor=prescale,
            postscale_factor=postscale, process_set=process_set).wait()
    pending = [_launch([tensors[i] for i in b.indices], op, prescale,
                       postscale, process_set)
               for b in plan_buckets(tensors, bucket_bytes)]
    for finish in pending:
        finish()
    return tensors


class GradBuckets:
    """Reduces the gradients of ``params`` bucket by bucket, each bucket
    launched by :meth:`ready` as soon as all its members have their
    gradient (call it from each parameter's post-accumulate-grad hook), and
    finished by :meth:`wait`."""

    def __init__(self, params, op, *, bucket_bytes=DEFAULT_BUCKET_BYTES,
                 prescale=None, postscale=None,
                 process_set=global_process_set):
        _check_op(op)
        self.params = list(params)
        self.buckets = plan_buckets(self.params, bucket_bytes)
        self._bucket_of = {p: bi for bi, b in enumerate(self.buckets)
                           for p in (self.params[i] for i in b.indices)}
        self._args = (op, prescale, postscale, process_set)
        self._missing = [len(b.indices) for b in self.buckets]
        self._launched = {}   # bucket index -> finish function
        self._any_ready = False

    @property
    def launched(self):
        """Buckets launched since the last :meth:`wait`."""
        return len(self._launched)

    def ready(self, param):
        bi = self._bucket_of[param]
        self._any_ready = True
        self._missing[bi] -= 1
        if self._missing[bi] < 0:
            raise RuntimeError(
                "a gradient was ready twice before its reduction was "
                "waited for: call step() after each backward_passes_per_step "
                "backward passes")
        if self._missing[bi] == 0:
            self._launch(bi)

    def _launch(self, bi):
        members = [self.params[i] for i in self.buckets[bi].indices]
        for p in members:
            if p.grad is None:   # no gradient this step: reduce zeros
                p.grad = torch.zeros_like(p)
        self._launched[bi] = _launch([p.grad for p in members], *self._args)

    def wait(self):
        """Launch the buckets whose hooks did not all fire, in plan order,
        then finish every bucket: the gradients hold the reduced values.
        Without a gradient ready since the last wait (a second call, or no
        backward), there is nothing to reduce."""
        if not self._any_ready:
            return
        self._any_ready = False
        for bi in range(len(self.buckets)):
            if bi not in self._launched:
                self._launch(bi)
        for finish in self._launched.values():
            finish()
        self._launched.clear()
        self._missing = [len(b.indices) for b in self.buckets]

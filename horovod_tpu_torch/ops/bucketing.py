"""Fusion-bucket planner of the ZeRO-1 legs (port of the planner in
``horovod_tpu/ops/bucketing.py:47-110``).

Leaves are grouped into per-dtype buckets of at most ``bucket_bytes``
payload, walked last-to-first so that bucket order approximates the order
in which backprop produces the gradients; a leaf larger than the budget
gets a bucket of its own (tensors are never split), and the indices inside
a bucket are ascending, so unpacking is a stable scatter. The plan depends
only on the leaves' shapes and dtypes and the budget: every rank that
agrees on them derives the same buckets.

The JAX package's ``GradBuckets`` and its ``HVDTPU_BUCKET_BYTES`` knob have
no counterpart here: the native core's fusion (``HVDTPU_FUSION_THRESHOLD``)
buckets the allreduces of the replicated path.
"""

import torch

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
    its own bucket). ``reverse`` walks the leaves last-to-first; the
    indices within each returned bucket are always ascending."""
    bucket_bytes = max(int(bucket_bytes), 1)
    order = range(len(leaves) - 1, -1, -1) if reverse \
        else range(len(leaves))
    open_buckets = {}   # dtype -> (indices, nbytes)
    closed = []
    for i in order:
        leaf = leaves[i]
        nbytes = leaf.numel() * leaf.element_size()
        key = str(leaf.dtype)
        cur = open_buckets.get(key)
        if cur is not None and cur[1] + nbytes > bucket_bytes:
            closed.append(Bucket(sorted(cur[0]), leaves[cur[0][0]].dtype,
                                 cur[1]))
            cur = None
        if cur is None:
            cur = ([], 0)
        cur[0].append(i)
        open_buckets[key] = (cur[0], cur[1] + nbytes)
    for indices, nbytes in open_buckets.values():
        closed.append(Bucket(sorted(indices), leaves[indices[0]].dtype,
                             nbytes))
    return closed


def _pack(leaves, bucket):
    """The bucket's leaves flattened and concatenated, in index order."""
    flats = [leaves[i].reshape(-1) for i in bucket.indices]
    return flats[0] if len(flats) == 1 else torch.cat(flats)


def _unpack(buf, leaves, bucket, out):
    """Views of ``buf`` shaped like the bucket's leaves, into ``out[i]``."""
    offset = 0
    for i in bucket.indices:
        size = leaves[i].numel()
        out[i] = buf[offset:offset + size].view(leaves[i].shape)
        offset += size

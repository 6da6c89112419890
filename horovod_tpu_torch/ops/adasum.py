"""Adasum: scale-invariant adaptive summation (port of
``horovod_tpu/ops/adasum.py``; reference:
horovod/common/ops/adasum/adasum.h:194-343, pairwise rule at :397-407):

    a' = (1 - dot(a,b) / (2*||a||^2)) * a  +  (1 - dot(a,b) / (2*||b||^2)) * b

applied over a binary tree of rank pairs (rank r combines with r XOR 2^t in
round t, the vector-halving distance-doubling schedule). The reference
restricts Adasum to power-of-two rank counts
(horovod/tensorflow/__init__.py:138-154); so does the port.

Across processes Adasum runs in the native core (``csrc/core/
collectives.cc`` ``VhddAdasum``, float64 on the host): CUDA tensors are
staged through pinned host memory (``backend/nccl_global.py``).
:func:`adasum_tree` is the same combination on one stacked tensor, and the
numpy functions are the float64 oracles the tests share.
"""

import numpy as np
import torch


def _is_pow2(n):
    return n > 0 and (n & (n - 1)) == 0


def check_size(n):
    """Raise unless ``n`` ranks may run Adasum."""
    if not _is_pow2(n):
        raise ValueError(
            f"Adasum requires a power-of-2 number of ranks, got {n} "
            "(reference restriction, horovod/tensorflow/__init__.py:138)")


def adasum_pair(a, b, eps=0.0):
    """Combine two gradient tensors with the Adasum rule, in float32, a
    zero-norm side taking coefficient 1."""
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    dot = (af * bf).sum()
    na = (af * af).sum()
    nb = (bf * bf).sum()
    one = torch.ones((), dtype=torch.float32, device=af.device)
    ca = torch.where(na > eps, 1.0 - dot / (2.0 * na.clamp_min(1e-30)), one)
    cb = torch.where(nb > eps, 1.0 - dot / (2.0 * nb.clamp_min(1e-30)), one)
    return (ca * af + cb * bf).to(a.dtype)


def adasum_tree(stacked):
    """Reduce a stacked ``(n, ...)`` tensor down the VHDD pair tree; returns
    the combined tensor of shape ``stacked.shape[1:]``."""
    n = stacked.shape[0]
    check_size(n)
    xs = [stacked[i] for i in range(n)]
    dist = 1
    while dist < n:
        for i in range(0, n, 2 * dist):
            xs[i] = adasum_pair(xs[i], xs[i + dist])
        dist *= 2
    return xs[0]


def adasum_pair_np(a, b):
    """Numpy float64 oracle of the pairwise rule."""
    af = np.asarray(a, np.float64).ravel()
    bf = np.asarray(b, np.float64).ravel()
    dot = float(af @ bf)
    na = float(af @ af)
    nb = float(bf @ bf)
    ca = 1.0 - dot / (2.0 * na) if na > 0 else 1.0
    cb = 1.0 - dot / (2.0 * nb) if nb > 0 else 1.0
    return (ca * np.asarray(a, np.float64)
            + cb * np.asarray(b, np.float64))


def adasum_vhdd_np(stack):
    """Numpy pairwise VHDD tree over a list or stack of tensors."""
    xs = [np.asarray(x, np.float64) for x in stack]
    while len(xs) > 1:
        xs = [adasum_pair_np(xs[i], xs[i + 1])
              for i in range(0, len(xs), 2)]
    return xs[0]

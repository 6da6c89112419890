"""Ring attention: context parallelism over a sequence axis (port of
``horovod_tpu/parallel/ring_attention.py``).

Each rank holds a contiguous query chunk; the k/v chunks rotate around the
ring by ``ppermute`` (one ``batch_isend_irecv`` moves k and v) while the
flash kernels' partials are merged by their log-sum-exps. The rotation of
the next chunk starts before the kernel of the current one and is waited
on only before its use: on the card NCCL moves it on its own stream while
the kernel runs. Causality is in global coordinates through the kernels'
offsets, so a fully-future chunk contributes O = 0 and LSE = -1e30 and
merges away; no control flow depends on the data.

Differentiable: the backward is autograd's through the kernels' LSE mode
(the LSE cotangent folds into delta), the fp32 merge and the inverse
rotations, which every rank issues in the same order.
"""

import torch

from ..ops.flash_attention import NEG_INF, flash_attention, reference_attention
from .axis import axis_index, axis_size, ppermute


def _merge(o1, lse1, o2, lse2):
    """Merge two normalized attention partials via their log-sum-exps.
    Accumulates in fp32: the ring casts back to the input dtype only after
    the last merge. Two partials that saw no key (both LSE -1e30) merge to
    O = 0 and an LSE near -1e30, never NaN."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    safe = torch.where(denom == 0.0, 1.0, denom)
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) \
        / safe[..., None]
    lse = torch.where(denom == 0.0, NEG_INF, m + torch.log(safe))
    return o, lse


def _ring_local(q, kv, idx, n, rotate, attend):
    """Rank ``idx``'s schedule of the ring at ``n`` ranks: attend the local
    query chunk to the chunk pair ``kv`` it holds, merge, and move on to
    the pair the rotation brings, n times. ``rotate(kv)`` starts moving the
    held pair one step round the ring (rank i's pair to rank i+1) and
    returns a callable that waits for the pair that arrives; it is started
    before the kernel of the held pair, so that the transfer overlaps it.
    ``attend(q, k, v, q_offset, k_offset)`` returns (O, LSE) of one chunk
    pair; the offsets are host ints in global positions (at step t the
    pair held is chunk idx - t mod n). Returns the fp32 merged output."""
    s_local = q.shape[2]
    o = lse = None
    for t in range(n):
        src = (idx - t) % n
        arrive = rotate(kv) if t < n - 1 else None
        o_t, lse_t = attend(q, *kv, idx * s_local, src * s_local)
        if o is None:
            o, lse = o_t.float(), lse_t
        else:
            o, lse = _merge(o, lse, o_t, lse_t)
        if arrive is not None:
            kv = arrive()
    return o


def ring_attention(q, k, v, axis, *, causal=True, sm_scale=None,
                   impl="flash", block_q=256, block_k=256):
    """Blockwise ring attention over ``axis`` (a process group or 1-D
    ``DeviceMesh``; see ``parallel/axis.py``).

    Args:
      q, k, v: local chunks (batch, heads, seq_local, head_dim); the global
        sequence is ``axis_size * seq_local``, rank i holding positions
        [i*seq_local, (i+1)*seq_local).
      impl: 'flash' (the port's kernels: on CUDA tensors they launch or
        raise; on CPU tensors their plain versions run) or 'einsum'
        (``reference_attention``, the dense oracle).
      block_q, block_k: kept for the JAX signature; the Hopper kernels fix
        their own tiles (64 rows for bf16/fp16, 32 for float32).
    Returns the local output chunk (batch, heads, seq_local, head_dim).
    """
    if impl not in ("flash", "einsum"):
        raise ValueError(f"ring_attention: impl {impl!r} is not 'flash' or "
                         "'einsum'")
    n = axis_size(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    fn = flash_attention if impl == "flash" else reference_attention

    def rotate(kv):
        return ppermute(kv, perm, axis, async_op=True).wait

    def attend(q, k, v, q_offset, k_offset):
        return fn(q, k, v, causal=causal, sm_scale=sm_scale,
                  q_offset=q_offset, k_offset=k_offset, with_lse=True)
    o = _ring_local(q, (k, v), axis_index(axis), n, rotate, attend)
    return o.to(q.dtype)

"""Ulysses-style sequence parallelism: head-scatter all_to_all attention
(port of ``horovod_tpu/parallel/ulysses.py``).

One all_to_all re-shards q, k and v (stacked into one tensor) from
sequence-sharded to head-sharded, attention runs over the *full* sequence
with a subset of heads per rank, and a second all_to_all restores sequence
sharding. Two collectives in all: cheaper than a ring when heads >= the
axis size and the sequence fits one rank's memory; the ring wins for
extreme sequence lengths.
"""

import torch

from ..ops.flash_attention import flash_attention, reference_attention
from .axis import all_to_all, axis_size


def ulysses_attention(q, k, v, axis, *, causal=True, sm_scale=None,
                      impl="flash", block_q=256, block_k=256):
    """Sequence-parallel attention over ``axis`` (a process group or 1-D
    ``DeviceMesh``).

    Args:
      q, k, v: local chunks (batch, heads, seq_local, head_dim); heads must
        be divisible by the axis size.
      impl: 'flash' (the port's kernels) or 'einsum' (the dense oracle).
      block_q, block_k: kept for the JAX signature; the Hopper kernels fix
        their own tiles.
    Returns the local output chunk (batch, heads, seq_local, head_dim).
    """
    if impl not in ("flash", "einsum"):
        raise ValueError(f"ulysses_attention: impl {impl!r} is not 'flash' "
                         "or 'einsum'")
    n = axis_size(axis)
    heads = q.shape[1]
    if heads % n != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({heads}) divisible by the axis "
            f"size ({n}); use ring_attention otherwise")
    # (3, B, H, S/n, D) -> (3, B, H/n, S, D)
    qh, kh, vh = all_to_all(torch.stack((q, k, v)), axis, split_axis=2,
                            concat_axis=3).unbind(0)
    attend = flash_attention if impl == "flash" else reference_attention
    oh = attend(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    # (B, H/n, S, D) -> (B, H, S/n, D)
    return all_to_all(oh, axis, split_axis=2, concat_axis=1)

"""Block rematerialization: flax's ``nn.remat`` for the port's models.

``remat`` is ``False``, ``True``/``"full"`` or ``"dots"``, as the JAX
models' option. A remat block runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its forward
keeps only its inputs, and the backward recomputes it.

- ``True``/``"full"``: nothing inside the block is kept (``nn.remat``).
- ``"dots"``: JAX's ``dots_with_no_batch_dims_saveable`` policy, as a
  selective-checkpoint policy over aten ops. JAX keeps the outputs of a
  ``dot_general`` with no batch dimensions: the dense projections. Their
  aten ops are ``mm`` and ``addmm``: a 3-D ``F.linear`` on a contiguous
  input reaches ``addmm`` on its flattened rows, on the CPU and on the
  H100 alike, as every dense layer of the port's models does. On a
  non-contiguous input it reaches ``bmm``, which is recomputed, as is
  every matmul with batch dimensions (the attention einsums) and
  everything else: elementwise work, normalisations, the flash kernels
  (their launches are no aten op) and convolutions, which are no
  ``dot_general`` in JAX either.

State that a forward updates must move once per step, as flax keeps the
forward's ``batch_stats`` and drops the recompute's. :func:`recomputing`
tells a module that it runs inside a recompute; :func:`stash` gives the
remat region's queue, in which a forward leaves what the recompute must
reuse rather than compute again (the cross-rank BatchNorm sums: the
recompute submits no collective).
"""

import collections
import contextlib
import threading

import torch
from torch.utils import checkpoint as _ckpt

MODES = (False, True, "full", "dots")

_STATE = threading.local()


def check_mode(remat):
    if remat not in MODES:
        raise ValueError(f"remat must be one of {MODES}, got {remat!r}")
    return remat


def recomputing():
    """True while a remat block's forward runs again in the backward."""
    return getattr(_STATE, "recompute", False)


def stash():
    """The current remat region's queue (forward appends, recompute pops
    in the same order), or None outside a remat region."""
    return getattr(_STATE, "stash", None)


@contextlib.contextmanager
def _region(queue, recompute, inner):
    prev = (stash(), recomputing())
    _STATE.stash, _STATE.recompute = queue, recompute
    try:
        with inner:
            yield
    finally:
        _STATE.stash, _STATE.recompute = prev


_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _contexts(remat):
    if remat == "dots":
        fwd, rec = _ckpt.create_selective_checkpoint_contexts(_dots_policy)
    else:
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    queue = collections.deque()
    return _region(queue, False, fwd), _region(queue, True, rec)


def call(remat, fn, *args):
    """``fn(*args)``, as a remat block when ``remat`` is set and autograd
    records (a forward without gradients has nothing to recompute)."""
    if not remat or not torch.is_grad_enabled():
        return fn(*args)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=lambda: _contexts(remat))

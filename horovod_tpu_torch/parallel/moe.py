"""Expert parallelism: top-k gated mixture-of-experts with all_to_all
dispatch (port of ``horovod_tpu/parallel/moe.py``).

Experts shard over the data axes (the dispatch all_to_all rides the wires
the gradient allreduce uses, and data-parallel ranks already hold distinct
tokens). Dispatch and combine use the dense one-hot formulation —
(tokens, experts, capacity) einsums, plain ``torch.einsum`` as the JAX
package left them to XLA. Over-capacity tokens are dropped (their combine
weight is zero): Switch/GShard semantics.

- ``moe_apply``: functional; with ``axis`` (a process group or 1-D
  ``DeviceMesh``) each rank holds its local experts and the buffers travel
  by all_to_all; with ``axis=None`` one program holds every expert.
- ``MoELayer``: the module (the JAX package's flax ``MoELayer``); the aux
  loss of its last forward is ``layer.aux_loss``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .axis import all_to_all, axis_size, pmean, vary_replicated


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _top_k_dispatch(gate_logits, k, capacity):
    """Build dispatch/combine tensors from gate logits.

    Returns (dispatch (T,E,C) 0/1 float, combine (T,E,C) float,
    aux_loss scalar).
    """
    t, e = gate_logits.shape
    dev = gate_logits.device
    gates = torch.softmax(gate_logits.float(), dim=-1)

    dispatch = torch.zeros((t, e, capacity), device=dev)
    combine = torch.zeros((t, e, capacity), device=dev)
    masked = gate_logits.float()
    # Tokens already routed in earlier slots occupy expert capacity first.
    fill = torch.zeros((e,), device=dev)
    density_sum = torch.zeros((e,), device=dev)
    for _ in range(k):
        choice = masked.argmax(dim=-1)                          # (T,)
        onehot = F.one_hot(choice, e).float()                   # (T,E)
        density_sum = density_sum + onehot.mean(dim=0)
        # Position of each token within its chosen expert's buffer.
        pos = (onehot.cumsum(dim=0) - 1.0) + fill[None, :]
        pos = (pos * onehot).sum(dim=-1)                        # (T,)
        keep = pos < capacity
        pos = pos.clamp(0, capacity - 1).long()
        slot = F.one_hot(pos, capacity).float()                 # (T,C)
        d = onehot[:, :, None] * slot[:, None, :]
        d = d * keep[:, None, None]
        dispatch = dispatch + d
        prob = (gates * onehot).sum(dim=-1)                     # (T,)
        combine = combine + d * prob[:, None, None]
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        masked = torch.where(onehot > 0, -1e30, masked)

    # Renormalize the kept top-k probabilities.
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / torch.where(denom == 0, 1.0, denom)
    # GShard load-balancing auxiliary loss.
    density = density_sum / k
    mean_gate = gates.mean(dim=0)
    aux = e * (density * mean_gate).sum()
    return dispatch, combine, aux


def moe_apply(x, w_gate, w_in, w_out, *, axis=None, k=2,
              capacity_factor=1.25, activation=_gelu):
    """Apply the MoE FFN to tokens.

    Args:
      x: (tokens, d_model) local tokens.
      w_gate: (d_model, n_experts_global), replicated.
      w_in: (experts_local, d_model, d_ff) — this rank's experts when
        ``axis`` is set (rank r holds experts [r*E_local, (r+1)*E_local)),
        all experts otherwise.
      w_out: (experts_local, d_ff, d_model).
      axis: the expert-parallel axis, or None for one program.
    Returns (y (tokens, d_model), aux_loss scalar; averaged over ``axis``).
    With ``axis`` the replicated ``w_gate`` goes through
    ``axis.vary_replicated``, so that its gradient comes out summed over
    the ranks' tokens on every rank (the pvary JAX inserts).
    """
    tokens, d = x.shape
    e_global = w_gate.shape[1]
    n = axis_size(axis) if axis is not None else 1
    e_local = w_in.shape[0]
    if e_local * n != e_global:
        raise ValueError(
            f"w_in holds {e_local} experts x {n} ranks != gate's {e_global}")
    capacity = max(int(np.ceil(k * tokens * capacity_factor / e_global)), 1)
    if axis is not None:
        w_gate = vary_replicated(w_gate, axis)

    logits = x.float() @ w_gate.float()
    dispatch, combine, aux = _top_k_dispatch(logits, k, capacity)

    expert_in = torch.einsum("td,tec->ecd", x.float(),
                             dispatch).to(x.dtype)             # (E, C, d)
    if axis is not None:
        # Each rank keeps its local experts' buffers from every rank:
        # (E, C, d) -> (E_local, n*C, d).
        expert_in = all_to_all(expert_in, axis, split_axis=0, concat_axis=1)
    h = torch.einsum("ecd,edf->ecf", expert_in, w_in.to(expert_in.dtype))
    h = activation(h)
    out = torch.einsum("ecf,efd->ecd", h, w_out.to(h.dtype))
    if axis is not None:
        # (E_local, n*C, d) -> (E, C, d): results back to the ranks whose
        # tokens they are.
        out = all_to_all(out, axis, split_axis=1, concat_axis=0)
    y = torch.einsum("ecd,tec->td", out.float(), combine)
    if axis is not None:
        # Load statistics are per rank; average the aux loss across ranks.
        aux = pmean(aux, axis)
    return y.to(x.dtype), aux


def _lecun_normal_(w, fan_in, generator=None):
    """flax's ``lecun_normal``: a normal truncated at ±2 std, the std
    chosen so that the variance is 1 / fan_in."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class MoELayer(nn.Module):
    """MoE FFN block over (batch, seq, d_model) inputs (the JAX package's
    flax ``MoELayer``: parameters ``w_gate`` (d, E), ``w_in`` (E, d, d_ff),
    ``w_out`` (E, d_ff, d), lecun-normal). One program holds every expert.
    ``forward`` returns y in ``dtype`` and leaves the load-balancing loss
    in ``self.aux_loss`` (what flax sows as ``moe_aux_loss``)."""

    def __init__(self, d_model, n_experts, d_ff, k=2, capacity_factor=1.25,
                 dtype=torch.float32, *, generator=None):
        super().__init__()
        self.n_experts, self.d_ff = n_experts, d_ff
        self.k, self.capacity_factor, self.dtype = k, capacity_factor, dtype
        self.w_gate = nn.Parameter(torch.empty(d_model, n_experts))
        self.w_in = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.w_out = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        for w in (self.w_gate, self.w_in, self.w_out):
            _lecun_normal_(w, w.shape[-2], generator)
        self.aux_loss = None

    def forward(self, x):
        b, s, d = x.shape
        y, self.aux_loss = moe_apply(
            x.reshape(b * s, d), self.w_gate, self.w_in, self.w_out,
            k=self.k, capacity_factor=self.capacity_factor)
        return y.reshape(b, s, d).to(self.dtype)


def params_from_flax(params):
    """State dict for :class:`MoELayer` from the flax parameter tree of
    ``horovod_tpu.parallel.MoELayer`` (leaves as numpy arrays; the outer
    ``{"params": ...}`` wrapper is optional). The layouts are the same."""
    p = params.get("params", params)
    return {name: torch.tensor(np.asarray(p[name], dtype=np.float32))
            for name in ("w_gate", "w_in", "w_out")}

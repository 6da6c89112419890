"""Cross-rank synchronized BatchNorm (port of
``horovod_tpu/torch/sync_batch_norm.py``; reference:
horovod/torch/sync_batch_norm.py).

The forward sums each channel's values, squares and count across the
process set in one allreduce, so the statistics are those of the set's
whole batch; the backward allreduces ``sum_dy`` and ``sum_dy_xmu``, the two
sums the chain rule needs. The count stays a tensor on the device: reading
it on the host would make the host wait for the device at every layer.
Statistics are computed in float32 whatever the input's dtype; the output
has the input's dtype. Parameter gradients stay local (the
DistributedOptimizer reduces them like any other gradient).

Inside a remat block of the port's models (``models/_remat.py``) the
forward leaves its set-wide sums in the block's queue and the recompute
takes them from there: the recompute submits no collective and updates no
running statistic.
"""

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from ..models import _remat
from ..ops import reduce_ops
from ..ops.collectives import allreduce_
from ..process_sets import global_process_set


class SyncBatchNorm(_BatchNorm):
    """Drop-in BatchNorm1d/2d/3d replacement whose training statistics
    span every rank of ``process_set``. Outside training, or in a set of
    one rank, it is torch's BatchNorm."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_set=global_process_set):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self.process_set = process_set

    def _check_input_dim(self, input):  # noqa: A002 (torch API name)
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input):  # noqa: A002 (torch API name)
        if not (self.training and len(self.process_set.ranks) > 1):
            return super().forward(input)
        self._check_input_dim(input)
        factor = 0.0 if self.momentum is None else self.momentum
        if self.track_running_stats and self.num_batches_tracked is not None \
                and not _remat.recomputing():
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                # A cumulative average reads the counter on the host, as
                # torch's BatchNorm does: the host waits here.
                factor = 1.0 / float(self.num_batches_tracked)
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, factor, self.process_set, True)


class _SyncBatchNormFn(torch.autograd.Function):
    """Batch normalization over the set's whole batch. ``unbiased`` picks
    the running variance torch keeps (unbiased) or flax keeps (the biased
    batch variance)."""

    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var, eps,
                momentum, process_set, unbiased):
        c = input.shape[1]
        dims = [0] + list(range(2, input.dim()))
        shape = [1, c] + [1] * (input.dim() - 2)
        x = input.float()
        queue, recompute = _remat.stash(), _remat.recomputing()
        if recompute:
            packed = queue.popleft()
        else:
            count = torch.full((1,), float(input.numel() // c),
                               dtype=torch.float32, device=input.device)
            packed = allreduce_(torch.cat([x.sum(dims), (x * x).sum(dims),
                                           count]),
                                op=reduce_ops.Sum, process_set=process_set)
            if queue is not None:
                queue.append(packed)
        total = packed[-1:]
        mean = packed[:c] / total
        var = (packed[c:2 * c] / total - mean * mean).clamp_min(0)
        invstd = torch.rsqrt(var + eps)
        if running_mean is not None and not recompute:
            with torch.no_grad():
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                if unbiased:
                    var = var * total / (total - 1).clamp_min(1)
                running_var.mul_(1 - momentum).add_(momentum * var)
        out = (x - mean.view(shape)) * invstd.view(shape)
        if weight is not None:
            out = out * weight.view(shape)
        if bias is not None:
            out = out + bias.view(shape)
        ctx.save_for_backward(input, weight, mean, invstd, total)
        ctx.process_set = process_set
        return out.to(input.dtype)

    @staticmethod
    def backward(ctx, grad_output):
        input, weight, mean, invstd, total = ctx.saved_tensors
        c = input.shape[1]
        dims = [0] + list(range(2, input.dim()))
        shape = [1, c] + [1] * (input.dim() - 2)
        dy = grad_output.float()
        xmu = input.float() - mean.view(shape)
        sum_dy = dy.sum(dims)
        sum_dy_xmu = (dy * xmu).sum(dims)
        # The statistics' gradients span the set's whole batch.
        packed = allreduce_(torch.cat([sum_dy, sum_dy_xmu]),
                            op=reduce_ops.Sum, process_set=ctx.process_set)
        inv = invstd.view(shape)
        grad_input = (dy - packed[:c].view(shape) / total
                      - xmu * inv * inv * packed[c:].view(shape) / total) * inv
        if weight is not None:
            grad_input = grad_input * weight.view(shape)
        grad_weight = sum_dy_xmu * invstd \
            if weight is not None and ctx.needs_input_grad[1] else None
        grad_bias = sum_dy if ctx.needs_input_grad[2] else None
        return (grad_input.to(input.dtype), grad_weight, grad_bias, None,
                None, None, None, None, None)


def convert_sync_batchnorm(module, process_set=global_process_set):
    """Replace every BatchNorm of ``module`` with a SyncBatchNorm sharing
    its parameters and buffers (torch.nn.SyncBatchNorm's
    convert_sync_batchnorm)."""
    out = module
    if isinstance(module, _BatchNorm) and not isinstance(module,
                                                         SyncBatchNorm):
        out = SyncBatchNorm(module.num_features, module.eps,
                            module.momentum, module.affine,
                            module.track_running_stats,
                            process_set=process_set)
        if module.affine:
            # The same Parameter objects: optimizers already holding them
            # go on updating the right tensors.
            out.weight = module.weight
            out.bias = module.bias
        out.running_mean = module.running_mean
        out.running_var = module.running_var
        out.num_batches_tracked = module.num_batches_tracked
    for name, child in module.named_children():
        out.add_module(name, convert_sync_batchnorm(child, process_set))
    return out

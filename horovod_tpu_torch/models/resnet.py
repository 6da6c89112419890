"""ResNet family, v1.5 bottleneck (port of ``horovod_tpu/models/resnet.py``).

Plain ``nn.Module``s taking NCHW input (on the card, pass
``memory_format=torch.channels_last`` tensors and convert the model the
same way). They compute what the flax model computes:

- fp32 parameters with a compute ``dtype``: every conv casts its input and
  kernel to it; the head is a float32 dense layer;
- flax's ``"SAME"`` padding: where the total padding is odd (a 3×3
  stride-2 conv or max-pool on an even size) the extra row and column go
  after, (0, 1), not torch's symmetric ``padding=1``; the max-pool pads
  with −inf;
- flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``: statistics in float32
  whatever the compute dtype, and the BIASED batch variance in
  ``running_var`` (flax's ``batch_stats``; torch's ``BatchNorm2d`` keeps
  the unbiased one); the last BatchNorm of each block starts at scale 0;
- ``process_set`` (flax's ``axis_name``): the statistics span the set's
  whole batch, summed through the port's collectives;
- ``remat`` (``False``, ``True``/``"full"``, ``"dots"``, flax's
  ``nn.remat`` of each block, ``_remat.py``): the block is recomputed in
  the backward. ``"dots"`` is JAX's ``dots_with_no_batch_dims_saveable``
  policy, which keeps only dense projections' outputs: a block holds
  convolutions, which are no ``dot_general``, so ``"dots"`` keeps nothing
  of it and recomputes as much as ``True``. The running statistics move
  once per step, as flax keeps the forward's ``batch_stats``: the
  recompute normalises with its batch's statistics and updates nothing,
  and with a ``process_set`` it reuses the forward's set-wide sums, so it
  submits no collective.

Submodule names mirror flax's (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>``, ``Conv_<j>``, ``BatchNorm_<j>``, ``conv_proj``,
``norm_proj``, ``Dense_0``), so that :func:`params_from_flax` maps a flax
checkpoint onto the ``state_dict`` name for name.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import _remat
from ._flax import state_dict_from_flax

# flax's lecun_normal: truncated normal, variance 1/fan_in; the stddev is
# divided by that of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def same_pads(size, kernel, stride):
    """flax/XLA ``"SAME"`` padding ``((lo, hi), ...)`` of each spatial dim:
    the output has ceil(size / stride) positions and an odd total puts
    the extra element after."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pad(x, pads, value=0.0):
    (t, b), (left, right) = pads
    return F.pad(x, (left, right, t, b), value=value)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` in NCHW: computes in ``dtype``; ``padding`` is
    ``"SAME"`` or explicit ``((top, bottom), (left, right))``."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding="SAME",
                 bias=False, dtype=torch.bfloat16, device=None,
                 generator=None):
        super().__init__(in_ch, out_ch, kernel, stride, bias=bias,
                         device=device)
        self.flax_padding = padding
        self.compute_dtype = dtype
        _lecun_normal_(self.weight, in_ch * self.kernel_size[0]
                       * self.kernel_size[1], generator)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        pads = self.flax_padding
        if pads == "SAME":
            pads = same_pads(x.shape[-2:], self.kernel_size, self.stride)
        dt = self.compute_dtype
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        x = x.to(dt)
        (t, bot), (left, right) = pads
        if t == bot and left == right:
            return F.conv2d(x, w, b, self.stride, (t, left))
        return F.conv2d(_pad(x, pads), w, b, self.stride)


class BatchNorm(nn.BatchNorm2d):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW: float32
    statistics, the biased batch variance in ``running_var``, the output
    in the input's dtype. With ``process_set`` the training statistics
    span the set's whole batch (flax's ``axis_name``)."""

    def __init__(self, num_features, process_set=None, zero_scale=False,
                 device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1,
                         device=device)
        self.process_set = process_set
        if zero_scale:
            nn.init.zeros_(self.weight)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        m = self.momentum
        if self.process_set is not None:
            # Under remat the function reuses the forward's sums and
            # updates no statistic in the recompute.
            if not _remat.recomputing():
                self.num_batches_tracked.add_(1)
            from ..torch.sync_batch_norm import _SyncBatchNormFn
            return _SyncBatchNormFn.apply(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, m, self.process_set, False)
        # torch updates copies of the running statistics (autograd may keep
        # the variance it was given), which are written back after: torch's
        # variance update is (1 - m) prev + m u, u the unbiased variance
        # b n / (n - 1), and flax keeps (1 - m) prev + m b. A remat block's
        # recompute writes nothing back: it runs no aten op its forward
        # did not (selective checkpointing replays the forward's ops).
        mean, var = self.running_mean.clone(), self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, m,
                           self.eps)
        if not _remat.recomputing():
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.copy_(mean)
                self.running_var.mul_((1 - m) / n).add_(var,
                                                        alpha=(n - 1) / n)
        return out


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch, filters, stride, conv, norm):
        super().__init__()
        out_ch = filters * 4
        self.Conv_0 = conv(in_ch, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, stride)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out_ch, 1)
        self.BatchNorm_2 = norm(out_ch, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_ch != out_ch:
            self.conv_proj = conv(in_ch, out_ch, 1, stride)
            self.norm_proj = norm(out_ch)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x if self.conv_proj is None \
            else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, filters, stride, conv, norm):
        super().__init__()
        self.Conv_0 = conv(in_ch, filters, 3, stride)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3)
        self.BatchNorm_1 = norm(filters, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_ch != filters:
            self.conv_proj = conv(in_ch, filters, 1, stride)
            self.norm_proj = norm(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x if self.conv_proj is None \
            else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


def _space_to_depth(x, block=2):
    """NCHW space-to-depth: (B, C, H, W) -> (B, b*b*C, H/b, W/b) with the
    flax model's channel order (di*b + dj)*C + c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, block * block * c, h // block, w // block)


def stem_weights_to_space_to_depth(w7):
    """Map a (7, 7, C, F) flax stem kernel to the equivalent (4, 4, 4C, F)
    space-to-depth kernel (zero-pad to 8×8, fold the 2×2 phase into input
    channels), so that a checkpoint of either stem loads into the other."""
    w7 = np.asarray(w7)
    k, _, c, f = w7.shape
    if k != 7:
        raise ValueError(f"expected a (7, 7, C, F) kernel, got {w7.shape}")
    w8 = np.zeros((8, 8, c, f), w7.dtype)
    w8[1:8, 1:8] = w7
    w4 = np.zeros((4, 4, 4 * c, f), w7.dtype)
    for da in range(2):
        for db in range(2):
            w4[:, :, (da * 2 + db) * c:(da * 2 + db + 1) * c] = \
                w8[da::2, db::2]
    return w4


class ResNet(nn.Module):
    """ResNet over NCHW images. ``stem`` is ``"conv"`` (7×7 stride 2) or
    ``"space_to_depth"`` (the input folded to (4C, H/2, W/2) and an
    equivalent 4×4 stride-1 conv)."""

    def __init__(self, stage_sizes, block_cls, num_classes=1000,
                 num_filters=64, dtype=torch.bfloat16, process_set=None,
                 remat=False, stem="conv", in_channels=3, device=None,
                 generator=None):
        super().__init__()
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        self.dtype = dtype
        self.remat = _remat.check_mode(remat)
        self.stem = stem
        conv = functools.partial(Conv, dtype=dtype, device=device,
                                 generator=generator)
        norm = functools.partial(BatchNorm, process_set=process_set,
                                 device=device)
        if stem == "space_to_depth":
            # pad (4, 3) in pixels = (2, 1) in 2×2 blocks.
            self.conv_init = conv(4 * in_channels, num_filters, 4,
                                  padding=((2, 1), (2, 1)))
        else:
            self.conv_init = conv(in_channels, num_filters, 7, 2,
                                  padding=((3, 3), (3, 3)))
        self.bn_init = norm(num_filters)
        self.blocks = []
        in_ch, i = num_filters, 0
        for stage, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if stage > 0 and j == 0 else 1
                filters = num_filters * 2 ** stage
                block = block_cls(in_ch, filters, stride, conv, norm)
                self.add_module(f"{block_cls.__name__}_{i}", block)
                self.blocks.append(block)
                in_ch, i = filters * block_cls.expansion, i + 1
        self.Dense_0 = nn.Linear(in_ch, num_classes, device=device)
        _lecun_normal_(self.Dense_0.weight, in_ch, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x):
        if self.stem == "space_to_depth":
            x = _space_to_depth(x)
        x = F.relu(self.bn_init(self.conv_init(x)))
        pads = same_pads(x.shape[-2:], (3, 3), (2, 2))
        x = F.max_pool2d(_pad(x, pads, float("-inf")), 3, 2)
        for block in self.blocks:
            x = _remat.call(self.remat, block, x)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x.to(self.Dense_0.weight.dtype))


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)


def params_from_flax(variables):
    """``state_dict`` of :class:`ResNet` from the flax ``params`` and
    ``batch_stats`` of ``horovod_tpu.models.ResNet`` (numpy leaves)."""
    return state_dict_from_flax(variables)


"""Small models for MNIST-scale runs (port of ``horovod_tpu/models/mlp.py``;
reference: examples/keras/keras_mnist.py).

``MnistCNN`` takes NCHW images where the flax model takes NHWC: its first
dense layer sees the features flattened in (C, H, W) order, so
:func:`mnist_cnn_params_from_flax` permutes the rows of the flax kernel,
which come in (H, W, C) order. ``MLP`` flattens its input as given; feed it
the layout the flax weights were trained on (for one-channel images both
layouts flatten alike).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ._flax import state_dict_from_flax
from .resnet import Conv, _lecun_normal_


def _dense(fan_in, fan_out, device, generator):
    layer = nn.Linear(fan_in, fan_out, device=device)
    _lecun_normal_(layer.weight, fan_in, generator)
    nn.init.zeros_(layer.bias)
    return layer


class MLP(nn.Module):
    """Plain MLP classifier: ReLU dense layers of ``features``, then a dense
    head of ``num_classes``."""

    def __init__(self, in_features, features=(128, 64), num_classes=10,
                 device=None, generator=None):
        super().__init__()
        self.layers = []
        for i, f in enumerate(list(features) + [num_classes]):
            layer = _dense(in_features, f, device, generator)
            self.add_module(f"Dense_{i}", layer)
            self.layers.append(layer)
            in_features = f

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class MnistCNN(nn.Module):
    """LeNet-style CNN of the reference MNIST example: conv 32, conv 64
    (3×3, SAME), 2×2 max-pool, dense 128, dense head; computes in ``dtype``
    up to a float32 head."""

    def __init__(self, num_classes=10, dtype=torch.float32, in_channels=1,
                 image_hw=(28, 28), device=None, generator=None):
        super().__init__()
        self.compute_dtype = dtype
        conv = dict(bias=True, dtype=dtype, device=device,
                    generator=generator)
        self.Conv_0 = Conv(in_channels, 32, 3, **conv)
        self.Conv_1 = Conv(32, 64, 3, **conv)
        flat = 64 * (image_hw[0] // 2) * (image_hw[1] // 2)
        self.Dense_0 = _dense(flat, 128, device, generator)
        self.Dense_1 = _dense(128, num_classes, device, generator)

    def forward(self, x):
        dt = self.compute_dtype
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        x = F.max_pool2d(x, 2, 2).reshape(x.shape[0], -1)
        x = F.relu(F.linear(x, self.Dense_0.weight.to(dt),
                            self.Dense_0.bias.to(dt)))
        return self.Dense_1(x.to(self.Dense_1.weight.dtype))


def mlp_params_from_flax(variables):
    """``state_dict`` of :class:`MLP` from ``horovod_tpu.models.MLP``'s flax
    variables (numpy leaves)."""
    return state_dict_from_flax(variables)


def mnist_cnn_params_from_flax(variables, image_hw=(28, 28)):
    """``state_dict`` of :class:`MnistCNN` from the flax variables of
    ``horovod_tpu.models.MnistCNN`` trained on ``image_hw`` images: the
    rows of ``Dense_0``'s kernel go from flax's (H, W, C) flatten order to
    the (C, H, W) order of an NCHW flatten."""
    sd = state_dict_from_flax(variables)
    w = sd["Dense_0.weight"]                      # (128, H*W*C)
    h, wd = image_hw[0] // 2, image_hw[1] // 2
    c = w.shape[1] // (h * wd)
    sd["Dense_0.weight"] = w.reshape(-1, h, wd, c).permute(
        0, 3, 1, 2).reshape(w.shape[0], -1).contiguous()
    return sd

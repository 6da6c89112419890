"""Model zoo of the port (``horovod_tpu/models``). ``params_from_flax`` is
the TransformerLM's and BertModel's converter; the ResNet's and the small models' live in
their modules (``resnet.params_from_flax``, ``mlp.mlp_params_from_flax``,
``mlp.mnist_cnn_params_from_flax``)."""

from . import mlp, resnet
from .mlp import MLP, MnistCNN
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNet18, ResNet50,
                     ResNet101, stem_weights_to_space_to_depth)
from .transformer import (BertConfig, BertModel, TransformerConfig,
                          TransformerLM, params_from_flax)

"""Elastic Keras state + callbacks under ``horovod_tpu_torch.keras`` (port
of ``horovod_tpu/keras/elastic.py``; reference: horovod/keras/elastic.py:22 KerasState, :34-76 elastic
callbacks).
"""

from ..elastic import run  # noqa: F401
from ..tensorflow.elastic import TensorFlowKerasState


class KerasState(TensorFlowKerasState):
    """State of a Keras model and optimizer for elastic training
    (reference: horovod/keras/elastic.py:22)."""


_LAZY = ("CommitStateCallback", "UpdateBatchStateCallback",
         "UpdateEpochStateCallback")


def __getattr__(name):
    """Lazy class creation, cached in module globals so repeated access
    returns the SAME class (isinstance/identity checks must hold). The
    name check comes FIRST so attribute probes for other names raise
    AttributeError without importing keras."""
    if name not in _LAZY:
        raise AttributeError(name)
    from .._keras.elastic import make_elastic_callbacks
    globals().update(zip(_LAZY, make_elastic_callbacks()))
    return globals()[name]

"""TensorFlow/Keras elastic state on the port's runtime (port of
``horovod_tpu/tensorflow/elastic.py``; reference:
horovod/tensorflow/elastic.py:221 ``TensorFlowKerasState``).

Holds in-memory snapshots of a Keras model's weights (and optimizer
variables) plus user scalars; ``sync()`` re-broadcasts them from the new
rank 0 after an elastic reset, through the runtime's device.
"""

import copy

import numpy as np

from ..elastic import State
from ..functions import broadcast_object


def _get_opt_weights(optimizer):
    if optimizer is None:
        return None
    try:
        return [np.asarray(v) for v in optimizer.variables]
    except (AttributeError, TypeError):
        return None


def _set_opt_weights(optimizer, weights):
    if optimizer is None or weights is None:
        return
    for var, w in zip(optimizer.variables, weights):
        var.assign(w)


class TensorFlowKerasState(State):
    """Elastic state for a Keras model (+ optimizer) and scalars."""

    def __init__(self, model, optimizer=None, **kwargs):
        super().__init__()
        self.model = model
        self.optimizer = optimizer or getattr(model, "optimizer", None)
        self._scalars = list(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._saved = None
        self.save()

    def _scalar_state(self):
        return {k: getattr(self, k) for k in self._scalars}

    def save(self):
        self._saved = {
            "weights": [np.array(w) for w in self.model.get_weights()],
            "opt": _get_opt_weights(self.optimizer),
            "scalars": copy.deepcopy(self._scalar_state()),
        }

    def restore(self):
        self.model.set_weights([np.array(w)
                                for w in self._saved["weights"]])
        _set_opt_weights(self.optimizer, self._saved["opt"])
        for k, v in self._saved["scalars"].items():
            # Deepcopy on the way OUT too: handing the snapshot's mutable
            # objects to the user by reference would let later in-place
            # edits corrupt the committed state.
            setattr(self, k, copy.deepcopy(v))

    def sync(self):
        from . import broadcast_arrays
        synced = broadcast_arrays(self.model.get_weights(), root_rank=0)
        self.model.set_weights(synced)
        payload = {
            "opt": _get_opt_weights(self.optimizer),
            "scalars": self._scalar_state(),
        }
        synced_payload = broadcast_object(payload, root_rank=0,
                                          name="tf_elastic_state")
        _set_opt_weights(self.optimizer, synced_payload["opt"])
        for k, v in synced_payload["scalars"].items():
            setattr(self, k, v)
        self.save()

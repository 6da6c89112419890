"""Keras callback set under the ``horovod.tensorflow.keras`` namespace on
the port (port of ``horovod_tpu/tensorflow/keras/callbacks.py``; reference: horovod/tensorflow/keras/callbacks.py:22-151). The classes
are the shared backend-agnostic implementations (.._keras.callbacks),
bound lazily so importing this module never imports keras.
"""


def _make():
    from ..._keras.callbacks import make_callbacks
    return make_callbacks()


def _best_model_checkpoint():
    import keras

    class BestModelCheckpoint(keras.callbacks.ModelCheckpoint):
        """save_best_only ModelCheckpoint (reference:
        horovod/tensorflow/keras/callbacks.py:151 — used by the Spark
        estimator to keep the best epoch's weights; ``filepath`` may be
        assigned after construction, as the reference does)."""

        def __init__(self, filepath=None, monitor="val_loss", verbose=0,
                     save_weights_only=False, mode="auto",
                     save_freq="epoch"):
            super().__init__(filepath=filepath or "", monitor=monitor,
                             verbose=verbose, save_best_only=True,
                             save_weights_only=save_weights_only,
                             mode=mode, save_freq=save_freq)

    return BestModelCheckpoint


_LAZY = ("BroadcastGlobalVariablesCallback", "MetricAverageCallback",
         "LearningRateWarmupCallback", "LearningRateScheduleCallback")


def __getattr__(name):
    """Lazy class creation, cached in module globals so repeated access
    returns the SAME class (isinstance/identity checks must hold). The
    name check comes FIRST so attribute probes for other names raise
    AttributeError without importing keras."""
    if name == "BestModelCheckpoint":
        cls = _best_model_checkpoint()
        globals()[name] = cls
        return cls
    if name not in _LAZY:
        raise AttributeError(name)
    globals().update(zip(_LAZY, _make()))
    return globals()[name]

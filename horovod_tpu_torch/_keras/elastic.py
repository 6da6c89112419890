"""Keras elastic callbacks (port of ``horovod_tpu/_keras/elastic.py``;
reference: horovod/_keras/elastic.py:86):
commit state on a batch cadence and keep epoch/batch counters inside the
elastic State so training resumes where it left off."""


def make_elastic_callbacks():
    import keras

    base = keras.callbacks.Callback

    class CommitStateCallback(base):
        """Commit the elastic state every ``batches_per_commit`` batches
        (reference: CommitStateCallbackImpl)."""

        def __init__(self, state, batches_per_commit=1):
            super().__init__()
            self.state = state
            self.batches_per_commit = batches_per_commit

        def on_train_batch_end(self, batch, logs=None):
            if (batch + 1) % self.batches_per_commit == 0:
                self.state.commit()

        def on_epoch_end(self, epoch, logs=None):
            self.state.commit()

    class UpdateBatchStateCallback(base):
        """Track state.batch so a restore resumes mid-epoch (reference:
        UpdateBatchStateCallbackImpl)."""

        def __init__(self, state):
            super().__init__()
            self.state = state

        def on_train_batch_end(self, batch, logs=None):
            self.state.batch = batch + 1

        def on_epoch_end(self, epoch, logs=None):
            self.state.batch = 0

    class UpdateEpochStateCallback(base):
        """Track state.epoch (reference: UpdateEpochStateCallbackImpl)."""

        def __init__(self, state):
            super().__init__()
            self.state = state

        def on_epoch_end(self, epoch, logs=None):
            self.state.epoch = epoch + 1

    return (CommitStateCallback, UpdateBatchStateCallback,
            UpdateEpochStateCallback)

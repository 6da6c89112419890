"""Keras callback set on the port's runtime (port of
``horovod_tpu/_keras/callbacks.py``; reference:
horovod/_keras/callbacks.py:200): weight broadcast at train start,
cross-rank metric averaging, LR warmup and schedules. Backend-agnostic —
weights move as numpy lists through the runtime's device.
"""

import numpy as np
import torch

from . import rank, size, spmd_active
from .. import basics
from ..ops import collectives as _c


def _keras():
    import keras
    return keras


def _callback_base():
    return _keras().callbacks.Callback


class BroadcastGlobalVariablesCallbackImpl:
    """Broadcast initial model + optimizer state from root_rank so all
    ranks start identical (reference: callbacks.py
    BroadcastGlobalVariablesCallback)."""

    def __init__(self, root_rank=0):
        self.root_rank = root_rank
        self._done = False

    def on_train_begin(self, logs=None):
        if self._done or not spmd_active():
            return
        from ..tensorflow import broadcast_arrays
        model = self.model
        model.set_weights(broadcast_arrays(model.get_weights(),
                                           root_rank=self.root_rank))
        self._done = True


class MetricAverageCallbackImpl:
    """Average epoch metrics across ranks (reference: callbacks.py
    MetricAverageCallback)."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs or not spmd_active():
            return
        keys = sorted(k for k, v in logs.items()
                      if isinstance(v, (int, float, np.floating,
                                        np.integer)))
        if not keys:
            return
        vec = torch.tensor([float(logs[k]) for k in keys],
                           dtype=torch.float64, device=basics.device())
        avg = _c.allreduce(vec, name=f"metric_avg.{epoch}").tolist()
        for k, v in zip(keys, avg):
            logs[k] = float(v)


class LearningRateWarmupCallbackImpl:
    """Scale LR from initial_lr/size .. initial_lr over warmup_epochs
    (reference: callbacks.py LearningRateWarmupCallback — gradual warmup
    per Goyal et al. 2017)."""

    def __init__(self, initial_lr, warmup_epochs=5, momentum_correction=True,
                 steps_per_epoch=None, verbose=0):
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self._current_epoch = 0

    def _set_lr(self, lr):
        opt = self.model.optimizer
        try:
            opt.learning_rate = lr
        except AttributeError:
            opt.lr = lr

    def on_epoch_begin(self, epoch, logs=None):
        self._current_epoch = epoch
        if epoch >= self.warmup_epochs:
            return
        # Linear ramp from initial_lr (end of warmup) / size to full.
        base = self.initial_lr / max(1, size())
        progress = (epoch + 1) / self.warmup_epochs
        lr = base + (self.initial_lr - base) * progress
        self._set_lr(lr)
        if self.verbose and rank() == 0:
            print(f"Epoch {epoch}: warmup LR = {lr:.6g}")


class LearningRateScheduleCallbackImpl:
    """Multiply LR by ``multiplier`` within [start_epoch, end_epoch)
    (reference: callbacks.py LearningRateScheduleCallback)."""

    def __init__(self, initial_lr, multiplier, start_epoch=0,
                 end_epoch=None, staircase=True, momentum_correction=True,
                 steps_per_epoch=None, verbose=0):
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.verbose = verbose
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def on_epoch_begin(self, epoch, logs=None):
        if epoch < self.start_epoch:
            return
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return
        lr = self.initial_lr * self.multiplier(epoch)
        opt = self.model.optimizer
        try:
            opt.learning_rate = lr
        except AttributeError:
            opt.lr = lr
        if self.verbose and rank() == 0:
            print(f"Epoch {epoch}: scheduled LR = {lr:.6g}")


def make_callbacks():
    """Bind the impl mixins to the installed keras' Callback base (late so
    importing horovod_tpu never imports keras)."""
    base = _callback_base()

    class BroadcastGlobalVariablesCallback(BroadcastGlobalVariablesCallbackImpl,
                                           base):
        def __init__(self, root_rank=0):
            base.__init__(self)
            BroadcastGlobalVariablesCallbackImpl.__init__(self, root_rank)

    class MetricAverageCallback(MetricAverageCallbackImpl, base):
        def __init__(self):
            base.__init__(self)

    class LearningRateWarmupCallback(LearningRateWarmupCallbackImpl, base):
        def __init__(self, *a, **kw):
            base.__init__(self)
            LearningRateWarmupCallbackImpl.__init__(self, *a, **kw)

    class LearningRateScheduleCallback(LearningRateScheduleCallbackImpl,
                                       base):
        def __init__(self, *a, **kw):
            base.__init__(self)
            LearningRateScheduleCallbackImpl.__init__(self, *a, **kw)

    return (BroadcastGlobalVariablesCallback, MetricAverageCallback,
            LearningRateWarmupCallback, LearningRateScheduleCallback)

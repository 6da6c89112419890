"""Torch elastic state objects (port of ``horovod_tpu/torch/elastic.py``;
reference: horovod/torch/elastic/state.py:89-174 ``TorchState``,
horovod/torch/elastic/sampler.py:122 ``ElasticSampler``).

``TorchState(model=..., optimizer=..., epoch=0, ...)`` snapshots
state_dicts in memory at ``commit()``, restores them after a failure, and
re-broadcasts from the new rank 0 after a reset. The snapshot is a copy of
every tensor on the device it lives on. ``sync`` broadcasts the model's
tensors with ``broadcast_parameters`` and the optimizer's with
``broadcast_optimizer_state``, in place, as the reference's state handlers
do; only plain values are pickled.
"""

import copy

import torch

from ..elastic import ObjectState, State, run, run_fn  # noqa: F401
from ..functions import (allgather_object, broadcast_object,
                         broadcast_optimizer_state, broadcast_parameters)


class TorchState(State):
    """Elastic state holding torch modules/optimizers plus scalars."""

    def __init__(self, model=None, optimizer=None, sampler=None, **kwargs):
        super().__init__()
        self._handlers = {}
        if model is not None:
            self._handlers["model"] = model
            self.model = model
        if optimizer is not None:
            self._handlers["optimizer"] = optimizer
            self.optimizer = optimizer
        self._sampler = sampler
        if sampler is not None:
            self.sampler = sampler
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._saved = None
        self.save()

    _TRACKED_TYPES = (int, float, bool, str, bytes, list, tuple, dict,
                      set, type(None))

    def _scalar_state(self):
        """Public attributes of plain-value types, including ones set
        after construction, so `state.best_loss = x` participates in
        commit/restore/sync. Complex objects (a SummaryWriter, a
        DataLoader) attached as conveniences are deliberately NOT swept:
        they are often non-picklable and would crash commit()/sync()."""
        import numpy as _np
        skip = set(self._handlers)
        if self._sampler is not None:
            skip.add("sampler")
        tracked = self._TRACKED_TYPES + (_np.ndarray, _np.generic,
                                         torch.Tensor)
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_") and k not in skip
                and isinstance(v, tracked)}

    def save(self):
        self._saved = {
            "handlers": {k: copy.deepcopy(v.state_dict())
                         for k, v in self._handlers.items()},
            "scalars": copy.deepcopy(self._scalar_state()),
        }
        if self._sampler is not None:
            self._saved["sampler"] = {
                "epoch": self._sampler.epoch,
                "processed": set(self._sampler.processed_indices),
            }

    def restore(self):
        for k, sd in self._saved["handlers"].items():
            self._handlers[k].load_state_dict(copy.deepcopy(sd))
        for k, v in self._saved["scalars"].items():
            setattr(self, k, v)
        if self._sampler is not None and "sampler" in self._saved:
            self._sampler.epoch = self._saved["sampler"]["epoch"]
            self._sampler.processed_indices = set(
                self._saved["sampler"]["processed"])
            self._sampler.reset()

    def sync(self):
        for value in self._handlers.values():
            if isinstance(value, torch.optim.Optimizer):
                broadcast_optimizer_state(value, root_rank=0)
            else:
                broadcast_parameters(value.state_dict(), root_rank=0)
        synced = broadcast_object(self._scalar_state(), root_rank=0,
                                  name="torch_elastic_state")
        for k, v in synced.items():
            setattr(self, k, v)
        if self._sampler is not None:
            # Union every rank's processed indices so the new shard split
            # is identical everywhere (reference: SamplerStateHandler
            # allgathers processed indices, torch/elastic/state.py).
            all_processed = allgather_object(
                sorted(self._sampler.processed_indices),
                name="elastic_sampler_sync")
            merged = set()
            for chunk in all_processed:
                merged.update(chunk)
            self._sampler.processed_indices = merged
            self._sampler.reset()
        self.save()


class ElasticSampler:
    """Minimal elastic-aware sampler (reference: sampler.py): shards
    indices by current rank/size and skips indices already processed
    since the last commit, so a reset resumes mid-epoch."""

    def __init__(self, dataset, shuffle=True, seed=0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices = set()
        self.reset()

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx, batch_size):
        start = batch_idx * batch_size
        self.processed_indices.update(self.indices[start:start + batch_size])

    def reset(self):
        from .. import basics
        rt = basics.runtime() if basics.is_initialized() else None
        if rt is not None and rt.mode == basics.MODE_SPMD:
            rank, nranks = rt.topology.rank, rt.topology.size
        else:
            rank, nranks = 0, 1
        remaining = [i for i in range(len(self.dataset))
                     if i not in self.processed_indices]
        if self.shuffle:
            import random
            random.Random(self.seed + self.epoch).shuffle(remaining)
        self.indices = remaining[rank::nranks]

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)

"""Collectives on Python objects, parameters and optimizer state (port of
``horovod_tpu/functions.py``; reference: horovod/torch/functions.py).

Objects travel as pickled bytes in a uint8 tensor on the runtime's device,
preceded by their length, in broadcasts of at most ``OBJECT_CHUNK_BYTES``
each (a full-width model with its optimizer state pickles to several GB;
no plane is asked to move 2**31 bytes or more in one collective). Only
bytes this program's own ranks pickled are ever unpickled.
"""

import pickle

import torch

from . import basics

#: Largest piece of a pickled object one broadcast moves.
OBJECT_CHUNK_BYTES = 1 << 30
from .ops.collectives import allgather, broadcast, broadcast_async_
from .process_sets import global_process_set


def _to_bytes_tensor(obj):
    buf = bytearray(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    return torch.frombuffer(buf, dtype=torch.uint8).to(basics.device())


def _from_bytes_tensor(t):
    return pickle.loads(memoryview(t.cpu().numpy()))


def broadcast_object(obj, root_rank=0, name=None,
                     process_set=global_process_set):
    """``root_rank``'s ``obj`` on every rank of the set."""
    dev = basics.device()
    if basics.rank() == root_rank:
        payload = _to_bytes_tensor(obj)
    else:
        payload = torch.zeros(0, dtype=torch.uint8, device=dev)
    length = broadcast(torch.tensor([payload.numel()], dtype=torch.int64,
                                    device=dev), root_rank,
                       process_set=process_set)
    if basics.rank() != root_rank:
        payload = torch.empty(int(length.item()), dtype=torch.uint8,
                              device=dev)
    handles = [broadcast_async_(payload[i:i + OBJECT_CHUNK_BYTES],
                                root_rank, process_set=process_set)
               for i in range(0, payload.numel(), OBJECT_CHUNK_BYTES)]
    for h in handles:
        h.wait()
    return _from_bytes_tensor(payload)


def allgather_object(obj, name=None, process_set=global_process_set):
    """Every member's ``obj``, as a list in the set's rank order."""
    payload = _to_bytes_tensor(obj)
    sizes = allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                   device=payload.device),
                      process_set=process_set).tolist()
    gathered = allgather(payload, process_set=process_set)
    objs, off = [], 0
    for s in sizes:
        objs.append(_from_bytes_tensor(gathered[off:off + s]))
        off += s
    return objs


def broadcast_parameters(params, root_rank=0, process_set=global_process_set):
    """Overwrite every tensor of ``params`` with ``root_rank``'s value, in
    place, on every rank of the set. ``params`` is a ``state_dict()``, a
    mapping of names to tensors, or an iterable of ``(name, tensor)`` pairs
    such as ``model.named_parameters()``. Every broadcast is launched
    before the first is waited for. Returns ``params``."""
    items = params.items() if hasattr(params, "items") else params
    # detach() shares storage: the broadcast lands in the parameter.
    handles = [broadcast_async_(tensor.detach(), root_rank,
                                process_set=process_set)
               for _, tensor in sorted(items, key=lambda kv: kv[0])]
    for h in handles:
        h.wait()
    return params


# The JAX package's name for the same operation.
broadcast_variables = broadcast_parameters


class _Slot:
    """Where a device tensor of an optimizer state stood in the pickled
    structure: it travels by a tensor broadcast instead."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


def broadcast_optimizer_state(optimizer, root_rank=0,
                              process_set=global_process_set):
    """Load ``root_rank``'s state into ``optimizer`` on every rank. As the
    reference's does (horovod/torch/functions.py), every state tensor on
    the runtime's device is broadcast in place, all in flight at once;
    only the rest (the structure, the hyperparameters and host tensors
    such as AdamW's step counts) travels as one pickled object. A rank
    whose optimizer has no state yet gets it allocated from the root's
    shapes."""
    dev = basics.device()
    root = basics.rank() == root_rank
    tensors = []

    def strip(obj):
        if isinstance(obj, torch.Tensor):
            if obj.device == dev:
                tensors.append(obj)
                return _Slot(tuple(obj.shape), obj.dtype)
            return obj.detach().cpu()
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(strip(v) for v in obj)
        return obj

    def fill(obj):
        if isinstance(obj, _Slot):
            t = torch.empty(obj.shape, dtype=obj.dtype, device=dev)
            tensors.append(t)
            return t
        if isinstance(obj, dict):
            return {k: fill(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(fill(v) for v in obj)
        return obj

    skeleton = broadcast_object(strip(optimizer.state_dict()) if root
                                else None, root_rank,
                                process_set=process_set)
    state = None if root else fill(skeleton)
    handles = [broadcast_async_(t, root_rank, process_set=process_set)
               for t in tensors]
    for h in handles:
        h.wait()
    if not root:
        optimizer.load_state_dict(state)
    return optimizer

"""``horovod_tpu_torch.torch``: Horovod's PyTorch API, the namespace that
user scripts import as ``hvd`` (port of ``horovod_tpu/torch/__init__.py``;
reference: horovod/torch/mpi_ops.py, horovod/torch/optimizer.py).

Every collective goes through the runtime's coordinator: named, fused and,
in a launcher job, negotiated across ranks by the native core before NCCL
(CUDA tensors), the native TCP ring or gloo (CPU tensors) executes it.
Results keep the input's dtype and device. Async ops return a handle at
once; ``synchronize(handle)`` returns the result (written back in place
for the ``*_`` spellings) and ``poll(handle)`` never blocks. On CUDA,
``synchronize`` makes the caller's stream wait for the transfer; the host
waits only until the collective has been issued.

``DistributedOptimizer`` is the reference's grad-hook wrapper: each
parameter's post-accumulate-grad hook submits
``allreduce_async_(grad, name=f"grad.{name}")`` while backward still runs,
and ``step()`` synchronizes every handle before the inner update. Ranks may
produce their gradients in different orders: the native core pairs them
by name.

``hvd.elastic`` (``torch/elastic.py``) holds ``TorchState``,
``ElasticSampler`` and ``run``.

Gradient-reduction options: ``compression=`` on every allreduce and on
``DistributedOptimizer`` (``Compression.fp16``/``bf16`` cast at this layer
around the collective; ``int8``/``fp8`` mark the entry for the data
plane's quantized pipeline), ``op=Adasum`` (the native core's VHDD on the
host; CUDA tensors staged through pinned memory) and
``sparse_allreduce_async`` for COO gradients (``HVDTPU_SPARSE`` picks
allgather-of-slices or densify per tensor). ``metrics_snapshot()`` is the
runtime's metrics registry (``HOROVOD_TPU_METRICS``), as JSON-able data.
"""

import functools

import torch

from .. import basics
from .. import functions as _functions
from ..basics import (ccl_built, cross_rank, cross_size, cuda_built,
                      ddl_built, gloo_built, gloo_enabled, init,
                      is_homogeneous, is_initialized, local_rank, local_size,
                      mpi_built, mpi_enabled, mpi_threads_supported,
                      nccl_built, rank, rocm_built, shutdown, size)
from ..ops import collectives as _c
from ..ops import reduce_ops
from ..ops.collectives import poll, synchronize
from ..ops.compression import Compression
from ..process_sets import (ProcessSet, add_process_set, global_process_set,
                            remove_process_set)
from ..exceptions import DuplicateNameError, StalledTensorError  # noqa: F401
from ..utils import envparse
from ..utils.logging_util import get_logger
from .compile import tpu_compile

Average = reduce_ops.Average
Sum = reduce_ops.Sum
Adasum = reduce_ops.Adasum
Min = reduce_ops.Min
Max = reduce_ops.Max
Product = reduce_ops.Product


def _spmd():
    """A launcher job, at any size: the native core negotiates (the JAX
    package's rule, without its size > 1: a one-rank launcher job runs the
    native plane here)."""
    return basics.runtime().mode == basics.MODE_SPMD


def start_timeline(file_path, mark_cycles=None, jax_profiler_dir=None):
    """Start recording a Chrome-trace timeline (reference:
    horovod/common/basics.py:156). ``jax_profiler_dir`` keeps the JAX
    package's name: a ``torch.profiler`` trace of the host and the card is
    written there beside the timeline. ``mark_cycles`` defaults to
    ``HVDTPU_TIMELINE_MARK_CYCLES``."""
    from ..timeline import Timeline
    rt = basics.runtime()
    if rt.timeline is not None:
        rt.timeline.stop()
    if mark_cycles is None:
        mark_cycles = envparse.get_bool(envparse.TIMELINE_MARK_CYCLES)
    rt.timeline = Timeline(file_path, profiler_dir=jax_profiler_dir,
                           mark_cycles=mark_cycles)
    rt.timeline.start()


def stop_timeline():
    """Stop the runtime timeline (reference: horovod/common/basics.py
    stop_timeline)."""
    rt = basics.runtime()
    if rt.timeline is not None:
        rt.timeline.stop()
        rt.timeline = None


metrics_snapshot = basics.metrics_snapshot


def _op(op, average):
    return reduce_ops.handle_average_backwards_compatibility(op, average)


def _allreduce_impl(tensor, op, name, prescale, postscale, process_set,
                    inplace, compression):
    """One allreduce with its compression: a wire codec (``int8``/``fp8``)
    marks the entry for the data plane's quantized pipeline; a cast
    compressor (``fp16``/``bf16``) casts here, reduces the narrow copy in
    place and casts the result back (into ``tensor`` for ``inplace``)."""
    kw = dict(op=op, name=name, prescale_factor=prescale,
              postscale_factor=postscale, process_set=process_set)
    wire = getattr(compression, "wire_codec", None)
    plain = _c.allreduce_async_ if inplace else _c.allreduce_async
    if compression in (None, Compression.none) or wire is not None:
        return plain(tensor, codec=wire, **kw)
    narrow, ctx = compression.compress(tensor)
    if narrow is tensor:
        return plain(tensor, **kw)

    def finish(reduced):
        out = compression.decompress(reduced, ctx)
        return tensor.copy_(out) if inplace else out
    return _c.then(_c.allreduce_async_(narrow, **kw), finish)


# --------------------------------------------------------------------------
# allreduce
# --------------------------------------------------------------------------
def allreduce_async(tensor, average=None, name=None, compression=None,
                    op=None, prescale_factor=1.0, postscale_factor=1.0,
                    process_set=global_process_set):
    """Handle of the reduced copy of ``tensor``. Argument order follows the
    reference (horovod/torch/mpi_ops.py:211), so positional callers bind
    correctly."""
    return _allreduce_impl(tensor, _op(op, average), name, prescale_factor,
                           postscale_factor, process_set, False, compression)


def allreduce_async_(tensor, average=None, name=None, compression=None,
                     op=None, prescale_factor=1.0, postscale_factor=1.0,
                     process_set=global_process_set):
    """Handle of the in-place reduction of ``tensor``."""
    return _allreduce_impl(tensor, _op(op, average), name, prescale_factor,
                           postscale_factor, process_set, True, compression)


def allreduce(tensor, average=None, name=None, compression=None,
              op=None, prescale_factor=1.0, postscale_factor=1.0,
              process_set=global_process_set):
    return synchronize(allreduce_async(
        tensor, average, name, compression, op, prescale_factor,
        postscale_factor, process_set=process_set))


def allreduce_(tensor, average=None, name=None, compression=None,
               op=None, prescale_factor=1.0, postscale_factor=1.0,
               process_set=global_process_set):
    return synchronize(allreduce_async_(
        tensor, average, name, compression, op, prescale_factor,
        postscale_factor, process_set=process_set))


def _done_handle(name, result):
    from ..coordinator import Handle
    basics.runtime().check_alive()
    h = Handle(name)
    h._complete(result)
    return h


def sparse_allreduce_async(tensor, name=None, op=None,
                           process_set=global_process_set):
    """Average (or sum) a sparse COO tensor across the set by allgathering
    its indices and values (reference: horovod/torch/mpi_ops.py:556, the
    same allgather formulation); the handle resolves to a coalesced COO
    tensor, its duplicates summed on the tensor's device.

    With the sparse plane on (``HVDTPU_SPARSE``) and a row-sparse tensor
    (one sparse dim, an embedding's gradient), the density policy may pick
    densify-then-allreduce past the crossover: the handle then resolves to
    a dense tensor."""
    if not tensor.is_sparse:
        raise ValueError("sparse_allreduce_async requires a sparse tensor")
    op = Average if op is None else op
    if op not in (Average, Sum):
        raise ValueError(
            f"sparse_allreduce_async supports Average/Sum, got "
            f"{reduce_ops.op_name(op)}")
    t = tensor.coalesce()
    if not _spmd():
        return _done_handle(name or "sparse_allreduce", t)
    from ..ops import sparse as sparse_ops
    plane = sparse_ops._plane()
    # A per-call-site name: one shared fallback would pool every unnamed
    # tensor into one density EMA and collide their .idx/.val names.
    nm = name or _c._auto_name("sparse_allreduce")
    if plane is not None and t.sparse_dim() == 1:
        path = sparse_ops.choose_path(
            plane, nm, int(t.indices().shape[1]), tuple(t.shape),
            t.values().element_size(), 8, process_set)
        if path == "dense":
            return allreduce_async(t.to_dense(), name=nm, op=op,
                                   process_set=process_set)
    shape = tuple(t.shape)
    world = len(process_set.ranks)

    def combine(gathered):
        idx, vals = gathered
        out = torch.sparse_coo_tensor(idx.t(), vals, size=shape).coalesce()
        if op == Average:
            out = torch.sparse_coo_tensor(out.indices(),
                                          out.values() / world,
                                          size=shape).coalesce()
        return out
    return sparse_ops.gather_async(
        nm, [("idx", t.indices().t()), ("val", t.values())], process_set,
        combine)


def sparse_allreduce(tensor, name=None, op=None,
                     process_set=global_process_set):
    return synchronize(sparse_allreduce_async(tensor, name, op, process_set))


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=global_process_set):
    """Handle of the reduced copies of ``tensors`` (reference:
    horovod/torch/mpi_ops.py:375)."""
    tensors = list(tensors)
    return _c.grouped_allreduce_async(tensors, op=_op(op, average),
                                      name=name,
                                      prescale_factor=prescale_factor,
                                      postscale_factor=postscale_factor,
                                      process_set=process_set)


def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             process_set=global_process_set):
    tensors = list(tensors)
    return _c.grouped_allreduce_async_(tensors, op=_op(op, average),
                                       name=name,
                                       prescale_factor=prescale_factor,
                                       postscale_factor=postscale_factor,
                                       process_set=process_set)


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      process_set=global_process_set):
    return synchronize(grouped_allreduce_async(
        tensors, average, name, op, process_set=process_set))


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       process_set=global_process_set):
    return synchronize(grouped_allreduce_async_(
        tensors, average, name, op, prescale_factor, postscale_factor,
        process_set=process_set))


# --------------------------------------------------------------------------
# allgather, broadcast, alltoall, reducescatter
# --------------------------------------------------------------------------
def grouped_allgather(tensors, name=None, process_set=global_process_set):
    return _c.grouped_allgather(list(tensors), name, process_set)


def grouped_reducescatter(tensors, op=None, name=None,
                          process_set=global_process_set):
    return _c.grouped_reducescatter(list(tensors), _op(op, None), name,
                                    process_set)


def allgather_async(tensor, name=None, process_set=global_process_set):
    return _c.allgather_async(tensor, name, process_set)


def allgather(tensor, name=None, process_set=global_process_set):
    return synchronize(allgather_async(tensor, name, process_set))


def broadcast_async(tensor, root_rank, name=None,
                    process_set=global_process_set):
    return _c.broadcast_async(tensor, root_rank, name, process_set)


def broadcast_async_(tensor, root_rank, name=None,
                     process_set=global_process_set):
    return _c.broadcast_async_(tensor, root_rank, name, process_set)


def broadcast(tensor, root_rank, name=None, process_set=global_process_set):
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def broadcast_(tensor, root_rank, name=None, process_set=global_process_set):
    return synchronize(broadcast_async_(tensor, root_rank, name,
                                        process_set))


def alltoall_async(tensor, splits=None, name=None,
                   process_set=global_process_set):
    """Handle resolving to the received tensor, or to ``(received,
    received_splits)`` when ``splits`` was given."""
    handle = _c.alltoall_async(tensor, splits, name, process_set)
    if splits is not None:
        return handle
    return _c.then(handle, lambda r: r[0])


def alltoall(tensor, splits=None, name=None, process_set=global_process_set):
    return synchronize(alltoall_async(tensor, splits, name, process_set))


def reducescatter(tensor, op=None, name=None,
                  process_set=global_process_set):
    return _c.reducescatter(tensor, _op(op, None), name, process_set)


def join(device=-1):
    """The last rank to join, through the native core; -1 in a
    single-process job (as the JAX package's torch binding answers there)."""
    if not _spmd():
        return -1
    return _c.join(device)


def barrier(process_set=global_process_set):
    _c.barrier(process_set)


# --------------------------------------------------------------------------
# objects, parameters, optimizer state
# --------------------------------------------------------------------------
def broadcast_object(obj, root_rank=0, name=None,
                     process_set=global_process_set):
    return _functions.broadcast_object(obj, root_rank, name, process_set)


def allgather_object(obj, name=None, process_set=global_process_set):
    return _functions.allgather_object(obj, name, process_set)


def broadcast_parameters(params, root_rank=0,
                         process_set=global_process_set):
    """Overwrite a ``state_dict()`` or ``named_parameters()`` with
    ``root_rank``'s values (reference: horovod/torch/functions.py
    broadcast_parameters). Non-tensor entries of a mapping ride the object
    path, keyed by name."""
    items = list(params.items()) if hasattr(params, "items") \
        else list(params)
    _functions.broadcast_parameters(
        [(n, t) for n, t in items if torch.is_tensor(t)], root_rank,
        process_set)
    other = {n: v for n, v in items if not torch.is_tensor(v)}
    if other and hasattr(params, "items"):
        params.update(broadcast_object(other, root_rank,
                                       process_set=process_set))


def broadcast_optimizer_state(optimizer, root_rank=0,
                              process_set=global_process_set):
    """Load ``root_rank``'s optimizer state on every rank (reference:
    horovod/torch/functions.py broadcast_optimizer_state)."""
    _functions.broadcast_optimizer_state(optimizer, root_rank, process_set)


# --------------------------------------------------------------------------
# the grad-hook optimizer
# --------------------------------------------------------------------------
def _sparse_grad_handle(param, op, name, process_set, postscale):
    """Submit a sparse gradient from the optimizer hook (the gradient is
    complete when the hook fires); waiting writes the result back to
    ``param.grad``, re-sparsified when the density policy resolved dense,
    so the layout the inner optimizer sees never changes."""
    grad = param.grad
    if postscale != 1.0:
        grad = grad * postscale
    handle = sparse_allreduce_async(grad, name=name, op=op,
                                    process_set=process_set)

    def write_back(out):
        if not out.is_sparse:
            out = out.to_sparse(grad.sparse_dim()).coalesce()
        param.grad = out
        return out
    return _c.then(handle, write_back)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=None, backward_passes_per_step=1,
                         op=Average, gradient_predivide_factor=1.0,
                         num_groups=0, groups=None, sparse_as_dense=False,
                         process_set=global_process_set):
    """Wrap ``optimizer`` in place so that its ``step()`` applies gradients
    averaged (or summed, ``op=Sum``) across the set (reference:
    horovod/torch/optimizer.py:36-275; the JAX package's binding,
    ``horovod_tpu/torch/__init__.py:725-811``).

    In a launcher job each optimizer-owned parameter that requires grad gets
    a post-accumulate-grad hook. Every ``backward_passes_per_step``-th time
    it fires, it submits ``allreduce_async_(grad, name=f"grad.{name}")``;
    the coordinator's native core fuses the gradients under
    ``HVDTPU_FUSION_THRESHOLD`` (this takes the place of
    ``num_groups``/``groups``) and pairs them across ranks by name, so the
    ranks' backward passes may produce them in any order. ``step()`` (and
    ``synchronize()``) waits for every handle, then runs the inner update.
    Gradients are multiplied by ``1 / gradient_predivide_factor`` before
    the sum and by ``gradient_predivide_factor / backward_passes_per_step``
    after the average. In a single-process job no hook is registered and
    the update is the inner one.

    ``compression`` applies to every dense gradient (casts here, wire
    codecs in the data plane); ``op=Adasum`` reduces each gradient with
    Adasum. Sparse gradients (``nn.Embedding(sparse=True)``):
    ``sparse_as_dense=True`` densifies them; otherwise, with
    ``HVDTPU_SPARSE`` set, they go through :func:`sparse_allreduce_async`
    and the result written back to ``.grad`` stays sparse whichever path
    the policy picked, so that sparse-only optimizers
    (``torch.optim.SparseAdam``) survive a change of path; with the knob
    unset they densify.
    """
    if compression is Compression.none:
        compression = None
    if op not in (Average, Sum, Adasum):
        raise ValueError(f"DistributedOptimizer op must be Average, Sum or "
                         f"Adasum, got {reduce_ops.op_name(op)}")
    if op == Adasum and getattr(compression, "wire_codec", None):
        raise ValueError(
            f"compression={compression.wire_codec!r} with op=Adasum: "
            "Adasum needs exact per-rank gradients (quantizing them "
            "silently changes the scale-invariant combination)")
    if gradient_predivide_factor != 1.0 and op != Average:
        raise ValueError("gradient_predivide_factor needs op=Average")
    if getattr(optimizer, "_hvd_wrapped", False):
        raise ValueError(
            "optimizer is already wrapped by DistributedOptimizer; "
            "wrapping twice would allreduce every gradient twice")
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError("backward_passes_per_step must be >= 1")

    if named_parameters is not None:
        named = list(named_parameters)
    else:
        named = [(f"param.{gi}.{pi}", p)
                 for gi, group in enumerate(optimizer.param_groups)
                 for pi, p in enumerate(group["params"])]
    name_of = {p: n for n, p in named}
    owned = [p for group in optimizer.param_groups for p in group["params"]]
    if any(p.requires_grad and p not in name_of for p in owned):
        raise ValueError(
            "named_parameters does not cover all optimizer parameters; pass "
            "model.named_parameters() for the whole model behind this "
            "optimizer")
    cls = type(optimizer)

    class _Distributed(cls):
        _hvd_wrapped = True

        def synchronize(self):
            """Wait for every submitted gradient: ``.grad`` holds the
            reduced values."""
            for handle in list(self._hvd_handles.values()):
                _c.synchronize(handle)
            self._hvd_handles.clear()

        def step(self, closure=None):
            if not self._hvd_sync_disabled:
                self.synchronize()
            return cls.step(self, closure)

    optimizer.__class__ = _Distributed
    # An LR scheduler built before this wrapper shadows .step with an
    # instance attribute around the original class's step, which would
    # skip synchronize(): wrap that attribute too.
    inst_step = optimizer.__dict__.get("step")
    if inst_step is not None:
        @functools.wraps(inst_step)
        def _dist_inst_step(closure=None):
            if not optimizer._hvd_sync_disabled:
                optimizer.synchronize()
            return inst_step() if closure is None else inst_step(closure)
        optimizer.step = _dist_inst_step

    optimizer._hvd_backward_passes = k
    optimizer._hvd_sync_disabled = not _spmd()
    optimizer._hvd_handles = {}
    optimizer._hvd_hook_handles = []
    if optimizer._hvd_sync_disabled:
        return optimizer
    prescale, postscale = 1.0, 1.0
    if gradient_predivide_factor != 1.0:
        prescale = 1.0 / gradient_predivide_factor
        postscale = gradient_predivide_factor
    postscale /= k
    passes = {}

    def hook(p):
        passes[p] = passes.get(p, 0) + 1
        if passes[p] % k or p.grad is None:
            return
        if p.grad.is_sparse:
            from ..ops import sparse as sparse_ops
            if not sparse_as_dense and sparse_ops.enabled():
                optimizer._hvd_handles[p] = _sparse_grad_handle(
                    p, op, f"grad.{name_of[p]}", process_set, postscale)
                return
            p.grad = p.grad.to_dense()
        optimizer._hvd_handles[p] = allreduce_async_(
            p.grad, op=op, name=f"grad.{name_of[p]}",
            prescale_factor=prescale, postscale_factor=postscale,
            compression=compression, process_set=process_set)

    owned_ids = {id(p) for p in owned}
    for _, p in named:
        # Only optimizer-owned parameters: named_parameters may cover the
        # whole model while this optimizer trains a part of it.
        if p.requires_grad and id(p) in owned_ids:
            optimizer._hvd_hook_handles.append(
                p.register_post_accumulate_grad_hook(hook))
    return optimizer


def __getattr__(name):
    # Lazy exports of the reference surface (horovod/torch exposes
    # SyncBatchNorm and the elastic submodule at top level), cached in
    # globals for identity.
    if name == "SyncBatchNorm":
        from .sync_batch_norm import SyncBatchNorm
        globals()[name] = SyncBatchNorm
        return SyncBatchNorm
    if name == "elastic":
        # importlib, not `from . import`: the from-import form checks
        # hasattr(package, "elastic") mid-import and re-enters this
        # __getattr__ forever.
        import importlib
        mod = importlib.import_module(".elastic", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(name)

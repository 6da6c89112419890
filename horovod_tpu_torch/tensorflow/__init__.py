"""TensorFlow 2 binding on the port's runtime (port of
``horovod_tpu/tensorflow/__init__.py``): the drop-in surface of the
reference's ``horovod.tensorflow`` (reference:
horovod/tensorflow/__init__.py:29-43, mpi_ops.py).

Process-level semantics, as in the reference: one process per GPU
(launched by ``python -m horovod_tpu_torch.runner.launch``), ``rank()`` and
``size()`` from the launcher's topology, collectives on the port's data
plane. A TF tensor goes to numpy, then to a torch tensor on the runtime's
device (the card on a CUDA runtime), through the port's collective, and
back. Inside ``tf.function`` graphs the same path runs through
``tf.py_function``: the host-side enqueue is the boundary the reference
crosses with its custom-op kernels (reference:
horovod/tensorflow/mpi_ops.cc:431 ComputeAsync). A result has its input's
dtype: float64 and int64 travel whole.

TensorFlow is imported at the first use, never at import.
"""

import numpy as np
import torch

from .. import basics
from ..ops import reduce_ops
from ..ops import collectives as _c
from ..ops.compression import Compression
from ..process_sets import (ProcessSet, global_process_set,  # noqa: F401
                            add_process_set, remove_process_set)
from ..utils.logging_util import get_logger

Average = reduce_ops.Average
Sum = reduce_ops.Sum
Adasum = reduce_ops.Adasum
Min = reduce_ops.Min
Max = reduce_ops.Max
Product = reduce_ops.Product

init = basics.init
shutdown = basics.shutdown
is_initialized = basics.is_initialized
local_rank = basics.local_rank
local_size = basics.local_size
cross_rank = basics.cross_rank
cross_size = basics.cross_size
is_homogeneous = basics.is_homogeneous
mpi_enabled = basics.mpi_enabled
mpi_built = basics.mpi_built
mpi_threads_supported = basics.mpi_threads_supported
gloo_enabled = basics.gloo_enabled
gloo_built = basics.gloo_built
nccl_built = basics.nccl_built
ddl_built = basics.ddl_built
ccl_built = basics.ccl_built
cuda_built = basics.cuda_built
rocm_built = basics.rocm_built
metrics_snapshot = basics.metrics_snapshot

from . import elastic  # noqa: E402,F401  (hvd.elastic.TensorFlowKerasState)


def gpu_available():
    """Reference: horovod/tensorflow/__init__.py gpu_available: True when
    a CUDA device is there for the runtime."""
    return torch.cuda.is_available()


def check_num_rank_power_of_2(num_ranks):
    """Reference: horovod/tensorflow/__init__.py:138-154 (Adasum's
    power-of-2 rank requirement)."""
    if num_ranks == 0 or num_ranks & (num_ranks - 1):
        raise ValueError(
            "Adasum allreduce requires a power-of-2 number of ranks; "
            f"got {num_ranks}")


def start_timeline(file_path, mark_cycles=None, jax_profiler_dir=None):
    """Reference: horovod/common/basics.py:156 start_timeline."""
    from ..torch import start_timeline as _st
    return _st(file_path, mark_cycles=mark_cycles,
               jax_profiler_dir=jax_profiler_dir)


def stop_timeline():
    from ..torch import stop_timeline as _st
    return _st()


def _tf():
    import tensorflow as tf
    return tf


def rank():
    """Process-level rank (the launcher's topology)."""
    return basics.rank()


def size():
    return basics.size()


def _spmd():
    """True when collectives span processes: a launcher job of more than
    one rank. A lone process behaves as world size 1."""
    return basics.runtime().mode == basics.MODE_SPMD and basics.size() > 1


# Graph-op variants (reference: horovod/tensorflow/mpi_ops.py:410-472
# rank/size query ops usable inside graphs). Under ELASTIC mode they
# resolve at graph EXECUTION time (py_function) — the runtime re-forms
# with new ranks/sizes on membership changes, so a tf.function that
# captured one must observe the NEW value after a reset. Outside elastic
# mode rank/size are fixed for the process lifetime, and a tf.constant
# keeps jit_compile=True / SavedModel export working.
def _runtime_scalar_op(fn, name):
    tf = _tf()
    from ..utils import envparse
    if not envparse.get_bool(envparse.ELASTIC):
        return tf.constant(np.int32(fn()), name=name)

    def _value():
        return np.int32(fn())

    out = tf.py_function(_value, [], tf.int32, name=name)
    out.set_shape(())
    return out


def _process_set_size(process_set_id):
    if process_set_id in (0, None):
        return size()
    from ..process_sets import process_set_by_id
    ps = process_set_by_id(process_set_id)
    if ps is None:
        raise ValueError(f"no process set with id {process_set_id}")
    return len(ps.ranks)


def rank_op(name=None):
    return _runtime_scalar_op(rank, name or "horovod_rank")


def local_rank_op(name=None):
    return _runtime_scalar_op(local_rank, name or "horovod_local_rank")


def size_op(process_set_id=0, name=None):
    return _runtime_scalar_op(
        lambda: _process_set_size(process_set_id),
        name or f"horovod_size_ps{process_set_id}")


def local_size_op(name=None):
    return _runtime_scalar_op(local_size, name or "horovod_local_size")


def process_set_included_op(process_set=global_process_set, name=None):
    """1 when this rank belongs to process_set, else 0 (reference:
    horovod/tensorflow/mpi_ops.py process_set_included_op). Accepts a
    ProcessSet object or a numeric process_set_id."""
    def _included():
        ps = process_set
        if isinstance(ps, int):
            from ..process_sets import process_set_by_id
            ps = process_set_by_id(process_set)
            if ps is None:
                raise ValueError(f"no process set with id {process_set}")
        return 1 if ps.included() else 0

    ps_id = (process_set if isinstance(process_set, int)
             else process_set.process_set_id)
    return _runtime_scalar_op(
        _included, name or f"horovod_process_set_included_ps{ps_id}")


# --------------------------------------------------------------------------
# TF <-> numpy <-> torch on the runtime's device
# --------------------------------------------------------------------------
def _np_of(tensor):
    if isinstance(tensor, np.ndarray):
        return tensor
    if hasattr(tensor, "numpy"):
        return tensor.numpy()
    return np.asarray(_tf().convert_to_tensor(tensor))


def _to_torch(arr):
    """A numpy array as a torch tensor on the runtime's device (bfloat16
    through its bits: numpy's bfloat16 is ml_dtypes'). The tensor owns its
    memory: a TF tensor's numpy view is never written through."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(basics.device())


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _eager(fn, tensors, out_dtypes, shape_preserving=False):
    """Run ``fn`` (torch tensors on the runtime's device -> list of torch
    tensors) now if eager, else through ``tf.py_function`` so that it works
    inside ``tf.function`` graphs. Results come back as TF tensors of
    ``out_dtypes``.

    shape_preserving: for ops whose output shape equals the input shape
    (allreduce/broadcast families), re-attach the static shapes that
    py_function erases — keras-3's optimizer engine calls
    ``grad.shape.as_list()`` and chokes on unknown shapes otherwise."""
    tf = _tf()

    def run(arrays):
        outs = fn([_to_torch(a) for a in arrays])
        out = []
        for o, dt in zip(outs, out_dtypes):
            t = tf.convert_to_tensor(_to_numpy(o))
            out.append(t if t.dtype == dt else tf.cast(t, dt))
        return out

    if tf.executing_eagerly():
        return run([_np_of(t) for t in tensors])

    def wrapper(*args):
        return run([a.numpy() for a in args])

    outs = tf.py_function(func=wrapper, inp=list(tensors), Tout=out_dtypes)
    if shape_preserving:
        outs = [tf.ensure_shape(o, tf.convert_to_tensor(t).shape)
                for o, t in zip(outs, tensors)]
    return outs


def _grouped(tensors, op, name, compression, prescale, postscale,
             process_set):
    """One grouped allreduce of torch tensors with ``compression``: a wire
    codec (int8/fp8) runs inside the data plane, a cast compressor around
    it."""
    comp = Compression.none if compression is None else compression
    wire = getattr(comp, "wire_codec", None)
    narrow, ctxs = [], []
    for t in tensors:
        n, ctx = (t, None) if wire else comp.compress(t)
        narrow.append(n)
        ctxs.append(ctx)
    outs = _c.grouped_allreduce(narrow, op=op, name=name,
                                prescale_factor=prescale,
                                postscale_factor=postscale,
                                process_set=process_set, codec=wire)
    return [comp.decompress(o, ctx) for o, ctx in zip(outs, ctxs)]


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------
def allreduce(tensor, average=None, device_dense="", device_sparse="",
              compression=None, op=None, prescale_factor=1.0,
              postscale_factor=1.0, name=None,
              process_set=global_process_set):
    """Reference: horovod/tensorflow/__init__.py:55-161 ``allreduce``.
    IndexedSlices are densified (the reference's ``sparse_as_dense``
    behavior) before reduction. ``compression`` shrinks the bytes on the
    wire (a cast around the collective, or a quantized wire codec)."""
    tf = _tf()
    if op is None:
        op = Sum if average is False else Average
    if isinstance(tensor, tf.IndexedSlices):
        tensor = tf.convert_to_tensor(tensor)
    if not _spmd():
        scale = prescale_factor * postscale_factor
        return tensor * scale if scale != 1.0 else tf.convert_to_tensor(
            tensor)

    def fn(ts):
        return _grouped(ts, op, name, compression, prescale_factor,
                        postscale_factor, process_set)

    return _eager(fn, [tensor], [tensor.dtype], shape_preserving=True)[0]


def grouped_allreduce(tensors, average=None, op=None, prescale_factor=1.0,
                      postscale_factor=1.0, name=None, compression=None,
                      process_set=global_process_set):
    if op is None:
        op = Sum if average is False else Average
    if not _spmd():
        tf = _tf()
        scale = prescale_factor * postscale_factor
        return [t * scale if scale != 1.0 else tf.convert_to_tensor(t)
                for t in tensors]

    def fn(ts):
        return _grouped(ts, op, name, compression, prescale_factor,
                        postscale_factor, process_set)

    return _eager(fn, tensors, [t.dtype for t in tensors],
                  shape_preserving=True)


def allgather(tensor, name=None, process_set=global_process_set):
    if not _spmd():
        return _tf().convert_to_tensor(tensor)

    def fn(ts):
        return [_c.allgather(ts[0], name=name, process_set=process_set)]

    return _eager(fn, [tensor], [tensor.dtype])[0]


def broadcast(tensor, root_rank, name=None,
              process_set=global_process_set):
    if not _spmd():
        return _tf().convert_to_tensor(tensor)

    def fn(ts):
        return [_c.broadcast(ts[0], root_rank, name=name,
                             process_set=process_set)]

    return _eager(fn, [tensor], [tensor.dtype], shape_preserving=True)[0]


def alltoall(tensor, splits=None, name=None,
             process_set=global_process_set):
    tf = _tf()
    if not _spmd():
        out = tf.convert_to_tensor(tensor)
        if splits is None:
            return out
        return out, tf.convert_to_tensor(np.asarray(splits))

    if splits is None:
        def fn(ts):
            return [_c.alltoall(ts[0], None, name=name,
                                process_set=process_set)]
        return _eager(fn, [tensor], [tensor.dtype])[0]

    def fn(ts):
        out, rsplits = _c.alltoall(ts[0], ts[1].cpu(), name=name,
                                   process_set=process_set)
        return [out, torch.as_tensor(rsplits, dtype=torch.int32)]

    outs = _eager(fn, [tensor, tf.cast(splits, tf.int32)],
                  [tensor.dtype, tf.int32])
    return outs[0], outs[1]


def reducescatter(tensor, op=None, name=None,
                  process_set=global_process_set):
    if not _spmd():
        return _tf().convert_to_tensor(tensor)

    def fn(ts):
        return [_c.reducescatter(ts[0], op=op or Average, name=name,
                                 process_set=process_set)]

    return _eager(fn, [tensor], [tensor.dtype])[0]


def broadcast_(variables, root_rank, name=None,
               process_set=global_process_set):
    """In-place broadcast into tf.Variables (reference:
    horovod/tensorflow/mpi_ops.py:301 ``broadcast_(variables, ...)`` —
    takes a LIST of variables; a single variable is accepted too).
    Returns the updated values (list in, list out)."""
    single = not isinstance(variables, (list, tuple))
    var_list = [variables] if single else list(variables)
    outs = []
    for i, v in enumerate(var_list):
        nm = f"{name}.{i}" if name and not single else name
        out = broadcast(v.read_value() if hasattr(v, "read_value")
                        else v, root_rank, name=nm,
                        process_set=process_set)
        v.assign(out)
        outs.append(v)
    return outs[0] if single else outs


def broadcast_object(obj, root_rank=0, name=None):
    from ..functions import broadcast_object as _bo
    return _bo(obj, root_rank=root_rank, name=name)


def broadcast_object_fn(root_rank=0, name=None):
    """Reference: horovod/tensorflow/functions.py broadcast_object_fn —
    returns a callable capturing root_rank/name."""
    def _fn(obj):
        return broadcast_object(obj, root_rank=root_rank, name=name)
    return _fn


def allgather_object(obj, name=None):
    from ..functions import allgather_object as _ao
    return _ao(obj, name=name)


def broadcast_arrays(arrays, root_rank=0, process_set=global_process_set):
    """``root_rank``'s values of a list of numpy arrays, as numpy arrays:
    one fused broadcast on the runtime's device (the weights of a keras
    model, an optimizer's slots)."""
    from ..functions import broadcast_parameters
    tensors = [_to_torch(a) for a in arrays]
    width = len(str(len(tensors)))
    broadcast_parameters([(str(i).zfill(width), t)
                          for i, t in enumerate(tensors)],
                         root_rank=root_rank, process_set=process_set)
    return [_to_numpy(t) for t in tensors]


def broadcast_variables(variables, root_rank=0):
    """Assign every variable its root-rank value (fused broadcast;
    reference: horovod/tensorflow/functions.py:66). Works inside
    tf.function graphs too — the reference examples call it from a
    @tf.function training step (reference:
    examples/tensorflow2/tensorflow2_mnist.py:75), so the host-side
    exchange rides tf.py_function there, like every collective in this
    binding."""
    tf = _tf()
    variables = list(variables)
    if not variables or not _spmd():
        return

    def assign_all(arrays):
        for v, out in zip(variables, broadcast_arrays(arrays, root_rank)):
            # keras-3 variables report dtype as a STRING; normalize.
            np_dtype = tf.as_dtype(v.dtype).as_numpy_dtype
            v.assign(np.asarray(out).astype(np_dtype, copy=False))

    if tf.executing_eagerly():
        assign_all([v.numpy() for v in variables])
        return

    def wrapper(*args):
        assign_all([a.numpy() for a in args])
        return tf.constant(0, tf.int32)

    tf.py_function(func=wrapper,
                   inp=[tf.convert_to_tensor(v) for v in variables],
                   Tout=[tf.int32])


def join(device=-1):
    if not _spmd():
        return -1
    return _c.join(device)


def barrier(process_set=global_process_set):
    if not _spmd():
        return
    return _c.barrier(process_set=process_set)


class DistributedGradientTape:
    """tf.GradientTape wrapper averaging gradients across ranks
    (reference: horovod/tensorflow/__init__.py:777)."""

    def __init__(self, gradtape, device_dense="", device_sparse="",
                 compression=None, sparse_as_dense=True, op=Average,
                 gradient_predivide_factor=1.0,
                 num_groups=0, groups=None,
                 process_set=global_process_set):
        self._tape = gradtape
        self._op = op
        self._process_set = process_set
        self._predivide = gradient_predivide_factor
        self._num_groups = num_groups
        self._groups = groups
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense

    def __getattr__(self, name):
        return getattr(self._tape, name)

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        if not _spmd():
            return grads
        ngroups, group_ids = _resolve_groups(
            list(sources), self._num_groups, self._groups)
        return _reduce_grads(grads, self._op, self._process_set,
                             self._predivide, ngroups, group_ids,
                             compression=self._compression,
                             sparse_as_dense=self._sparse_as_dense)


def _grouping(n, num_groups, group_ids):
    """Split n gradient slots into fusion buckets (reference:
    horovod/tensorflow/__init__.py:627+ honors num_groups; groups= maps
    variables to explicit buckets). Returns a list of index lists."""
    if group_ids is not None:
        by_gid = {}
        rest = []
        for i in range(n):
            gid = group_ids[i]
            if gid is None:
                rest.append([i])
            else:
                by_gid.setdefault(gid, []).append(i)
        return list(by_gid.values()) + rest
    if num_groups and num_groups > 0:
        return _c.fusion_buckets(n, num_groups)
    return [list(range(n))]


def _sparse_allreduce_tf(slices, op, name, process_set):
    """IndexedSlices through the sparse plane (``sparse_as_dense=False``;
    ops/sparse.py): the ``HVDTPU_SPARSE`` policy picks allgather-of-slices
    or densify-then-allreduce per tensor (with the knob unset every call
    densifies). Returns the DENSE reduced tensor: the transport is sparse,
    the result is what apply_gradients consumes either way."""
    tf = _tf()
    from ..ops import sparse as sparse_ops

    def fn(ts):
        idx, vals, shp = ts
        sg = sparse_ops.SparseGradient(idx.to(torch.int64), vals,
                                       [int(s) for s in shp.tolist()])
        return [sparse_ops.sparse_allreduce(sg, op=op, name=name,
                                            process_set=process_set)]

    # dense_shape rides as an input so graph mode resolves it at
    # execution time like the data tensors (py_function boundary).
    out = _eager(fn, [slices.indices, slices.values,
                      tf.cast(slices.dense_shape, tf.int64)],
                 [slices.values.dtype])[0]
    static = tf.get_static_value(tf.convert_to_tensor(
        slices.dense_shape))
    if static is not None:
        out = tf.ensure_shape(out, [int(s) for s in static])
    return out


def _reduce_grads(grads, op, process_set, predivide=1.0, num_groups=0,
                  group_ids=None, compression=None,
                  sparse_as_dense=True):
    tf = _tf()
    dense_idx, dense = [], []
    result = list(grads)
    for i, g in enumerate(grads):
        if g is None:
            continue
        if isinstance(g, tf.IndexedSlices):
            if not sparse_as_dense:
                # The slices ride the sparse plane (per-tensor gather vs
                # densify policy) instead of the densification below.
                result[i] = _sparse_allreduce_tf(
                    g, op, f"grad_reduce.sp{i}", process_set)
                continue
            g = tf.convert_to_tensor(g)
        dense_idx.append(i)
        dense.append(g)
    if not dense:
        return result
    pre = 1.0 / predivide if predivide != 1.0 else 1.0
    post = predivide if predivide != 1.0 else 1.0
    sub_ids = None if group_ids is None else \
        [group_ids[i] for i in dense_idx]
    for b, bucket in enumerate(_grouping(len(dense), num_groups, sub_ids)):
        outs = grouped_allreduce([dense[j] for j in bucket], op=op,
                                 prescale_factor=pre, postscale_factor=post,
                                 name=f"grad_reduce.g{b}",
                                 compression=compression,
                                 process_set=process_set)
        for j, o in zip(bucket, outs):
            result[dense_idx[j]] = o
    return result


def tpu_compile(fn, example_inputs=None, input_signature=None,
                dynamic_batch=True):
    """Compile a TF2 callable so that its model math runs on the card: the
    traced graph is recorded and interpreted in torch
    (horovod_tpu_torch/tensorflow/compile.py, the port of the JAX
    package's graph -> JAX bridge, the redesign of the reference's
    device-kernel registration, horovod/tensorflow/mpi_ops.cc:486-493 /
    xla_mpi_ops.cc:174-232)."""
    from .compile import tpu_compile as _impl
    return _impl(fn, example_inputs=example_inputs,
                 input_signature=input_signature,
                 dynamic_batch=dynamic_batch)


def _resolve_groups(tvars, num_groups, groups):
    """Normalize the reference's two grouping spellings (reference:
    horovod/tensorflow/__init__.py:627+): ``num_groups`` (int bucket
    count) or ``groups`` (int, or list of lists of variables). Returns
    (num_groups, group_ids) where group_ids maps each grad slot to a
    bucket id (None = ungrouped)."""
    if groups is None:
        return num_groups, None
    if isinstance(groups, int):
        return groups, None
    by_ref = {}
    for gid, bucket in enumerate(groups):
        for v in bucket:
            by_ref[v.ref()] = gid
    return 0, [by_ref.get(v.ref()) for v in tvars]


def DistributedOptimizer(optimizer, name=None, use_locking=False,
                         device_dense="", device_sparse="",
                         compression=None, sparse_as_dense=True,
                         backward_passes_per_step=1, op=Average,
                         gradient_predivide_factor=1.0,
                         average_aggregated_gradients=True,
                         num_groups=0, groups=None,
                         process_set=global_process_set):
    """Wrap a TF optimizer so apply_gradients() averages gradients across
    ranks first, with optional local aggregation over
    ``backward_passes_per_step`` (reference:
    horovod/tensorflow/__init__.py:627).

    Aggregation is graph-state based — a tf.Variable counter and
    accumulator slots driven by tf.cond — so it is exact inside
    ``tf.function`` train steps, where a Python-side counter would
    freeze at its trace-time value (reference design:
    horovod/tensorflow/gradient_aggregation.py:16). The rank-sync and
    the inner apply happen only on every k-th call; skip calls just
    accumulate. ``num_groups``/``groups`` bound the gradient fusion
    buckets like the reference. ``compression`` shrinks the bytes each
    sync moves. ``device_dense``/``device_sparse`` are TF device
    placement in the reference; here the sync runs on the runtime's
    device whatever they say. ``sparse_as_dense=False`` routes
    IndexedSlices gradients through the sparse plane (ops/sparse.py);
    True (default) densifies before the sync."""
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if k > 1 and op == Adasum:
        raise ValueError(
            "backward_passes_per_step > 1 with Adasum is unsupported "
            "(nonlinear reduction); aggregate in the training loop.")
    cls = type(optimizer)
    log = get_logger()

    class _Distributed(cls):
        _hvd_wrapped = True

        def __init__(self):  # pragma: no cover — state is copied below
            pass

        def _hvd_ensure_state(self, tf, grads):
            if self._hvd_counter is not None:
                return
            # init_scope lifts creation out of tf.function tracing, so
            # the variables are created exactly once (first trace) and
            # persist across calls — the reference's graph-state design.
            with tf.init_scope():
                self._hvd_counter = tf.Variable(
                    0, trainable=False, dtype=tf.int64,
                    name="hvd_agg_counter")
                self._hvd_acc = [
                    None if g is None else tf.Variable(
                        tf.zeros(g.shape, g.dtype), trainable=False,
                        name=f"hvd_agg_{i}")
                    for i, g in enumerate(grads)]

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            tf = _tf()
            gv = list(grads_and_vars)
            grads = [g for g, _ in gv]
            tvars = [v for _, v in gv]
            ngroups, group_ids = _resolve_groups(tvars, num_groups,
                                                 groups)

            def reduce_and_apply(grads):
                if _spmd():
                    # Sparse gradients are densified (or sent through the
                    # sparse plane) only on the sync path: a lone rank's
                    # IndexedSlices keep the inner optimizer's sparse
                    # application.
                    grads = _reduce_grads(grads, op, process_set,
                                          gradient_predivide_factor,
                                          ngroups, group_ids,
                                          compression=compression,
                                          sparse_as_dense=sparse_as_dense)
                return cls.apply_gradients(self, list(zip(grads, tvars)),
                                           *args, **kwargs)

            if k == 1:
                return reduce_and_apply(grads)

            # Accumulator slots are dense: aggregation materializes
            # sparse gradients by construction.
            grads = [None if g is None
                     else tf.convert_to_tensor(g) if isinstance(
                         g, tf.IndexedSlices) else g
                     for g in grads]
            self._hvd_ensure_state(tf, grads)
            if len(grads) != len(self._hvd_acc):
                raise ValueError(
                    f"backward_passes_per_step aggregation was built for "
                    f"{len(self._hvd_acc)} gradients but this "
                    f"apply_gradients call passed {len(grads)}; the "
                    "variable list must stay fixed across calls.")
            self._hvd_counter.assign_add(1)
            for acc, g in zip(self._hvd_acc, grads):
                if g is not None:
                    acc.assign_add(g)
            do_step = tf.equal(self._hvd_counter % k, 0)

            def _apply():
                agg = [None if acc is None else
                       (acc.read_value() / k if average_aggregated_gradients
                        else acc.read_value())
                       for acc in self._hvd_acc]
                reduce_and_apply(agg)
                for acc in self._hvd_acc:
                    if acc is not None:
                        acc.assign(tf.zeros_like(acc))
                return tf.constant(True)

            def _skip():
                return tf.constant(False)

            return tf.cond(do_step, _apply, _skip)

    # Rebrand the instance in place (the reference builds a dynamic
    # subclass the same way, horovod/_keras/__init__.py:36).
    opt = optimizer
    opt.__class__ = _Distributed
    opt._hvd_counter = None
    opt._hvd_acc = None
    if _spmd():
        log.info("tensorflow DistributedOptimizer wrapping %s over %d "
                 "ranks", cls.__name__, size())
    return opt


def __getattr__(name):
    # SyncBatchNormalization lives in its own module and subclasses a
    # keras Layer; resolve it lazily so importing the binding never
    # imports tensorflow/keras (cached in globals for identity).
    if name == "SyncBatchNormalization":
        from .sync_batch_norm import SyncBatchNormalization
        globals()[name] = SyncBatchNormalization
        return SyncBatchNormalization
    raise AttributeError(name)

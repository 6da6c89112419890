"""The port's data, TensorFlow and Keras bindings in one process, against the
JAX package's (ports of tests/test_data_and_callbacks.py,
tests/test_tf_keras_namespace.py and tests/test_tf_aggregation.py).

- ``data``: the async loader mixin and ``prefetch_to_device`` give both
  packages' loaders the same batches (the CUDA stream path runs in
  tests/test_torch_port_frameworks_cuda.py).
- the surfaces: every public name of the JAX package's
  ``tensorflow``, ``keras``, ``tensorflow.keras`` and ``data`` bindings
  exists in the port's.
- the callbacks' LR math, the metric average and the elastic callbacks,
  and ``TensorFlowKerasState``'s save/restore equal the JAX package's.
- the TF binding's graph-safe aggregation, grouping and compression
  forwarding, on the same inputs as the JAX binding's.
- the keras optimizer wrapping, ``load_model``'s positional order and the
  jax backend's refusal run in subprocesses (tests/torch_port_keras_checks.py):
  keras fixes its backend at import.

The two-rank jobs are tests/test_torch_port_frameworks_*_job.py.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
import horovod_tpu.data as jdata
import horovod_tpu_torch.data as tdata

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKS = os.path.join(HERE, "torch_port_keras_checks.py")
DATA = {"jax": jdata, "port": tdata}


@pytest.fixture
def port():
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


# -- data ---------------------------------------------------------------------

def _loaders(pkg, **kw):
    mod = DATA[pkg]

    class ListLoader(mod.BaseDataLoader):
        def __init__(self, items, delay=0.0, fail_at=None):
            self.items, self.delay, self.fail_at = items, delay, fail_at

        def __len__(self):
            return len(self.items)

        def __iter__(self):
            for i, x in enumerate(self.items):
                if self.fail_at is not None and i == self.fail_at:
                    raise ValueError("loader exploded")
                if self.delay:
                    time.sleep(self.delay)
                yield x

    class AsyncListLoader(mod.AsyncDataLoaderMixin, ListLoader):
        pass

    return AsyncListLoader(**kw)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_async_loader_order_and_epochs(pkg):
    loader = _loaders(pkg, items=list(range(20)), async_loader_queue_size=4)
    assert list(loader) == list(range(20))
    assert list(loader) == list(range(20))
    loader.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_async_loader_overlaps(pkg):
    loader = _loaders(pkg, items=list(range(8)), delay=0.02,
                      async_loader_queue_size=4)
    it = iter(loader)
    assert next(it) == 0
    assert loader._async_thread is not None
    assert loader._async_thread is not threading.current_thread()
    assert list(it) == list(range(1, 8))
    loader.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_async_loader_propagates_exceptions(pkg):
    loader = _loaders(pkg, items=list(range(10)), fail_at=3,
                      async_loader_queue_size=2)
    out = []
    with pytest.raises(ValueError, match="loader exploded"):
        for x in loader:
            out.append(x)
    assert out == [0, 1, 2]
    loader.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_async_loader_close_mid_epoch_and_passthrough(pkg):
    loader = _loaders(pkg, items=list(range(1000)), delay=0.001,
                      async_loader_queue_size=2)
    it = iter(loader)
    next(it)
    loader.close()
    assert loader._async_thread is None
    assert list(_loaders(pkg, items=[1, 2, 3],
                         async_loader_queue_size=0)) == [1, 2, 3]


def _batches():
    rng = np.random.RandomState(0)
    return [{"x": rng.randn(4, 3).astype(np.float32),
             "ids": (rng.randint(0, 9, size=(4,)).astype(np.int64),
                     [np.full((2,), i, np.float32)])} for i in range(6)]


def test_prefetch_to_device_gives_the_jax_packages_batches(port):
    want = list(jdata.prefetch_to_device(iter(_batches()), size=2))
    got = list(tdata.prefetch_to_device(iter(_batches()), size=2))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert isinstance(g["ids"], tuple) and isinstance(g["ids"][1], list)
        leaves = [(g["x"], w["x"]), (g["ids"][0], w["ids"][0]),
                  (g["ids"][1][0], w["ids"][1][0])]
        for t, j in leaves:
            assert isinstance(t, torch.Tensor) and t.device == port.device()
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            assert t.numpy().dtype == np.asarray(j).dtype or \
                np.asarray(j).dtype == np.int32   # JAX's x64-off int
    # the JAX spelling of the device, and a batch shorter than the buffer
    out = list(tdata.prefetch_to_device(iter(_batches()[:1]), size=4,
                                        devices=["cpu"]))
    assert len(out) == 1


def test_prefetch_to_device_needs_a_runtime_or_a_device():
    thvd.shutdown()
    with pytest.raises(RuntimeError, match="not initialized"):
        tdata.prefetch_to_device(iter(_batches()))


# -- surfaces -----------------------------------------------------------------

def _surface(mod):
    """A binding's public names: those it defines or lists in ``__all__``,
    the runtime's it re-exports (init, the reduce ops, process sets,
    Compression) and its constants; not the modules and helpers it only
    imports."""
    import types
    out = set()
    for n in dir(mod):
        obj = getattr(mod, n)
        if n.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        origin = getattr(obj, "__module__", None)
        if origin is None or origin.startswith(mod.__name__) or \
                n in getattr(mod, "__all__", ()) or \
                origin.rsplit(".", 1)[-1] in {"basics", "process_sets",
                                              "reduce_ops", "compression"}:
            out.add(n)
    return out


@pytest.mark.parametrize("name", ["tensorflow", "keras", "tensorflow.keras",
                                  "data", "tensorflow.elastic",
                                  "keras.elastic", "tensorflow.keras.elastic",
                                  "tensorflow.keras.callbacks",
                                  "_keras.callbacks", "_keras.elastic"])
def test_every_public_name_of_the_jax_binding_exists(name):
    import importlib
    jmod = importlib.import_module(f"horovod_tpu.{name}")
    tmod = importlib.import_module(f"horovod_tpu_torch.{name}")
    # Lazily made names (callbacks, SyncBatchNormalization) resolve too.
    lazy = {"tensorflow": ["SyncBatchNormalization"],
            "keras.elastic": ["CommitStateCallback"],
            "tensorflow.keras.elastic": ["UpdateEpochStateCallback"],
            "tensorflow.keras.callbacks": ["BestModelCheckpoint",
                                           "MetricAverageCallback"]}
    for attr in lazy.get(name, []):
        pytest.importorskip("keras")
        assert getattr(tmod, attr) is getattr(tmod, attr)
        assert getattr(jmod, attr) is not None
    jsurface = _surface(jmod)
    assert not jsurface - set(dir(tmod)), sorted(jsurface - set(dir(tmod)))


def test_namespace_surface():
    pytest.importorskip("keras")
    import horovod_tpu_torch.keras as hk
    import horovod_tpu_torch.tensorflow.keras as hvd
    for name in ["init", "shutdown", "rank", "size", "local_rank",
                 "local_size", "cross_rank", "cross_size",
                 "DistributedOptimizer", "broadcast_global_variables",
                 "allreduce", "allgather", "broadcast", "load_model",
                 "Compression", "Average", "Sum", "Adasum",
                 "ProcessSet", "add_process_set", "remove_process_set",
                 "start_timeline", "stop_timeline"]:
        assert hasattr(hvd, name), name
    for cb in ["BroadcastGlobalVariablesCallback", "MetricAverageCallback",
               "LearningRateWarmupCallback", "LearningRateScheduleCallback",
               "BestModelCheckpoint"]:
        assert getattr(hvd.callbacks, cb) is not None, cb
    for el in ["KerasState", "CommitStateCallback",
               "UpdateBatchStateCallback", "UpdateEpochStateCallback",
               "run"]:
        assert getattr(hvd.elastic, el) is not None, el
    assert (hvd.callbacks.BroadcastGlobalVariablesCallback
            is hvd.callbacks.BroadcastGlobalVariablesCallback)
    assert (hk.callbacks.MetricAverageCallback
            is hk.callbacks.MetricAverageCallback)
    cb = hvd.callbacks.BroadcastGlobalVariablesCallback(0)
    assert isinstance(cb, hvd.callbacks.BroadcastGlobalVariablesCallback)


# -- callbacks and elastic state -------------------------------------------------

def _callbacks(pkg):
    if pkg == "jax":
        from horovod_tpu._keras.callbacks import make_callbacks
        from horovod_tpu._keras.elastic import make_elastic_callbacks
    else:
        from horovod_tpu_torch._keras.callbacks import make_callbacks
        from horovod_tpu_torch._keras.elastic import make_elastic_callbacks
    return make_callbacks() + make_elastic_callbacks()


def _lr_run(pkg):
    keras = pytest.importorskip("keras")
    _, _, warmup_cls, sched_cls = _callbacks(pkg)[:4]
    model = keras.Sequential([keras.layers.Input((2,)),
                              keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.SGD(0.4), loss="mse")
    lr = model.optimizer

    def read():
        return float(np.asarray(lr.learning_rate))
    cb = warmup_cls(initial_lr=0.4, warmup_epochs=4)
    cb.set_model(model)
    lrs = []
    for epoch in range(6):
        cb.on_epoch_begin(epoch)
        lrs.append(read())
    sched = sched_cls(initial_lr=0.4, multiplier=lambda e: 0.1 ** (e - 1),
                      start_epoch=2, end_epoch=5)
    sched.set_model(model)
    for epoch in range(7):
        sched.on_epoch_begin(epoch)
        lrs.append(read())
    return lrs


def test_lr_callbacks_math_equals_the_jax_packages(port, hvd):
    got, want = _lr_run("port"), _lr_run("jax")
    assert got == want
    assert got[:4] == sorted(got[:4])
    np.testing.assert_allclose(got[3], 0.4, rtol=1e-6)


def test_metric_average_single_mode_noop(port, hvd):
    for pkg in ("jax", "port"):
        cb = _callbacks(pkg)[1]()
        logs = {"loss": 1.5, "acc": 0.5}
        cb.on_epoch_end(0, logs)
        assert logs == {"loss": 1.5, "acc": 0.5}


def test_keras_elastic_callbacks_commit_cadence():
    pytest.importorskip("keras")

    class FakeState:
        def __init__(self):
            self.commits = self.batch = self.epoch = 0

        def commit(self):
            self.commits += 1

    seen = []
    for pkg in ("jax", "port"):
        commit_cls, batch_cls, epoch_cls = _callbacks(pkg)[4:]
        st = FakeState()
        cbs = (commit_cls(st, batches_per_commit=2), batch_cls(st),
               epoch_cls(st))
        for b in range(5):
            cbs[0].on_train_batch_end(b)
            cbs[1].on_train_batch_end(b)
        mid = (st.commits, st.batch)
        for cb in cbs:
            cb.on_epoch_end(0)
        seen.append((mid, st.commits, st.batch, st.epoch))
    assert seen[0] == seen[1] == ((2, 5), 3, 0, 1)


def test_tf_keras_state_save_restore_equals_the_jax_packages(port, hvd):
    keras = pytest.importorskip("keras")
    from horovod_tpu.tensorflow.elastic import TensorFlowKerasState as JS
    from horovod_tpu_torch.tensorflow.elastic import \
        TensorFlowKerasState as TS
    w0 = [np.random.RandomState(0).randn(3, 2).astype(np.float32),
          np.zeros(2, np.float32)]
    out = []
    for cls in (JS, TS):
        model = keras.Sequential([keras.layers.Input((3,)),
                                  keras.layers.Dense(2)])
        model.set_weights(w0)
        model.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse")
        state = cls(model, epoch=2, meta={"k": [1]})
        state.commit()
        model.set_weights([w + 100.0 for w in w0])
        state.epoch = 7
        state.meta["k"].append(2)
        state.restore()
        state.sync()    # one rank: rank 0's own state
        out.append((state.epoch, state.meta,
                    [np.asarray(w) for w in model.get_weights()]))
    assert out[0][:2] == out[1][:2] == (2, {"k": [1]})
    for a, b in zip(out[0][2], out[1][2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[1][2][0], w0[0])


# -- the TF binding ----------------------------------------------------------------

class PlainSGD:
    """A TF-native optimizer (a keras one could not apply TF tensors if the
    process's keras runs another backend)."""

    def __init__(self, lr):
        self.lr = lr

    def apply_gradients(self, grads_and_vars, *args, **kwargs):
        tf = pytest.importorskip("tensorflow")
        for g, v in grads_and_vars:
            if g is None:
                continue
            if isinstance(g, tf.IndexedSlices):
                v.scatter_sub(tf.IndexedSlices(g.values * self.lr,
                                               g.indices, g.dense_shape))
            else:
                v.assign_sub(self.lr * g)


def _tf_bindings():
    tf = pytest.importorskip("tensorflow")
    import horovod_tpu.tensorflow as jtf
    import horovod_tpu_torch.tensorflow as ttf
    return tf, {"jax": jtf, "port": ttf}


@pytest.mark.parametrize("average", [True, False])
def test_aggregation_under_tf_function_equals_the_jax_binding(port, hvd,
                                                              average):
    tf, mods = _tf_bindings()
    trace = {}
    for pkg, mod in mods.items():
        v = tf.Variable(1.0)
        opt = mod.DistributedOptimizer(
            PlainSGD(0.1), backward_passes_per_step=2,
            average_aggregated_gradients=average)

        @tf.function
        def step(g):
            return opt.apply_gradients([(g, v)])

        vals = []
        for g in (1.0, 3.0, 2.0, 4.0):
            step(tf.constant(g))
            vals.append(float(v.numpy()))
        trace[pkg] = vals
    assert trace["port"] == trace["jax"]
    want = [1.0, 0.8, 0.8, 0.5] if average else [1.0, 0.6, 0.6, 0.0]
    np.testing.assert_allclose(trace["port"], want, rtol=1e-6, atol=1e-7)


def test_aggregation_guards(port):
    tf, mods = _tf_bindings()
    hvd = mods["port"]
    v1, v2 = tf.Variable(1.0), tf.Variable(2.0)
    opt = hvd.DistributedOptimizer(PlainSGD(0.1), backward_passes_per_step=2)
    opt.apply_gradients([(tf.constant(1.0), v1)])
    with pytest.raises(ValueError, match="variable list must stay fixed"):
        opt.apply_gradients([(tf.constant(1.0), v1),
                             (tf.constant(1.0), v2)])
    with pytest.raises(ValueError, match="Adasum"):
        hvd.DistributedOptimizer(PlainSGD(0.1), backward_passes_per_step=2,
                                 op=hvd.Adasum)


def test_sparse_grads_not_densified_single_rank(port):
    tf, mods = _tf_bindings()
    seen = {}

    class Recording(PlainSGD):
        def apply_gradients(self, grads_and_vars, *a, **kw):
            gv = list(grads_and_vars)
            seen["types"] = [type(g).__name__ for g, _ in gv]
            return PlainSGD.apply_gradients(self, gv, *a, **kw)

    v = tf.Variable(tf.zeros([4, 2]))
    opt = mods["port"].DistributedOptimizer(Recording(0.1))
    g = tf.IndexedSlices(values=tf.ones([2, 2]),
                         indices=tf.constant([0, 2]),
                         dense_shape=tf.constant([4, 2]))
    opt.apply_gradients([(g, v)])
    assert seen["types"] == ["IndexedSlices"]


def test_grouping_equals_the_jax_binding():
    tf, mods = _tf_bindings()
    vs = [tf.Variable(float(i)) for i in range(4)]
    for args in ((5, 0, None), (5, 2, None), (3, 8, None)):
        assert mods["port"]._grouping(*args) == mods["jax"]._grouping(*args)
    spec = [[vs[0], vs[2]], [vs[1]]]
    got = mods["port"]._resolve_groups(vs, 0, spec)
    assert got == mods["jax"]._resolve_groups(vs, 0, spec) == \
        (0, [0, 1, 0, None])
    assert mods["port"]._grouping(4, 0, got[1]) == [[0, 2], [1], [3]]
    assert mods["port"]._resolve_groups([], 0, 3) == (3, None)


def _fake_grouped(captured):
    def fake(tensors, **kw):
        captured.update(kw)
        return list(tensors)
    return fake


def test_tf_optimizer_and_tape_forward_compression(port, monkeypatch):
    tf, mods = _tf_bindings()
    hvd = mods["port"]
    from horovod_tpu_torch.ops.compression import Compression
    captured = {}
    monkeypatch.setattr(hvd, "_spmd", lambda: True)
    monkeypatch.setattr(hvd, "grouped_allreduce", _fake_grouped(captured))
    v = tf.Variable(1.0)
    opt = hvd.DistributedOptimizer(PlainSGD(0.1),
                                   compression=Compression.fp16)
    opt.apply_gradients([(tf.constant(2.0), v)])
    assert captured.get("compression") is Compression.fp16
    np.testing.assert_allclose(v.numpy(), 0.8, rtol=1e-6)
    captured.clear()
    w = tf.Variable(3.0)
    with hvd.DistributedGradientTape(
            tf.GradientTape(), compression=Compression.bf16) as tape:
        loss = w * w
    tape.gradient(loss, [w])
    assert captured.get("compression") is Compression.bf16


def test_the_wire_casts_and_buckets_of_the_torch_plane(port, monkeypatch):
    """The keras torch plane's sync: num_groups buckets, and a cast
    compressor narrows what reaches the collective and widens the result
    (the JAX package's numpy plane forwards the same compression)."""
    import horovod_tpu_torch._keras as kimpl
    from horovod_tpu_torch.ops import collectives as c
    from horovod_tpu_torch.ops import reduce_ops
    from horovod_tpu_torch.ops.compression import Compression
    import horovod_tpu._keras as jimpl
    for n, k in ((5, 2), (3, 0), (2, 5)):
        assert kimpl._buckets(n, k) == jimpl._buckets(n, k)
    calls = []

    def fake(tensors, **kw):
        calls.append(([t.dtype for t in tensors], kw.get("codec")))
        return [t.clone() for t in tensors]
    monkeypatch.setattr(c, "grouped_allreduce", fake)
    out = kimpl._reduce_torch_grads([torch.ones(2)] * 5,
                                    reduce_ops.Average, 1.0, 1.0, "t",
                                    num_groups=2)
    assert [len(d) for d, _ in calls] == [3, 2] and len(out) == 5
    calls.clear()
    out = kimpl._reduce_torch_grads([torch.ones(3), None, torch.ones(2)],
                                    reduce_ops.Average, 1.0, 1.0, "t",
                                    compression=Compression.fp16)
    assert calls == [([torch.float16, torch.float16], None)]
    assert out[1] is None and out[0].dtype == torch.float32
    calls.clear()
    kimpl._reduce_torch_grads([torch.ones(3)], reduce_ops.Average, 1.0,
                              1.0, "t", compression=Compression.int8)
    assert calls == [([torch.float32], "int8")]


def test_eager_round_trip_keeps_every_dtype(port):
    """TF -> numpy -> torch on the runtime's device -> TF, eager and inside
    tf.function (through tf.py_function, static shape kept): float64,
    int64 and bfloat16 come back as they went."""
    tf, mods = _tf_bindings()
    hvd = mods["port"]
    seen = []

    def double(ts):
        seen.extend((t.dtype, t.device) for t in ts)
        return [t * 2 for t in ts]
    for dt in (tf.float32, tf.float64, tf.int64, tf.bfloat16):
        x = tf.cast(tf.reshape(tf.range(6), (2, 3)), dt)
        [eager] = hvd._eager(double, [x], [dt])

        @tf.function
        def graph(t):
            return hvd._eager(double, [t], [dt], shape_preserving=True)[0]
        traced = graph(x)
        for out in (eager, traced):
            assert out.dtype == dt and out.shape == (2, 3)
            np.testing.assert_array_equal(
                tf.cast(out, tf.float64).numpy(),
                2 * np.arange(6).reshape(2, 3))
    assert {d for _, d in seen} == {port.device()}
    assert torch.float64 in {d for d, _ in seen}


def test_single_process_collectives_equal_the_jax_binding(port, hvd):
    tf, mods = _tf_bindings()
    x = tf.constant(np.random.RandomState(0).randn(4, 3))
    outs = {}
    for pkg, mod in mods.items():
        outs[pkg] = [mod.allreduce(x, prescale_factor=2.0,
                                   postscale_factor=0.5),
                     mod.allreduce(x, op=mod.Sum), mod.allgather(x),
                     mod.broadcast(x, 0), mod.reducescatter(x),
                     mod.grouped_allreduce([x, x])[1]]
    for a, b in zip(outs["port"], outs["jax"]):
        assert a.dtype == b.dtype == tf.float64
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert mods["port"].gpu_available() == torch.cuda.is_available()
    assert mods["port"].rank() == 0 and mods["port"].size() == 1
    assert mods["port"].join() == -1
    # The tf.function bridge (item 16b) compiles and runs.
    compiled = mods["port"].tpu_compile(lambda t: t, example_inputs=(x,))
    out = compiled(x)
    assert out.dtype == torch.float64 and out.device == port.device()
    np.testing.assert_array_equal(out.numpy(), x.numpy())


def test_broadcast_arrays_keeps_bfloat16(port):
    pytest.importorskip("tensorflow")
    import ml_dtypes
    from horovod_tpu_torch.tensorflow import broadcast_arrays
    arrays = [np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16),
              np.arange(3, dtype=np.int64)]
    out = broadcast_arrays(arrays)
    for a, b in zip(arrays, out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.astype(np.float64),
                                      b.astype(np.float64))


def test_sync_batch_norm_equals_the_jax_layer_off_the_sync_path(port, hvd):
    tf, mods = _tf_bindings()
    x = tf.constant(np.random.RandomState(0).randn(4, 3).astype(np.float32))
    outs = []
    for mod in (mods["jax"], mods["port"]):
        layer = mod.SyncBatchNormalization()
        layer.build(x.shape)
        outs.append([layer(x, training=t).numpy() for t in (False, True)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# -- keras optimizer wrapping (a process of its own per backend) ------------------

@pytest.fixture(scope="module")
def keras_checks(tmp_path_factory):
    pytest.importorskip("keras")
    root = tmp_path_factory.mktemp("keras_checks")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.pop("XLA_FLAGS", None)
    procs = {}
    for backend in ("torch", "jax"):
        out = root / f"{backend}.json"
        procs[backend] = (out, subprocess.Popen(
            [sys.executable, CHECKS, str(out)],
            env=dict(env, KERAS_BACKEND=backend, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = {}
    for backend, (out, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        results[backend] = (json.loads(out.read_text()) if out.exists()
                            else {"process": log[-4000:]})
    return results


KERAS_CHECKS = [
    ("torch", "check_rewrap_guard_ignores_no_effect_average_flag"),
    ("torch", "check_distributed_optimizer_wraps_with_reference_kwargs"),
    ("torch", "check_num_groups_deprecation_matches_reference"),
    ("torch", "check_set_data_parallel_points_to_the_launcher"),
    ("torch", "check_load_model_takes_the_reference_positional_order"),
    ("torch", "check_gradients_on_another_device_raise"),
    ("torch", "check_fit_syncs_torch_tensors_on_the_device"),
    ("jax", "check_jax_backend_is_refused"),
]


@pytest.mark.parametrize("backend,check", KERAS_CHECKS)
def test_keras_wrapping(keras_checks, backend, check):
    assert keras_checks[backend].get(check) == "ok", \
        keras_checks[backend].get(check, keras_checks[backend])


def test_broadcast_global_variables_fails_loud_without_model(port):
    import horovod_tpu_torch.keras as hk
    with pytest.raises(ValueError, match="model"):
        hk.broadcast_global_variables(0)
    # one process: the collectives are identities, compression accepted
    from horovod_tpu_torch.ops.compression import Compression
    x = np.ones(3, np.float32)
    assert hk.allreduce(x, compression=Compression.fp16) is x

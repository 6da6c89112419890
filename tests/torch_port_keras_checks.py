"""Single-process checks of the port's Keras bindings that wrap a keras
optimizer, for tests/test_torch_port_frameworks.py. They run in a process
of their own because keras fixes its backend at import
(``KERAS_BACKEND``), and the pytest process may have claimed another.

    KERAS_BACKEND=torch python torch_port_keras_checks.py OUT_JSON

Every ``check_*`` function runs; OUT_JSON maps its name to "ok" or the
error. With ``KERAS_BACKEND=jax`` only ``check_jax_backend_is_refused``
applies.
"""

import json
import os
import sys
import tempfile
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402


def _keras():
    import keras
    return keras


def check_jax_backend_is_refused():
    keras = _keras()
    import horovod_tpu_torch.keras as hk
    assert keras.backend.backend() == "jax"
    try:
        hk.DistributedOptimizer(keras.optimizers.SGD(0.1))
    except RuntimeError as e:
        assert "jax keras backend" in str(e), e
    else:
        raise AssertionError("the jax backend was not refused")


def check_rewrap_guard_ignores_no_effect_average_flag():
    keras = _keras()
    import horovod_tpu_torch.keras as hk
    import horovod_tpu_torch.tensorflow.keras as htk
    opt = hk.DistributedOptimizer(keras.optimizers.SGD(0.1))   # avg=True
    assert htk.DistributedOptimizer(opt) is opt                # avg=False
    try:
        hk.DistributedOptimizer(opt, gradient_predivide_factor=2.0)
    except ValueError as e:
        assert "already wrapped" in str(e)
    else:
        raise AssertionError("a re-wrap with other settings was accepted")


def check_distributed_optimizer_wraps_with_reference_kwargs():
    keras = _keras()
    import horovod_tpu_torch.tensorflow.keras as htk
    from horovod_tpu_torch.ops.compression import Compression
    opt = htk.DistributedOptimizer(
        keras.optimizers.SGD(0.1), compression=Compression.bf16,
        sparse_as_dense=True, device_dense="/gpu:0")
    assert getattr(opt, "_hvd_wrapped", False)
    assert Compression.bf16 in opt._hvd_settings
    assert type(opt).__name__ == "SGD"


def check_num_groups_deprecation_matches_reference():
    keras = _keras()
    import horovod_tpu_torch.tensorflow.keras as htk
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        opt = htk.DistributedOptimizer(keras.optimizers.SGD(0.1),
                                       num_groups=2)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert 2 in opt._hvd_settings
    for groups, err in ((-1, ValueError), ([[object()]],
                                           NotImplementedError)):
        try:
            htk.DistributedOptimizer(keras.optimizers.SGD(0.1),
                                     groups=groups)
        except err:
            pass
        else:
            raise AssertionError(f"groups={groups!r} was accepted")


def check_set_data_parallel_points_to_the_launcher():
    import horovod_tpu_torch.keras as hk
    try:
        hk.set_data_parallel()
    except NotImplementedError as e:
        assert "DistributedOptimizer" in str(e) and "launch" in str(e)
    else:
        raise AssertionError("set_data_parallel did not raise")


def check_load_model_takes_the_reference_positional_order():
    keras = _keras()
    import horovod_tpu_torch.keras as hk
    from horovod_tpu_torch.ops.compression import Compression

    @keras.saving.register_keras_serializable(package="hvdtest")
    class MySGD(keras.optimizers.SGD):
        pass

    model = keras.Sequential([keras.layers.Input((3,)),
                              keras.layers.Dense(2)])
    model.compile(optimizer=MySGD(0.1), loss="mse")
    path = os.path.join(tempfile.mkdtemp(), "m.keras")
    model.save(path)
    # filepath, custom_optimizers, custom_objects, compression
    loaded = hk.load_model(path, [MySGD], None, Compression.fp16)
    assert loaded.optimizer._hvd_wrapped
    assert Compression.fp16 in loaded.optimizer._hvd_settings
    assert type(loaded.optimizer).__name__ == "MySGD"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        again = hk.load_model(path, {"MySGD": MySGD})
    assert any("custom_optimizers" in str(x.message) for x in w)
    assert again.optimizer._hvd_wrapped


def check_gradients_on_another_device_raise():
    import torch
    import horovod_tpu_torch._keras as kimpl
    from horovod_tpu_torch.ops import reduce_ops
    try:
        kimpl._reduce_torch_grads([torch.ones(2, device="meta")],
                                  reduce_ops.Average, 1.0, 1.0, "t")
    except ValueError as e:
        assert "runtime computes on cpu" in str(e), e
    else:
        raise AssertionError("a gradient off the runtime's device passed")


def check_fit_syncs_torch_tensors_on_the_device():
    """With the sync forced on (as in a launcher job of one rank), the
    keras torch backend's gradients reach the grouped allreduce as torch
    tensors on the runtime's device."""
    keras = _keras()
    import torch
    import horovod_tpu_torch._keras as kimpl
    import horovod_tpu_torch.keras as hk
    from horovod_tpu_torch.ops import collectives as c
    seen = []
    plain_spmd, plain_grouped = kimpl.spmd_active, c.grouped_allreduce

    def recording(tensors, *a, **k):
        seen.append([(type(t), t.device) for t in tensors])
        return [t.clone() for t in tensors]
    kimpl.spmd_active = lambda: True
    c.grouped_allreduce = recording
    try:
        model = keras.Sequential([keras.layers.Input((3,)),
                                  keras.layers.Dense(2)])
        model.compile(optimizer=hk.DistributedOptimizer(
            keras.optimizers.SGD(0.1)), loss="mse")
        model.fit(np.ones((8, 3), np.float32), np.ones((8, 2), np.float32),
                  batch_size=4, verbose=0)
    finally:
        kimpl.spmd_active, c.grouped_allreduce = plain_spmd, plain_grouped
    assert len(seen) == 2 and all(len(call) == 2 for call in seen)
    assert all(t is torch.Tensor and d == torch.device("cpu")
               for call in seen for t, d in call)


def main():
    out_path = sys.argv[1]
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    backend = os.environ.get("KERAS_BACKEND")
    names = sorted(n for n in globals() if n.startswith("check_"))
    if backend == "jax":
        names = ["check_jax_backend_is_refused"]
    else:
        names.remove("check_jax_backend_is_refused")
    results = {}
    for name in names:
        try:
            globals()[name]()
            results[name] = "ok"
        except Exception:  # noqa: BLE001 - reported to the test
            results[name] = traceback.format_exc()
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()

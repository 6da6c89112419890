"""A two-rank job of the port's Keras binding with ``KERAS_BACKEND=torch``
against the JAX package's Keras binding on the same backend
(tests/torch_port_frameworks_worker.py ``keras``): rank-perturbed MLP
weights, ``model.fit`` for 3 SGD steps through ``DistributedOptimizer``
with ``BroadcastGlobalVariablesCallback(0)`` and
``MetricAverageCallback``. The weights agree within 1e-6 absolute (fp32)
and are equal on both ranks of each job."""

import numpy as np
import pytest

from torch_port_frameworks_jobs import (PACKAGES, assert_ok,
                                        assert_weights_agree, run_pair)

pytest.importorskip("keras")
pytest.importorskip("torch")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    return run_pair("keras", tmp_path_factory.mktemp("keras_torch"),
                    {"KERAS_BACKEND": "torch"})


def test_both_jobs_finish_on_the_backend(jobs):
    assert_ok(jobs)
    for pkg in PACKAGES:
        assert [c["backend"] for c in jobs[pkg]["checks"]] == ["torch"] * 2


def test_weights_after_three_steps_agree(jobs):
    assert_ok(jobs)
    assert_weights_agree(jobs)
    port, ref = (jobs[p]["checks"] for p in PACKAGES)
    # MetricAverageCallback: every rank logs the same averaged loss.
    assert port[0]["losses"] == port[1]["losses"]
    np.testing.assert_allclose(port[0]["losses"], ref[0]["losses"],
                               rtol=1e-6)


def test_gradients_reach_the_allreduce_as_torch_tensors_on_the_device(jobs):
    """No numpy round trip: the port's grouped allreduce receives the
    keras torch backend's gradients as tensors on the runtime's device
    (the CPU here; the card in tests/test_torch_port_frameworks_cuda.py),
    one grouped call per step with the MLP's 4 gradients."""
    assert_ok(jobs)
    for checks in jobs["horovod_tpu_torch"]["checks"]:
        grads = [call for call in checks["seen"] if len(call) == 4]
        assert len(grads) == 3
        assert all(t == ["Tensor", "cpu"] for call in grads for t in call)

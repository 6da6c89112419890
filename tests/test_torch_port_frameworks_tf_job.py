"""A two-rank job of the port's TensorFlow binding against the JAX
package's (tests/torch_port_frameworks_worker.py ``tf``): broadcast from
rank 0, two ``tf.function`` steps of ``DistributedGradientTape``, one eager
``DistributedOptimizer`` step, then the eager collectives. The weights
agree within 1e-6 absolute (fp32); the port's collectives keep their
input's dtype (float64 and int64 whole) and agree with the JAX binding's
(int64 exactly; float64 within 1e-6, the JAX plane narrows it to fp32)."""

import numpy as np
import pytest

from torch_port_frameworks_jobs import (PACKAGES, assert_ok,
                                        assert_weights_agree, run_pair)

pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    return run_pair("tf", tmp_path_factory.mktemp("tf"))


def test_both_jobs_finish(jobs):
    assert_ok(jobs)


def test_weights_after_three_steps_agree(jobs):
    assert_ok(jobs)
    assert_weights_agree(jobs)
    port, ref = (jobs[p]["checks"] for p in PACKAGES)
    np.testing.assert_allclose(port[0]["losses"], ref[0]["losses"],
                               rtol=1e-6)


def test_collectives_keep_their_dtype_and_agree(jobs):
    assert_ok(jobs)
    port, ref = (jobs[p]["res"] for p in PACKAGES)
    dtypes = jobs["horovod_tpu_torch"]["checks"][0]["dtypes"]
    want = {"f32": "float32", "f64": "float64", "i64": "int64"}
    assert dtypes and all(dt == want[k.rsplit("_", 1)[1]]
                          for k, dt in dtypes.items())
    for r in range(2):
        for k in dtypes:
            got = port[r][k]
            assert got.dtype == np.dtype(want[k.rsplit("_", 1)[1]])
            if k.endswith("i64"):
                np.testing.assert_array_equal(got, ref[r][k])
            else:
                np.testing.assert_allclose(got, ref[r][k], rtol=0,
                                           atol=1e-6)

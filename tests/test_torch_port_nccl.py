"""The gloo jobs of tests/test_torch_port_collectives.py over NCCL, one
rank per GPU, with every tensor on the rank's card (worker body:
tests/torch_port_worker.py): the same checks, plus one that launches,
polls and synchronizes async allreduces with the host allowed to wait for
nothing; needs 3 GPUs. And the rank-order and hook-order job of
tests/test_torch_port_spmd.py over NCCL (tests/torch_port_spmd_worker.py
with ``PORT_TEST_DEVICE=cuda``), and elastic jobs over NCCL through the
port's launcher whose slot 1 or slot 0 is killed
(tests/torch_port_elastic_worker.py, a tiny TransformerLM under
``TorchState``): the survivor aborts its communicators, resets in process
on its own card (the respawned slot takes its slot's card) and finishes
with the parameters of an uninterrupted run; each needs 2 GPUs. And the
``reduce`` job of tests/test_torch_port_spmd.py over NCCL at 2 and 4
ranks: the catch-all int8 and fp8 quantized pipeline against
``quantized_allreduce_plain`` of the stacked inputs, Adasum (staged
through pinned host memory) against the VHDD oracle, sparse gathers
against the dense sum; needs 4 GPUs. Each skips elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_port_nccl.py
"""

import pytest
import torch

from test_torch_port_collectives import CHECKS, SET_CHECKS, _run_job
from test_torch_port_spmd import (_finish, _ok, _port_job, _read,
                                  check_adasum, check_catch_all,
                                  dense_sparse_sum)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpus():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 3:
        pytest.skip("needs 3 CUDA devices (a multi-GPU machine)")


@pytest.fixture(scope="module")
def job(gpus):
    return _run_job(2, CHECKS + ["no_host_wait"], device="cuda")


@pytest.fixture(scope="module")
def set_job(gpus):
    return _run_job(3, SET_CHECKS, device="cuda")


@pytest.mark.parametrize("check", CHECKS + ["no_host_wait"])
def test_two_rank_nccl_job(job, check):
    assert all(job[rank][check] for rank in range(2)), \
        {rank: job[rank][check] for rank in range(2)}


@pytest.mark.parametrize("check", SET_CHECKS)
def test_three_rank_nccl_process_set_job(set_job, check):
    assert all(set_job[rank][check] for rank in range(3)), \
        {rank: set_job[rank][check] for rank in range(3)}


@pytest.fixture(scope="module")
def order_job(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices (a multi-GPU machine)")
    out = tmp_path_factory.mktemp("nccl-order")
    procs = _port_job("main", "gloo", 2, out, {"PORT_TEST_DEVICE": "cuda"})
    return _ok(_read(out, 2, _finish(procs)))


@pytest.mark.parametrize("check", ["rank_order", "hook_step_equals_full_batch",
                                   "duplicate"])
def test_rank_and_hook_order_over_nccl(order_job, check):
    assert all(order_job[r][check] for r in range(2))
    assert order_job[0]["hook_order"] != order_job[1]["hook_order"]


@pytest.fixture(scope="module")
def elastic_jobs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices (a multi-GPU machine)")
    import torch_port_launch
    from test_torch_port_elastic import _Job
    torch_port_launch.build_port_core()
    root = tmp_path_factory.mktemp("nccl-elastic")
    env = {"ELASTIC_TEST_EPOCHS": 5, "PORT_TEST_DEVICE": "cuda"}
    started = {
        wid: _Job(root, f"kill{wid[-1]}", "transformer", [["localhost:2"]],
                  {**env, "ELASTIC_TEST_KILL_WORKER": wid,
                   "ELASTIC_TEST_KILL_EPOCH": 3})
        for wid in ("localhost:1", "localhost:0")}
    started["ref"] = _Job(root, "ref", "transformer", [["localhost:2"]], env)
    return {name: job.finish() for name, job in started.items()}


@pytest.mark.parametrize("killed", ["localhost:1", "localhost:0"])
def test_nccl_elastic_job_survives_a_killed_rank(elastic_jobs, killed):
    import numpy as np
    job, ref = elastic_jobs[killed], elastic_jobs["ref"]
    for j in (job, ref):
        assert j["rc"] == 0, (j["log"], j["launcher"][-4000:])
        assert sum(" DONE " in line for line in j["log"].splitlines()) == 2
    assert "KILLED step=3" in job["log"]
    assert "aborting this rank's NCCL communicators" in job["launcher"]
    # Each slot computes on its own card, whatever rank it ends with.
    done = {line.split()[0]: line for line in job["log"].splitlines()
            if " DONE " in line}
    assert "rank=0" in done[{"localhost:1": "localhost:0",
                             "localhost:0": "localhost:1"}[killed]], done
    for slot in ("0", "1"):
        assert f"device=cuda:{slot}" in done[f"localhost:{slot}"], done
    got = np.load(job["path"] + ".params.npz")
    want = np.load(ref["path"] + ".params.npz")
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


REDUCE_JOBS = [("int8", 2), ("int8", 4), ("fp8", 2)]


@pytest.fixture(scope="module")
def reduce_jobs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (a multi-GPU machine)")
    import numpy as np
    done = {}
    for wire, size in REDUCE_JOBS:
        out = tmp_path_factory.mktemp(f"nccl-reduce-{wire}-{size}")
        procs = _port_job("reduce", "gloo", size, out, {
            "PORT_TEST_DEVICE": "cuda", "HVDTPU_SPARSE": "gather",
            "HVDTPU_COMPRESSION": f"sp*=none;grad.sp*=none;{wire}"})
        job = _read(out, size, _finish(procs))
        _ok(job)
        done[wire, size] = (job, [dict(np.load(out / f"r{r}.npz"))
                                  for r in range(size)])
    return done


@pytest.mark.parametrize("wire,size", REDUCE_JOBS)
def test_nccl_catch_all_quantized_allreduce_equals_the_plain_pipeline(
        reduce_jobs, wire, size):
    check_catch_all(reduce_jobs[wire, size][1], size, wire)


@pytest.mark.parametrize("size", [2, 4])
def test_nccl_adasum_staged_through_the_host_equals_vhdd(reduce_jobs, size):
    check_adasum(reduce_jobs["int8", size][1], size)


@pytest.mark.parametrize("size", [2, 4])
def test_nccl_sparse_gathers_equal_the_dense_sum(reduce_jobs, size):
    import numpy as np
    job, got = reduce_jobs["int8", size]
    dense, _ = dense_sparse_sum(size)
    for r in range(size):
        assert job["res"][r]["sparse_paths"]["gather"] == 4
        assert job["res"][r]["sparse_train_equal"]
        assert job["res"][r]["sparse_hook_equal"]
        for key, div in (("sp_sum", 1), ("sp_avg", size), ("sp_bind", size),
                         ("spq_rows", 1)):
            np.testing.assert_allclose(got[r][key], dense / div, rtol=1e-6,
                                       atol=1e-6)

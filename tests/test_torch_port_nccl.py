"""The gloo jobs of tests/test_torch_port_collectives.py over NCCL, one
rank per GPU, with every tensor on the rank's card (worker body:
tests/torch_port_worker.py): the same checks, plus one that launches,
polls and synchronizes async allreduces with the host allowed to wait for
nothing; needs 3 GPUs. And the rank-order and hook-order job of
tests/test_torch_port_spmd.py over NCCL (tests/torch_port_spmd_worker.py
with ``PORT_TEST_DEVICE=cuda``); needs 2 GPUs. Each skips elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_port_nccl.py
"""

import pytest
import torch

from test_torch_port_collectives import CHECKS, SET_CHECKS, _run_job
from test_torch_port_spmd import _finish, _ok, _port_job, _read

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

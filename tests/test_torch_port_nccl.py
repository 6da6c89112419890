"""The gloo jobs of tests/test_torch_port_collectives.py over NCCL, one
rank per GPU, with every tensor on the rank's card (worker body:
tests/torch_port_worker.py): the same checks, plus one that launches,
polls and synchronizes async allreduces with the host allowed to wait for
nothing. Needs 3 GPUs; skips elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_port_nccl.py
"""

import pytest
import torch

from test_torch_port_collectives import CHECKS, SET_CHECKS, _run_job

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

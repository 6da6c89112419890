"""gloo jobs of the port on the CPU (worker body: tests/torch_port_worker.py).

Each job is a launcher job (``HVDTPU_PEERS`` from a rendezvous of reserved
ports): every collective goes through the coordinator, the native core
negotiates and fuses, and gloo executes (the delegated plane the card runs
with NCCL). The checks:

- 2 ranks: allreduce Average/Sum with pre/postscale, grouped allreduce,
  broadcast, ragged allgather, object collectives, broadcast_parameters,
  one data-parallel train step that must equal the single-process
  full-batch step; Horovod's torch API (handles, grouped async ops,
  alltoall with and without splits, even and uneven reducescatter, grouped
  allgather and reducescatter, join); SyncBatchNorm against BatchNorm2d
  over the concatenated batch, and the ResNet's BatchNorm with a process
  set against the same over the whole batch; the grad-hook
  DistributedOptimizer; the has_aux step's buffer averaging.
- 3 ranks: a collective on the process set {0, 2}, which rank 1 is not a
  member of.

Each job runs once per module; each check is its own test case.
"""

import shutil
import tempfile

import pytest
import torch.multiprocessing as mp

import torch_port_launch
import torch_port_worker

CHECKS = ["sum", "avg", "scaled", "scaled_avg", "input_untouched",
          "grouped", "broadcast", "allgather", "broadcast_object",
          "allgather_object", "broadcast_parameters", "loss_is_mean",
          "dp_step_equals_full_batch", "bucketed_bit_identical",
          # horovod_tpu_torch.torch
          "handle_poll_synchronize", "handle_not_in_place",
          "handle_in_place", "grouped_async", "dtype_kept", "alltoall_even",
          "alltoall_splits", "reducescatter_even", "reducescatter_uneven",
          "grouped_allgather", "grouped_reducescatter", "join",
          "syncbn_output", "syncbn_input_grad", "syncbn_param_grads",
          "syncbn_running_stats", "resnet_bn_process_set",
          "bucket_launched_in_backward",
          "hook_step_equals_full_batch", "hook_backward_passes_per_step",
          "hook_gradient_predivide", "hook_bit_identical",
          "has_aux_averages_buffers"]
SET_CHECKS = ["set_ids", "subset_allreduce", "subset_broadcast",
              "subset_allgather", "set_removed", "global_allreduce_after"]


def _run_job(size, checks, device="cpu", target=None):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = torch_port_launch.free_port()
    rdv = tempfile.mkdtemp(prefix="hvd-rdv-")
    procs = [ctx.Process(target=target or torch_port_worker.run,
                         args=(r, size, rdv, port, queue, device))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=180) for _ in procs)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    for rank in range(size):
        assert isinstance(results[rank], dict), \
            f"rank {rank} failed:\n{results[rank]}"
        assert sorted(results[rank]) == sorted(checks)
    assert all(p.exitcode == 0 for p in procs)
    return results


@pytest.fixture(scope="module")
def job():
    return _run_job(2, CHECKS)


@pytest.fixture(scope="module")
def set_job():
    return _run_job(3, SET_CHECKS)


@pytest.mark.parametrize("check", CHECKS)
def test_two_rank_gloo_job(job, check):
    assert all(job[rank][check] for rank in range(2)), \
        {rank: job[rank][check] for rank in range(2)}


@pytest.mark.parametrize("check", SET_CHECKS)
def test_three_rank_process_set_job(set_job, check):
    assert all(set_job[rank][check] for rank in range(3)), \
        {rank: set_job[rank][check] for rank in range(3)}

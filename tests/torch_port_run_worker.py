"""Functions and a task script for tests/test_torch_port_run_api.py.

``allreduce_rank`` is what ``horovod_tpu_torch.run`` pickles by reference:
each worker imports this module (the test puts ``tests/`` on the workers'
``PYTHONPATH``), calls ``init(device="cpu")`` over gloo and returns its
rank's view of one allreduce.

    python torch_port_run_worker.py RANK TASK_ARGS_JSON

is a simulated cluster-framework task (a Spark barrier task or a Ray
actor): it gets only its rank and the driver's task arguments, runs
``cluster_task_bootstrap``, then ``init`` and an allreduce, and prints
``rank R/N: CLUSTER-TASK OK``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def allreduce_rank(scale, offset=0.0):
    import torch

    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        x = torch.full((3,), float(hvd.rank() + 1)) * scale + offset
        total = hvd.allreduce(x, op=hvd.Sum, name="run.x")
        return {"rank": hvd.rank(), "size": hvd.size(),
                "local_rank": hvd.local_rank(), "sum": total.tolist()}
    finally:
        hvd.shutdown()


def cluster_task(rank, task_args):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner.cluster import cluster_task_bootstrap
    n, addr, port, token, timeout = json.loads(task_args)
    cluster_task_bootstrap(rank, n, addr, int(port), token, timeout)
    hvd.init(device="cpu")
    assert hvd.rank() == rank and hvd.size() == n
    # All simulated tasks share this host: local == global topology.
    assert hvd.local_size() == n and hvd.cross_size() == 1
    out = hvd.allreduce(torch.ones(4) * (rank + 1), op=hvd.Sum, name="c")
    assert torch.equal(out, torch.full((4,), float(sum(range(1, n + 1)))))
    print(f"rank {rank}/{n}: CLUSTER-TASK OK", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    cluster_task(int(sys.argv[1]), sys.argv[2])

"""One rank of the JAX package's launcher job on its TCP plane, running the
rank-order allreduces of tests/torch_port_spmd_worker.py, a broadcast and
a barrier, for tests/test_torch_port_spmd.py.

    python torch_port_jax_spmd_worker.py RANK SIZE RDV_DIR OUT

Writes ``OUT/r<rank>.npz``, the native timeline ``OUT/tl.json.rank<r>``
and, last, ``OUT/r<rank>.json``.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["JAX_ENABLE_X64"] = "1"   # the int64 and float64 cases

import numpy as np  # noqa: E402

import torch_port_launch  # noqa: E402
from torch_port_spmd_worker import (order_specs, order_value,  # noqa: E402
                                    submission_order)


def main():
    rank, size, rdv, out_dir = sys.argv[1:5]
    rank, size = int(rank), int(size)
    from horovod_tpu import native
    peers = torch_port_launch.peers(rdv, rank, size,
                                    native.reserve_listen_port)
    os.environ.update(torch_port_launch.launcher_env(rank, size, peers, 0))
    os.environ["HVDTPU_TIMELINE"] = os.path.join(out_dir, "tl.json")
    import jax.numpy as jnp
    import horovod_tpu as hvd
    hvd.init()
    specs = order_specs()
    handles = {}
    for i in submission_order(rank):
        n, s, d = specs[i]
        handles[n] = hvd.allreduce_async(
            jnp.asarray(order_value(rank, i, s, d)), name=n, op=hvd.Sum)
    got = {n: np.asarray(hvd.synchronize(h)) for n, h in handles.items()}
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **got)
    hvd.broadcast(jnp.ones(3), root_rank=0, name="bcast")
    hvd.barrier()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump({}, f)


if __name__ == "__main__":
    main()

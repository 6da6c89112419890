"""One rank of the JAX package's launcher job on its TCP plane, running the
rank-order allreduces of tests/torch_port_spmd_worker.py, a broadcast and
a barrier, for tests/test_torch_port_spmd.py.

    python torch_port_jax_spmd_worker.py RANK SIZE RDV_DIR OUT [reduce]

With ``reduce`` it runs that worker's ``reduce`` mode on the same inputs
instead (the environment of ``REDUCE_ENV["tcp"]``), through the JAX
package and its torch binding.

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
from torch_port_spmd_worker import (REDUCE_ENV, SP_ROWS,  # noqa: E402
                                    SP_W, TwoBranches, ad_value, batch,
                                    order_specs, order_value, q_value,
                                    sp_value, submission_order)


def reduce_main(rank, size, out_dir):
    import jax.numpy as jnp
    import torch
    import horovod_tpu as hvd
    import horovod_tpu.torch as jht
    hvd.init()
    res = {}
    for codec in ("int8", "fp8"):
        for step in (0, 1):
            res[f"q_{codec}_{step}"] = np.asarray(hvd.allreduce(
                jnp.asarray(q_value(rank, step, codec)), name=f"q.{codec}",
                op=hvd.Sum, compression=getattr(hvd.Compression, codec)))
    xs = [jnp.asarray(ad_value(rank, i)) for i in range(2)]
    try:
        res["ad_0"] = np.asarray(hvd.allreduce(xs[0], op=hvd.Adasum,
                                               name="ad.0"))
        res["ad_g0"], res["ad_g1"] = [np.asarray(t) for t in
                                      hvd.grouped_allreduce(
                                          xs, op=hvd.Adasum, name="adg")]
        err = None
    except hvd.HorovodInternalError as e:
        err = str(e)
    idx, vals = sp_value(rank)
    sg = hvd.SparseGradient(idx, vals, (SP_ROWS, SP_W))
    res["sp_sum"] = np.asarray(hvd.sparse_allreduce(sg, name="sp.sum",
                                                    op=hvd.Sum))
    res["sp_avg"] = np.asarray(hvd.sparse_allreduce(sg, name="sp.avg"))
    res["spq_rows"] = np.asarray(hvd.sparse_allreduce(sg, name="spq.rows",
                                                      op=hvd.Sum))
    coo = torch.sparse_coo_tensor(torch.from_numpy(idx[None]),
                                  torch.from_numpy(vals), (SP_ROWS, SP_W))
    res["sp_bind"] = jht.synchronize(jht.sparse_allreduce_async(
        coo, name="sp.bind")).to_dense().numpy()
    x = batch()
    shard = x[rank * (6 // size):(rank + 1) * (6 // size)]
    model = TwoBranches()
    opt = jht.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression=jht.Compression.fp16)
    model(shard, True).backward()
    opt.step()
    for n, p in model.named_parameters():
        res[f"fp16_{n}"] = p.detach().numpy()
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **res)
    hvd.barrier()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump({"adasum_error": err}, f)


def main():
    rank, size, rdv, out_dir = sys.argv[1:5]
    rank, size = int(rank), int(size)
    from horovod_tpu import native
    peers = torch_port_launch.peers(rdv, rank, size,
                                    native.reserve_listen_port)
    os.environ.update(torch_port_launch.launcher_env(rank, size, peers, 0))
    if sys.argv[5:6] == ["reduce"]:
        os.environ.update(REDUCE_ENV["tcp"])
        reduce_main(rank, size, out_dir)
        return
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

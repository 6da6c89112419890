"""One rank of a launcher job of the port on the CPU, for
tests/test_torch_port_spmd.py (the plane comes from the environment:
tcp-native by default, the delegated plane over gloo with
``HVDTPU_CPU_OPERATIONS=nccl``).

    python torch_port_spmd_worker.py MODE RANK SIZE RDV_DIR MASTER_PORT OUT

MODE ``main``: named allreduces submitted in rank-dependent orders; the
grad-hook optimizer with rank-dependent backward orders against the
full-batch step; a duplicate in-flight name; a broadcast and a barrier.
MODE ``stall``: rank 0 submits a name no other rank ever does. MODE
``kill``: the last rank dies after a first allreduce. MODE ``reduce``: the
gradient-reduction options (int8/fp8 allreduces over two steps under one
name, Adasum single and grouped, sparse gathers through ``ops.sparse`` and
the binding, the binding's ``DistributedOptimizer`` with fp16
compression), writing ``OUT/r<rank>.npz`` for the JAX package's job of the
same inputs (tests/torch_port_jax_spmd_worker.py ``reduce``). Each rank writes
``OUT/r<rank>.json`` (its checks) and, in ``main``, ``OUT/r<rank>.npz``
(the reduced tensors); stderr carries the native core's stall warning.
With ``PORT_TEST_DEVICE=cuda`` rank r runs on ``cuda:r`` over NCCL
(tests/test_torch_port_nccl.py).
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_port_launch  # noqa: E402

NAMES = [f"order.{i}" for i in range(8)]
DEV = torch.device(os.environ.get("PORT_TEST_DEVICE", "cpu"))


def order_specs():
    """(name, shape, numpy dtype) of the rank-order allreduces."""
    rng = np.random.RandomState(7)
    dtypes = [np.float32, np.float64, np.int64]
    return [(n, tuple(rng.randint(1, 9, size=rng.randint(1, 3))),
             dtypes[i % 3]) for i, n in enumerate(NAMES)]


def order_value(rank, i, shape, dtype):
    rng = np.random.RandomState(100 * rank + i)
    if dtype == np.int64:
        return rng.randint(-50, 50, size=shape).astype(dtype)
    return rng.randn(*shape).astype(dtype)


def submission_order(rank):
    """Rank 0 ascending, rank 1 descending, others a rank-seeded
    permutation."""
    idx = list(range(len(NAMES)))
    if rank == 1:
        return idx[::-1]
    if rank > 1:
        return list(np.random.RandomState(rank).permutation(idx))
    return idx


class TwoBranches(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.a = torch.nn.Linear(4, 3)
        self.b = torch.nn.Linear(4, 5)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))

    def forward(self, x, a_first):
        # Autograd runs the later-created branch first: the order of the
        # two lines decides the order in which the hooks fire.
        if a_first:
            ya = self.a(x)
            yb = self.b(x)
        else:
            yb = self.b(x)
            ya = self.a(x)
        return (ya.tanh().sum(1) + yb.square().sum(1)).mean()


def batch():
    gen = torch.Generator().manual_seed(1)
    return torch.randn(6, 4, generator=gen)


def main_checks(hvd, ht, rank, size, out_dir):
    out = {}
    specs = order_specs()
    tensors = {n: torch.from_numpy(order_value(rank, i, s, d)).to(DEV)
               for i, (n, s, d) in enumerate(specs)}
    handles = {}
    for i in submission_order(rank):
        n = specs[i][0]
        handles[n] = hvd.allreduce_async(tensors[n], name=n, op=hvd.Sum)
    got = {n: hvd.synchronize(h).cpu().numpy() for n, h in handles.items()}
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **got)
    ok = True
    for i, (n, s, d) in enumerate(specs):
        want = sum(order_value(r, i, s, d) for r in range(size))
        ok &= bool(np.allclose(got[n], want, rtol=1e-6, atol=1e-6)
                   and got[n].dtype == d)
    out["rank_order"] = ok

    # The grad-hook optimizer, backward order depending on the rank.
    x = batch().to(DEV)
    shard = x[rank * (6 // size):(rank + 1) * (6 // size)]
    ref = TwoBranches().to(DEV)
    opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    ref(x, True).backward()
    opt.step()
    model = TwoBranches().to(DEV)
    ht.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = ht.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                  named_parameters=model.named_parameters())
    model(shard, rank % 2 == 0).backward()
    names = {p: n for n, p in model.named_parameters()}
    out["hook_order"] = [names[p] for p in opt._hvd_handles]
    opt.step()
    out["hook_step_equals_full_batch"] = all(
        torch.allclose(a, b, atol=1e-6, rtol=1e-5)
        for a, b in zip(model.parameters(), ref.parameters()))

    # A duplicate in-flight name: rank 0 submits "dup" twice before the
    # barrier that lets the other ranks submit theirs, so its first one is
    # surely still in flight.
    t = torch.ones(3, device=DEV)
    out["duplicate"] = True
    if rank == 0:
        h = hvd.allreduce_async(t, name="dup", op=hvd.Sum)
        try:
            hvd.allreduce_async(t, name="dup", op=hvd.Sum)
            out["duplicate"] = False
        except hvd.DuplicateNameError as e:
            out["duplicate"] = "dup" in str(e)
    hvd.barrier()
    if rank != 0:
        h = hvd.allreduce_async(t, name="dup", op=hvd.Sum)
    out["duplicate"] &= torch.equal(hvd.synchronize(h),
                                    torch.full((3,), float(size),
                                               device=DEV))
    hvd.barrier()
    return out


# -- MODE reduce: the inputs, shared with the JAX package's worker ---------
Q_N = 2000          # over the 1024-element threshold; a ragged last block
SP_ROWS, SP_W = 40, 6
REDUCE_ENV = {       # both jobs of the tcp plane, and the JAX package's
    "tcp": {"HVDTPU_SPARSE": "gather", "HVDTPU_COMPRESSION": "spq.*=int8"},
    # The delegated plane: per-call codecs, and the catch-all wire rule for
    # the rest. Sparse names stay exact (a catch-all would row-quantize
    # them).
    "gloo": {"HVDTPU_SPARSE": "gather",
             "HVDTPU_COMPRESSION": "sp*=none;grad.sp*=none;int8"},
}


def q_value(rank, step, codec):
    """A gradient-like vector whose blocks span four decades."""
    rng = np.random.RandomState(1000 * rank + 10 * step + len(codec))
    scale = 10.0 ** rng.randint(-3, 1, size=Q_N // 100 + 1)
    return (rng.randn(Q_N) * np.repeat(scale, 100)[:Q_N]).astype(np.float32)


def ad_value(rank, i):
    rng = np.random.RandomState(500 + 10 * rank + i)
    return rng.randn(*((5, 7), (33,))[i]).astype(np.float32)


def sp_value(rank):
    """(indices, values): 4 + 3·rank distinct rows and one duplicate, so
    that the ranks' row counts differ (ragged gathers)."""
    rng = np.random.RandomState(900 + rank)
    rows = rng.choice(SP_ROWS, size=4 + 3 * rank, replace=False)
    idx = np.concatenate([rows, rows[:1]]).astype(np.int64)
    return idx, rng.randn(idx.shape[0], SP_W).astype(np.float32)


def reduce_checks(hvd, ht, rank, size, out_dir):
    from horovod_tpu_torch import basics
    out, res = {}, {}
    for codec in ("int8", "fp8"):
        for step in (0, 1):
            x = torch.from_numpy(q_value(rank, step, codec)).to(DEV)
            res[f"q_{codec}_{step}"] = ht.allreduce(
                x, name=f"q.{codec}", op=ht.Sum,
                compression=getattr(ht.Compression, codec)).cpu().numpy()
    for step in (0, 1):
        # No per-call codec: the env policy decides (the delegated plane's
        # catch-all rule).
        x = torch.from_numpy(q_value(rank, step, "plain")).to(DEV)
        res[f"q_plain_{step}"] = ht.allreduce(
            x, name="q.plain", op=ht.Sum).cpu().numpy()
    plane = basics.runtime().coordinator._compression
    out["residual_names"] = sorted(
        n for n in ("q.int8", "q.fp8") if plane.residuals.get(n) is not None)
    xs = [torch.from_numpy(ad_value(rank, i)).to(DEV) for i in range(2)]
    try:
        res["ad_0"] = ht.allreduce(xs[0], op=ht.Adasum,
                                   name="ad.0").cpu().numpy()
        res["ad_g0"], res["ad_g1"] = [
            t.cpu().numpy() for t in ht.grouped_allreduce(
                xs, op=ht.Adasum, name="adg")]
        out["adasum_error"] = None
    except hvd.HorovodInternalError as e:
        out["adasum_error"] = str(e)
    idx, vals = sp_value(rank)
    sg = hvd.SparseGradient(torch.from_numpy(idx).to(DEV),
                            torch.from_numpy(vals).to(DEV), (SP_ROWS, SP_W))
    res["sp_sum"] = hvd.sparse_allreduce(sg, name="sp.sum",
                                         op=hvd.Sum).cpu().numpy()
    res["sp_avg"] = hvd.sparse_allreduce(sg, name="sp.avg").cpu().numpy()
    res["spq_rows"] = hvd.sparse_allreduce(sg, name="spq.rows",
                                           op=hvd.Sum).cpu().numpy()
    coo = torch.sparse_coo_tensor(torch.from_numpy(idx[None]),
                                  torch.from_numpy(vals),
                                  (SP_ROWS, SP_W)).to(DEV)
    got = ht.sparse_allreduce(coo, name="sp.bind")
    out["sp_bind_is_sparse"] = bool(got.is_sparse)
    res["sp_bind"] = got.to_dense().cpu().numpy()
    out["sparse_paths"] = dict(basics.runtime().coordinator._sparse
                               .path_counts)
    # Sparse embedding gradients through both optimizers under
    # HVDTPU_SPARSE: SparseAdam steps on the averaged sparse gradient.
    from horovod_tpu_torch import train
    ids = [torch.from_numpy(np.random.RandomState(70 + k).randint(
        0, SP_ROWS, size=(2, 5))).to(DEV) for k in range(size)]
    for tag, wrap in (
            ("train", lambda o, m: train.DistributedOptimizer(o)),
            ("hook", lambda o, m: ht.DistributedOptimizer(
                o, named_parameters=m.named_parameters()))):
        torch.manual_seed(3)
        emb = torch.nn.Embedding(SP_ROWS, SP_W, sparse=True).to(DEV)
        ref = torch.nn.Embedding(SP_ROWS, SP_W, sparse=True).to(DEV)
        ref.load_state_dict(emb.state_dict())
        opt = wrap(torch.optim.SparseAdam(emb.parameters(), lr=0.1), emb)
        ref_opt = torch.optim.SparseAdam(ref.parameters(), lr=0.1)
        emb(ids[rank]).square().sum().backward()
        opt.step()
        for k in range(size):   # the average of every rank's gradient
            (ref(ids[k]).square().sum() / size).backward()
        ref_opt.step()
        out[f"sparse_{tag}_diff"] = float(
            (emb.weight - ref.weight).abs().max())
        out[f"sparse_{tag}_equal"] = bool(
            emb.weight.grad.is_sparse
            and torch.allclose(emb.weight, ref.weight, rtol=1e-6,
                               atol=1e-6))
    # The grad-hook optimizer with fp16 on the wire.
    x = batch().to(DEV)
    shard = x[rank * (6 // size):(rank + 1) * (6 // size)]
    model = TwoBranches().to(DEV)
    opt = ht.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression=ht.Compression.fp16)
    model(shard, True).backward()
    opt.step()
    for n, p in model.named_parameters():
        res[f"fp16_{n}"] = p.detach().cpu().numpy()
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **res)
    hvd.barrier()
    return out


def stall_checks(hvd, rank, size, out_dir):
    warm = hvd.allreduce(torch.ones(4), op=hvd.Sum, name="warm")
    out = {"warm": torch.equal(warm, torch.full((4,), float(size)))}
    sync = os.path.join(out_dir, "stall.done")
    if rank == 0:
        try:
            hvd.allreduce(torch.ones(8), name="lonely")
            out["stall_error"] = "no error"
        except hvd.StalledTensorError as e:
            out["stall_error"] = f"{type(e).__name__}: {e}"
        open(sync, "w").close()
    else:
        deadline = time.monotonic() + 120
        while not os.path.exists(sync):
            assert time.monotonic() < deadline, "no stall signal"
            time.sleep(0.05)
    post = hvd.allreduce(torch.ones(4), op=hvd.Sum, name="post")
    out["post"] = torch.equal(post, torch.full((4,), float(size)))
    return out


def kill_checks(hvd, rank, size):
    warm = hvd.allreduce(torch.ones(4), op=hvd.Sum, name="warm")
    out = {"warm": torch.equal(warm, torch.full((4,), float(size)))}
    if rank == size - 1:
        os._exit(17)
    try:
        hvd.allreduce(torch.ones(4), op=hvd.Sum, name="after")
        out["killed_rank_error"] = "no error"
    except hvd.HorovodInternalError as e:
        out["killed_rank_error"] = type(e).__name__
    return out


def main():
    mode, rank, size, rdv, port, out_dir = sys.argv[1:7]
    rank, size = int(rank), int(size)
    from horovod_tpu_torch import native
    peers = torch_port_launch.peers(rdv, rank, size,
                                    native.reserve_listen_port)
    os.environ.update(torch_port_launch.launcher_env(rank, size, peers,
                                                     int(port)))
    if mode == "main":
        os.environ["HVDTPU_TIMELINE"] = os.path.join(out_dir, "tl.json")
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as ht
    hvd.init(device="cpu" if DEV.type == "cpu" else None)
    try:
        if mode == "main":
            checks = main_checks(hvd, ht, rank, size, out_dir)
        elif mode == "stall":
            checks = stall_checks(hvd, rank, size, out_dir)
        elif mode == "reduce":
            checks = reduce_checks(hvd, ht, rank, size, out_dir)
        else:
            checks = kill_checks(hvd, rank, size)
    finally:
        hvd.shutdown()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(checks, f)


if __name__ == "__main__":
    main()

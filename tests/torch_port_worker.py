"""Worker body of tests/test_torch_port_collectives.py: one rank of a
launcher job on the CPU whose collectives the native core negotiates and
gloo executes (``HVDTPU_CPU_OPERATIONS=nccl``, the delegated plane the card
runs with NCCL); 2 ranks for the collectives, the torch API, SyncBatchNorm
and the optimizers, 3 for process sets, which need a proper subset.
Imports only torch, numpy and the port, so that spawned processes start
quickly."""

import os
import time
import traceback

import numpy as np
import torch

SMALL = dict(vocab_size=64, hidden=32, layers=1, heads=2, max_len=8,
             causal=True, use_rope=True, dtype=torch.float32)
# Where the job's tensors live: the CPU (gloo), or this rank's GPU (NCCL).
DEV = torch.device("cpu")


def _base(rank):
    return torch.arange(6, dtype=torch.float32,
                        device=DEV).reshape(2, 3) + 10 * rank


def _model(seed):
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    return TransformerLM(TransformerConfig(**SMALL),
                         generator=torch.Generator().manual_seed(seed)).to(DEV)


def _loss_fn(model, batch):
    x, y = batch
    logits = model(x)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1))


def _checks(hvd, rank, size):
    out = {}
    # allreduce Average and Sum, with pre- and postscale.
    x = _base(rank)
    total = sum(_base(r) for r in range(size))
    out["sum"] = torch.equal(hvd.allreduce(x, op=hvd.Sum), total)
    out["avg"] = torch.allclose(hvd.allreduce(x, op=hvd.Average),
                                total / size)
    out["scaled"] = torch.allclose(
        hvd.allreduce(x, op=hvd.Sum, prescale_factor=0.5,
                      postscale_factor=3.0), total * 1.5)
    out["scaled_avg"] = torch.allclose(
        hvd.allreduce(x, op=hvd.Average, prescale_factor=2.0,
                      postscale_factor=0.25), total / size * 0.5)
    out["input_untouched"] = torch.equal(
        x, _base(rank))
    grouped = hvd.grouped_allreduce([x, 2 * x], op=hvd.Sum)
    out["grouped"] = (torch.equal(grouped[0], total)
                      and torch.equal(grouped[1], 2 * total))
    # broadcast from the last rank; allgather with ragged first dims.
    b = torch.full((3,), float(rank), device=DEV)
    out["broadcast"] = torch.equal(
        hvd.broadcast(b, root_rank=size - 1),
        torch.full((3,), float(size - 1), device=DEV))

    def rows(r):
        return torch.full((r + 1, 2), r, dtype=torch.int64, device=DEV)
    out["allgather"] = torch.equal(hvd.allgather(rows(rank)),
                                   torch.cat([rows(r) for r in range(size)]))
    obj = {"rank": rank, "payload": list(range(rank + 3))}
    out["broadcast_object"] = hvd.broadcast_object(obj, root_rank=1) == {
        "rank": 1, "payload": [0, 1, 2, 3]}
    out["allgather_object"] = hvd.allgather_object(obj) == [
        {"rank": r, "payload": list(range(r + 3))} for r in range(size)]
    # broadcast_parameters: every rank starts from its own weights and
    # ends with rank 0's.
    model = _model(seed=rank)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    want = _model(seed=0).state_dict().values()
    out["broadcast_parameters"] = all(
        torch.equal(a, b) for a, b in zip(model.state_dict().values(), want))
    hvd.barrier()
    return out


def _responses():
    from horovod_tpu_torch import basics
    return basics.runtime().backend.responses


def _train_checks(hvd, rank, size):
    """One data-parallel step on each rank's half of a batch equals one
    single-process step on the whole batch; the reduction the native core
    fuses is bit-identical to reducing each tensor on its own."""
    out = {}
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randint(0, SMALL["vocab_size"], size=(4, 8)),
                        device=DEV)
    y = torch.as_tensor(rng.randint(0, SMALL["vocab_size"], size=(4, 8)),
                        device=DEV)
    shard = slice(rank * 2, rank * 2 + 2)

    ref = _model(seed=0)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    _loss_fn(ref, (x, y)).backward()
    ref_opt.step()

    model = _model(seed=rank)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    loss = hvd.make_train_step(_loss_fn, opt)(model, (x[shard], y[shard]))
    out["loss_is_mean"] = abs(loss.item()
                              - _loss_fn(_model(seed=0), (x, y)).item()) \
        < 1e-5
    out["dp_step_equals_full_batch"] = all(
        torch.allclose(a, b, atol=1e-6, rtol=1e-5)
        for a, b in zip(model.parameters(), ref.parameters()))

    # Reduced one tensor at a time (each its own response) and as one
    # group that the core fuses into fewer responses than tensors (2 KiB
    # fusion threshold: several per model), from the same gradients: the
    # results must be bit-identical.
    m = _model(seed=0)
    _loss_fn(m, (x[shard], y[shard])).backward()
    per_tensor = [p.grad.clone() for p in m.parameters()]
    fused = [p.grad.clone() for p in m.parameters()]
    scales = dict(prescale_factor=0.5, postscale_factor=2.0)
    for i, g in enumerate(per_tensor):
        hvd.allreduce_(g, op=hvd.Average, name=f"alone.{i}", **scales)
    before = _responses()
    hvd.grouped_allreduce_(fused, op=hvd.Average, name="fused", **scales)
    responses = _responses() - before
    out["bucketed_bit_identical"] = (
        1 < responses < len(fused)
        and all(torch.equal(a, b) for a, b in zip(per_tensor, fused)))
    return out


def _api_checks(ht, rank, size):
    """Horovod's torch API (horovod_tpu_torch.torch): handles, the grouped
    async ops, alltoall, reducescatter, grouped allgather/reducescatter,
    join, dtypes."""
    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=DEV)

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=DEV)
    out = {}
    x = _base(rank)
    total = sum(_base(r) for r in range(size))
    h = ht.allreduce_async(x, op=ht.Sum)
    polled = ht.poll(h)
    got = ht.synchronize(h)
    out["handle_poll_synchronize"] = (
        isinstance(polled, bool) and torch.equal(got, total)
        and ht.poll(h) and torch.equal(ht.synchronize(h), total))
    out["handle_not_in_place"] = torch.equal(x, _base(rank))
    y = x.clone()
    h = ht.allreduce_async_(y, op=ht.Average, postscale_factor=2.0)
    out["handle_in_place"] = (ht.synchronize(h) is y
                              and torch.allclose(y, total / size * 2.0))
    ys = [x.clone(), 3 * x]
    h1 = ht.grouped_allreduce_async(ys, op=ht.Sum)
    h2 = ht.grouped_allreduce_async_(ys, op=ht.Sum)
    r1, r2 = ht.synchronize(h1), ht.synchronize(h2)
    out["grouped_async"] = (
        torch.equal(r1[0], total) and torch.equal(r1[1], 3 * total)
        and r2[0] is ys[0] and torch.equal(ys[0], total)
        and torch.equal(ys[1], 3 * total))
    red = ht.allreduce(full((4,), 1.5 * (rank + 1), torch.bfloat16),
                       op=ht.Sum)
    out["dtype_kept"] = (
        red.dtype == torch.bfloat16
        and torch.equal(red, full((4,), 4.5, torch.bfloat16))
        and ht.allreduce(full((1,), rank, torch.int64),
                         op=ht.Sum).dtype == torch.int64)
    # alltoall without splits: rank r sends row r*size + d to rank d.
    got = ht.alltoall(ar(size * 2).reshape(size, 2) + 100 * rank)
    out["alltoall_even"] = torch.equal(got, torch.stack(
        [ar(2) + 2 * rank + 100 * r for r in range(size)]))
    # with splits: rank r sends r + d + 1 rows to rank d.
    splits = [rank + d + 1 for d in range(size)]
    got, recv = ht.alltoall(full((sum(splits), 2), float(rank)),
                            splits=splits)
    want_recv = [r + rank + 1 for r in range(size)]
    out["alltoall_splits"] = (
        recv.dtype == torch.int32 and recv.tolist() == want_recv
        and torch.equal(got, torch.cat([full((n, 2), float(r))
                                        for r, n in enumerate(want_recv)])))
    # reducescatter: even (4 rows), uneven (5 rows: rank 0 takes 3).
    tri = sum(range(1, size + 1))
    rs = ar(8).reshape(4, 2) * (rank + 1)
    ru = ar(10).reshape(5, 2) * (rank + 1)
    mine, mine_u = slice(rank * 2, rank * 2 + 2), [slice(0, 3),
                                                   slice(3, 5)][rank]
    sum_rs, sum_ru = ar(8).reshape(4, 2) * tri, ar(10).reshape(5, 2) * tri
    out["reducescatter_even"] = (
        torch.equal(ht.reducescatter(rs, op=ht.Sum), sum_rs[mine])
        and torch.allclose(ht.reducescatter(rs), sum_rs[mine] / size))
    out["reducescatter_uneven"] = torch.equal(
        ht.reducescatter(ru, op=ht.Sum), sum_ru[mine_u])
    gg = ht.grouped_allgather([full((rank + 1,), float(rank)),
                               full((1, 2), rank, torch.int64)])
    out["grouped_allgather"] = (
        torch.equal(gg[0], torch.cat([full((r + 1,), float(r))
                                      for r in range(size)]))
        and torch.equal(gg[1], torch.cat([full((1, 2), r, torch.int64)
                                          for r in range(size)])))
    gr = ht.grouped_reducescatter([rs, ru], op=ht.Sum)
    out["grouped_reducescatter"] = (torch.equal(gr[0], sum_rs[mine])
                                    and torch.equal(gr[1], sum_ru[mine_u]))
    out["join"] = ht.join() == size - 1
    if DEV.type == "cuda":
        # Launch, poll and synchronize with the host allowed to wait for
        # nothing (an error here fails the job).
        xs = [full((1024,), float(rank)) for _ in range(3)]
        ys = [full((1024,), float(rank)) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            hs = [ht.allreduce_async_(t, op=ht.Sum) for t in xs]
            hg = ht.grouped_allreduce_async(ys, op=ht.Sum)
            for h in hs + [hg]:
                ht.poll(h)
            res = [ht.synchronize(h) for h in hs] + ht.synchronize(hg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["no_host_wait"] = all(
            torch.equal(t, full((1024,), float(sum(range(size)))))
            for t in res)
    return out


def _syncbn_checks(ht, rank, size):
    """SyncBatchNorm on each rank's half against BatchNorm2d over the
    concatenated batch."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(2 * size, 3, 5, 5, generator=gen) * 2 + 1).to(DEV)
    g = torch.randn(2 * size, 3, 5, 5, generator=gen).to(DEV)
    w, b = torch.randn(3, generator=gen), torch.randn(3, generator=gen)
    ref = torch.nn.BatchNorm2d(3).to(DEV)
    sync = ht.SyncBatchNorm(3).to(DEV)
    for m in (ref, sync):
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
    xr = x.clone().requires_grad_()
    yr = ref(xr)
    (yr * g).sum().backward()
    mine = slice(2 * rank, 2 * rank + 2)
    xs = x[mine].clone().requires_grad_()
    ys = sync(xs)
    (ys * g[mine]).sum().backward()
    tol = dict(atol=1e-5, rtol=1e-4)
    wgrad = ht.allreduce(sync.weight.grad, op=ht.Sum)
    bgrad = ht.allreduce(sync.bias.grad, op=ht.Sum)
    # The ResNet's BatchNorm with a process set (flax's axis_name): the
    # statistics of the whole batch, flax's biased running variance.
    from horovod_tpu_torch.models import resnet
    whole = resnet.BatchNorm(3, device=DEV)
    split = resnet.BatchNorm(3, process_set=ht.global_process_set,
                             device=DEV)
    xw = x.clone().requires_grad_()
    yw = whole(xw)
    (yw * g).sum().backward()
    xp = x[mine].clone().requires_grad_()
    yp = split(xp)
    (yp * g[mine]).sum().backward()
    return {
        "resnet_bn_process_set": (
            torch.allclose(yp, yw[mine], **tol)
            and torch.allclose(xp.grad, xw.grad[mine], **tol)
            and torch.allclose(split.running_var, whole.running_var, **tol)
            and torch.allclose(split.running_mean, whole.running_mean,
                               **tol)),
        "syncbn_output": torch.allclose(ys, yr[mine], **tol),
        "syncbn_input_grad": torch.allclose(xs.grad, xr.grad[mine], **tol),
        "syncbn_param_grads": (torch.allclose(wgrad, ref.weight.grad, **tol)
                               and torch.allclose(bgrad, ref.bias.grad,
                                                  **tol)),
        "syncbn_running_stats": (
            torch.allclose(sync.running_mean, ref.running_mean, **tol)
            and torch.allclose(sync.running_var, ref.running_var, **tol)
            and int(sync.num_batches_tracked) == 1),
    }


def _sgd_full_batch(x, y):
    ref = _model(seed=0)
    opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    _loss_fn(ref, (x, y)).backward()
    opt.step()
    return ref


class _SlowBackward(torch.autograd.Function):
    """Identity whose backward sleeps: the layers above it have their
    gradients (and hooks) well before backward returns."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        time.sleep(0.5)
        return g


def _hook_optimizer_checks(ht, rank, size):
    """The grad-hook DistributedOptimizer: a 2-rank step equals the
    single-process full-batch step (also with backward_passes_per_step=2
    and gradient_predivide_factor); a grad.* response is dispatched before
    backward returns; the fused reduction of the hooks is bit-identical to
    reducing each gradient on its own."""
    from horovod_tpu_torch import basics
    out = {}
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randint(0, SMALL["vocab_size"], size=(4, 8)),
                        device=DEV)
    y = torch.as_tensor(rng.randint(0, SMALL["vocab_size"], size=(4, 8)),
                        device=DEV)
    shard = slice(rank * 2, rank * 2 + 2)
    ref = _sgd_full_batch(x, y)
    close = dict(atol=1e-6, rtol=1e-5)

    def wrapped(**kw):
        model = _model(seed=rank)
        ht.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = ht.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), **kw)
        return model, opt

    model, opt = wrapped()
    backend = basics.runtime().backend
    executed = []
    execute = backend._execute

    def record(d):
        executed.append([backend._handles[h][2] for h in d["handles"]
                         if h in backend._handles])
        return execute(d)
    backend._execute = record
    slow = model.backbone.blocks[0].register_forward_pre_hook(
        lambda mod, args: (_SlowBackward.apply(args[0]),))
    try:
        _loss_fn(model, (x[shard], y[shard])).backward()
        during = [n for names in executed for n in names]
    finally:
        backend._execute = execute
        slow.remove()
    out["bucket_launched_in_backward"] = any(
        n.startswith("grad.") for n in during)
    opt.step()
    out["hook_step_equals_full_batch"] = all(
        torch.allclose(a, b, **close)
        for a, b in zip(model.parameters(), ref.parameters()))

    model, opt = wrapped(backward_passes_per_step=2)
    for i in range(2):
        half = slice(rank * 2 + i, rank * 2 + i + 1)
        _loss_fn(model, (x[half], y[half])).backward()
    opt.step()
    out["hook_backward_passes_per_step"] = all(
        torch.allclose(a, b, **close)
        for a, b in zip(model.parameters(), ref.parameters()))

    model, opt = wrapped(gradient_predivide_factor=4.0)
    _loss_fn(model, (x[shard], y[shard])).backward()
    opt.step()
    out["hook_gradient_predivide"] = all(
        torch.allclose(a, b, **close)
        for a, b in zip(model.parameters(), ref.parameters()))

    # The same local gradients reduced one tensor at a time, and through
    # the hooks, fused by the core (prescale 1/4, postscale 4): bit for bit
    # the same.
    local = _model(seed=0)
    _loss_fn(local, (x[shard], y[shard])).backward()
    per_tensor = [ht.allreduce_(p.grad.clone(), op=ht.Average,
                                name=f"alone.{i}", prescale_factor=0.25,
                                postscale_factor=4.0)
                  for i, p in enumerate(local.parameters())]
    model, opt = wrapped(gradient_predivide_factor=4.0)
    _loss_fn(model, (x[shard], y[shard])).backward()
    opt.synchronize()
    out["hook_bit_identical"] = all(
        torch.equal(p.grad, g) for p, g in zip(model.parameters(),
                                               per_tensor))
    return out


def _aux_checks(hvd, rank, size):
    """make_train_step(has_aux=True) averages the BatchNorm running
    statistics across ranks; num_batches_tracked stays an integer."""
    from horovod_tpu_torch.models import resnet

    def net():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Conv2d(2, 4, 3),
                                   resnet.BatchNorm(4),
                                   torch.nn.Flatten(),
                                   torch.nn.Linear(4 * 4 * 4, 3)).to(DEV)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2 * size, 2, 6, 6, generator=gen).to(DEV)
    y = torch.randint(0, 3, (2 * size,), generator=gen).to(DEV)

    def loss_fn(m, batch):
        return torch.nn.functional.cross_entropy(m(batch[0]), batch[1])
    locals_ = []
    for r in range(size):
        m = net()
        m(x[2 * r:2 * r + 2])
        locals_.append(m[1])
    model = net()
    step = hvd.make_train_step(loss_fn, hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1)), has_aux=True)
    step(model, (x[2 * rank:2 * rank + 2], y[2 * rank:2 * rank + 2]))
    bn = model[1]
    return {"has_aux_averages_buffers": (
        torch.allclose(bn.running_mean,
                       sum(b.running_mean for b in locals_) / size)
        and torch.allclose(bn.running_var,
                           sum(b.running_var for b in locals_) / size)
        and bn.num_batches_tracked.dtype == torch.int64
        and int(bn.num_batches_tracked) == 1)}


def _process_set_checks(hvd, rank, size):
    """A set of ranks {0, 2} of 3: members reduce among themselves, rank 1
    raises as the JAX package's native core does; ids and removal."""
    out = {}
    ps = hvd.add_process_set([0, 2])
    out["set_ids"] = (ps.process_set_id == 1
                      and hvd.process_set_by_id(1) is ps
                      and ps.size() == 2
                      and ps.rank() == {0: 0, 1: None, 2: 1}[rank]
                      and ps.included() == (rank != 1))
    x = torch.full((3,), float(rank + 1), device=DEV)
    if rank == 1:
        try:
            hvd.allreduce(x, op=hvd.Sum, process_set=ps)
            out["subset_allreduce"] = False
        except RuntimeError as e:
            out["subset_allreduce"] = "not a member" in str(e)
        out["subset_broadcast"] = out["subset_allgather"] = True
    else:
        out["subset_allreduce"] = torch.equal(
            hvd.allreduce(x, op=hvd.Sum, process_set=ps),
            torch.full((3,), 4.0, device=DEV))
        out["subset_broadcast"] = torch.equal(
            hvd.broadcast(x, root_rank=2, process_set=ps),
            torch.full((3,), 3.0, device=DEV))
        out["subset_allgather"] = torch.equal(
            hvd.allgather(x[:1], process_set=ps),
            torch.tensor([1.0, 3.0], device=DEV))
    hvd.barrier()
    hvd.remove_process_set(ps)
    try:
        hvd.process_set_by_id(1)
        removed = False
    except ValueError:
        removed = True
    out["set_removed"] = removed and ps.process_set_id is None
    out["global_allreduce_after"] = torch.equal(
        hvd.allreduce(x, op=hvd.Sum), torch.full((3,), 6.0, device=DEV))
    return out


def launch_env(rank, size, rdv_dir, port):
    """Rendezvous (``HVDTPU_PEERS``) and the launcher environment of one
    rank of a CPU job on the delegated plane over gloo."""
    from horovod_tpu_torch import native
    import torch_port_launch
    peers = torch_port_launch.peers(rdv_dir, rank, size,
                                    native.reserve_listen_port)
    os.environ.update(torch_port_launch.launcher_env(rank, size, peers,
                                                     port))
    os.environ["HVDTPU_CPU_OPERATIONS"] = "nccl"


def run(rank, size, rdv_dir, port, queue, device="cpu"):
    """Spawned entry point: report ``(rank, checks or traceback)``. A job
    of 3 ranks runs the process-set checks; one of 2 runs the rest.
    ``device`` "cpu" runs over gloo; "cuda" puts rank r on ``cuda:r`` and
    runs over NCCL. The native core negotiates either way."""
    global DEV
    try:
        launch_env(rank, size, rdv_dir, port)
        # several fused responses for the small model's gradients
        os.environ["HVDTPU_FUSION_THRESHOLD"] = "2048"
        import horovod_tpu_torch as hvd
        import horovod_tpu_torch.torch as ht
        DEV = hvd.init(device="cpu" if device == "cpu" else None).device
        try:
            if size == 3:
                checks = _process_set_checks(hvd, rank, size)
            else:
                checks = _checks(hvd, rank, size)
                checks.update(_train_checks(hvd, rank, size))
                checks.update(_api_checks(ht, rank, size))
                checks.update(_syncbn_checks(ht, rank, size))
                checks.update(_hook_optimizer_checks(ht, rank, size))
                checks.update(_aux_checks(hvd, rank, size))
        finally:
            hvd.shutdown()
        queue.put((rank, checks))
    except Exception:   # noqa: BLE001 — reported to the parent test
        queue.put((rank, traceback.format_exc()))


def example_source(path):
    """``path``'s source with Horovod's PyTorch import pointed at the port."""
    with open(path) as f:
        src = f.read()
    if "import horovod_tpu.torch as hvd" not in src:
        raise ValueError(f"{path} does not import horovod_tpu.torch as hvd")
    return src.replace("import horovod_tpu.torch as hvd",
                       "import horovod_tpu_torch.torch as hvd")


def run_example(rank, size, rdv_dir, port, queue, path):
    """Spawned entry point: run ``path``'s ``main()`` against the port on the
    CPU; report ``(rank, (printed lines, parameter checksums))``."""
    import contextlib
    import io
    try:
        launch_env(rank, size, rdv_dir, port)
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")   # the script's own init() finds it running
        scope = {"__name__": "example"}
        exec(compile(example_source(path), path, "exec"), scope)
        created = []
        net = scope["Net"]
        scope["Net"] = lambda: created.append(net()) or created[-1]
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                scope["main"]()
        finally:
            hvd.shutdown()
        sums = [float(p.detach().double().sum()) for p in
                created[0].parameters()]
        queue.put((rank, (out.getvalue().splitlines(), sums)))
    except Exception:   # noqa: BLE001 — reported to the parent test
        queue.put((rank, traceback.format_exc()))

"""One rank of a 4-rank gloo job of the port's ``parallel/`` on the CPU, for
tests/test_torch_port_parallel.py.

    python torch_port_parallel_worker.py MODE RANK SIZE MASTER_PORT OUT

MODE is the module under test: ``mesh``, ``ring``, ``ulysses``,
``pipeline`` or ``moe``. Every case builds its global inputs from the
seeds of ``tests/test_parallel.py`` (``rand``), takes this rank's shard of
them, runs the port's strategy over the world group and writes what came
out (outputs, gradients, raised errors) to ``OUT/r<rank>.npz``; the test
assembles the shards and holds them to the JAX package's ``shard_map`` run
of the same inputs. A failure writes ``OUT/r<rank>.err`` and exits 1.

MODE ``card`` (tests/test_torch_port_parallel_cuda.py): rank r on
``cuda:r`` of an NCCL group, the four strategies at the TransformerLM's
widths over the ``sp`` axis of a ``make_mesh`` mesh, each against a
witness on one GPU, with times; writes ``OUT/r<rank>.json``.
"""

import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Shapes and seeds of tests/test_parallel.py, shared with the test.
RING = dict(shape=(1, 2, 256, 32))
ULYSSES = dict(shape=(1, 4, 256, 32))
PIPE_SEQ = dict(d=16, m=8, mb=4, stage_seed=10, x_seed=0)
PIPE_GRAD = dict(d=8, m=4, mb=2, stage_seed=20, x_seed=1)
PIPE_HETERO = dict(vocab=32, d=16, f=32, m=8, mb=2, seq=6)
PIPE_ROUNDS = dict(rounds=2, d=8, m=8, mb=2, stage_seed=50, x_seed=2)
MOE = dict(tokens=64, d=16, f=32, e=8, k=2, capacity_factor=8.0)


def rand(shape, seed):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def hetero_inputs(n):
    """The transformer-stage pipeline of ``test_pipeline_transformer_stages
    _with_hetero_ends``: per-stage {w1, w2} (2 blocks each), an embedding,
    an LM head and the (M, mb, seq) tokens."""
    c = PIPE_HETERO
    stages = [{"w1": rand((2, c["d"], c["f"]), 30 + i) * 0.3,
               "w2": rand((2, c["f"], c["d"]), 40 + i) * 0.3}
              for i in range(n)]
    emb = rand((c["vocab"], c["d"]), 5)
    head = rand((c["d"], c["vocab"]), 6) * 0.3
    tokens = np.random.RandomState(7).randint(
        0, c["vocab"], size=(c["m"], c["mb"], c["seq"]))
    return stages, emb, head, tokens


def _t(x, grad=False):
    return torch.tensor(x).requires_grad_(grad)


def _chunk(x, r, n, dim):
    """Rank r's block of ``x`` (a tensor) along ``dim``."""
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


def _local(shape, seed, r, n, dim):
    return _chunk(torch.tensor(rand(shape, seed)), r, n, dim)


def _raises(fn, out, key):
    try:
        fn()
    except ValueError as e:
        out[key] = np.array(str(e))


def mesh_case(r, n, out):
    from horovod_tpu_torch.parallel import AXIS_ORDER, MeshConfig, make_mesh
    import torch.distributed as dist
    mesh = make_mesh(MeshConfig(dp=-1, tp=2))
    out["names"] = np.array(mesh.mesh_dim_names)
    out["layout"] = mesh.mesh.numpy()
    for name in AXIS_ORDER:
        out[f"size_{name}"] = np.array(mesh[name].size())
        out[f"ranks_{name}"] = np.array(
            dist.get_process_group_ranks(mesh[name].get_group()))


def ring_case(r, n, out):
    from horovod_tpu_torch.parallel import ring_attention
    import torch.distributed as dist
    world = dist.group.WORLD
    q, k, v = (_local(RING["shape"], i, r, n, 2) for i in range(3))
    for causal in (True, False):
        for impl in ("flash", "einsum"):
            o = ring_attention(q, k, v, world, causal=causal, impl=impl)
            out[f"out_{causal}_{impl}"] = o.numpy()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ring_attention(*leaves, world, causal=True)
    (o ** 2).sum().backward()
    for name, x in zip("qkv", leaves):
        out[f"grad_{name}"] = x.grad.numpy()


def ulysses_case(r, n, out):
    from horovod_tpu_torch.parallel import ulysses_attention
    import torch.distributed as dist
    world = dist.group.WORLD
    q, k, v = (_local(ULYSSES["shape"], i, r, n, 2) for i in range(3))
    for causal in (True, False):
        out[f"out_{causal}"] = ulysses_attention(q, k, v, world,
                                                 causal=causal).numpy()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ulysses_attention(*leaves, world, causal=True)
    (o ** 2).sum().backward()
    for name, x in zip("qkv", leaves):
        out[f"grad_{name}"] = x.grad.numpy()
    two = _local((1, 2, 64, 32), 0, r, n, 2)
    _raises(lambda: ulysses_attention(two, two, two, world), out,
            "indivisible_error")


def _tanh_stage(w, x):
    return torch.tanh(x @ w)


def _block(w, h):
    mu = h.mean(-1, keepdim=True)
    hn = (h - mu) / torch.sqrt(h.var(-1, keepdim=True, unbiased=False)
                               + 1e-5)
    return h + torch.nn.functional.gelu(hn @ w["w1"], approximate="tanh") \
        @ w["w2"]


def _two_block_stage(wstack, h):
    for i in range(2):
        h = _block({k: a[i] for k, a in wstack.items()}, h)
    return h


def pipeline_case(r, n, out):
    from horovod_tpu_torch.parallel import pipeline_apply, stack_stage_params
    import torch.distributed as dist
    world = dist.group.WORLD

    c = PIPE_SEQ
    stages = [torch.tensor(rand((c["d"], c["d"]), c["stage_seed"] + i))
              for i in range(n)]
    stacked = stack_stage_params(stages)
    x = torch.tensor(rand((c["m"], c["mb"], c["d"]), c["x_seed"]))
    out["seq_out"] = pipeline_apply(
        _tanh_stage, stacked[r:r + 1], _chunk(x, r, n, 0), world).numpy()

    c = PIPE_GRAD
    stages = [torch.tensor(rand((c["d"], c["d"]), c["stage_seed"] + i))
              for i in range(n)]
    block = stack_stage_params(stages)[r:r + 1].clone().requires_grad_()
    x = torch.tensor(rand((c["m"], c["mb"], c["d"]), c["x_seed"]))
    y = pipeline_apply(_tanh_stage, block, _chunk(x, r, n, 0), world)
    (y ** 2).sum().backward()
    out["grad_block"] = block.grad.numpy()

    stages, emb, head, tokens = hetero_inputs(n)
    stacked = stack_stage_params(
        [{k: torch.tensor(a) for k, a in s.items()} for s in stages])
    block = {k: a[r:r + 1].clone().requires_grad_()
             for k, a in stacked.items()}
    emb_t, head_t = _t(emb, True), _t(head, True)
    y = pipeline_apply(
        _two_block_stage, block, _chunk(torch.tensor(tokens), r, n, 0),
        world, first_fn=lambda e, t: e[t], first_params=emb_t,
        last_fn=lambda hd, h: h @ hd, last_params=head_t)
    out["hetero_out"] = y.detach().numpy()
    (y ** 2).mean().backward()
    for name, a in block.items():
        out[f"hetero_grad_{name}"] = a.grad.numpy()
    out["hetero_grad_emb"] = emb_t.grad.numpy()
    out["hetero_grad_head"] = head_t.grad.numpy()

    c = PIPE_ROUNDS
    rounds = c["rounds"]
    stages = [torch.tensor(rand((c["d"], c["d"]), c["stage_seed"] + i))
              for i in range(n * rounds)]
    stacked = stack_stage_params(stages, n_ranks=n)
    block = stacked[r * rounds:(r + 1) * rounds].clone().requires_grad_()
    x = torch.tensor(rand((c["m"], c["mb"], c["d"]), c["x_seed"]))
    y = pipeline_apply(_tanh_stage, block, _chunk(x, r, n, 0), world,
                       rounds=rounds)
    loss = (y ** 2).sum()
    loss.backward()
    out["rounds_loss"] = loss.detach().numpy()
    out["rounds_grad_block"] = block.grad.numpy()
    _raises(lambda: pipeline_apply(_tanh_stage, stacked[r], x[:2], world,
                                   rounds=rounds), out, "rounds_error")


def moe_case(r, n, out):
    from horovod_tpu_torch.parallel import moe_apply
    from horovod_tpu_torch.parallel.axis import psum
    import torch.distributed as dist
    world = dist.group.WORLD
    c = MOE
    x = torch.tensor(rand((c["tokens"], c["d"]), 0))
    w_gate = torch.tensor(rand((c["d"], c["e"]), 1))
    w_in = torch.tensor(rand((c["e"], c["d"], c["f"]), 2))
    w_out = torch.tensor(rand((c["e"], c["f"], c["d"]), 3))
    local = (_chunk(x, r, n, 0), w_gate, _chunk(w_in, r, n, 0),
             _chunk(w_out, r, n, 0))
    kw = dict(axis=world, k=c["k"], capacity_factor=c["capacity_factor"])
    y, aux = moe_apply(*local, **kw)
    out["y"], out["aux"] = y.numpy(), aux.numpy()
    wg = w_gate.clone().requires_grad_()
    y, _ = moe_apply(local[0], wg, *local[2:], **kw)
    psum((y ** 2).sum(), world).backward()
    out["grad_gate"] = wg.grad.numpy()


CASES = {"mesh": mesh_case, "ring": ring_case, "ulysses": ulysses_case,
         "pipeline": pipeline_case, "moe": moe_case}


# -- the card: the four strategies at full width (mode ``card``) -----------

# Ring attention and Ulysses: the TransformerLM's heads over a global
# sequence of 32768 (8192 per rank at n = 4).
CARD_ATTN = dict(heads=16, head_dim=64, seq=32768)
CARD_MOE = dict(tokens=4096, d=1024, f=4096, e=8, k=2, capacity_factor=1.25)
CARD_REPS = 5
# Tolerances against the one-GPU witness. The ring rounds each chunk's O to
# bf16 once before its fp32 merge (four ulps, 2^-5, as chip_smoke's
# RING_TOL), and autograd sums each of dQ, dK, dV from n = 4 bf16 partials
# in bf16 (a rounding of the running sum per hop: 2^-4); atol covers
# elements near zero, the Frobenius limit a chunk lost or counted twice.
# Ulysses runs the witness's per-head arithmetic (the kernels' limits).
# MoE: the experts' products see n*C rows instead of C (another cuBLAS
# shape, a bf16 rounding the other way now and then).
RING_FWD_TOL = (2e-2, 2 ** -5, 1e-2)
RING_GRAD_TOL = (2e-2, 2 ** -4, 1e-2)
BF16_TOL = (1e-2, 2 ** -6, 1e-2)
MOE_GRAD_FRO = 1e-2


def _card_checks(pairs, tol):
    """{name: [max abs error, relative Frobenius error, within tol]}."""
    atol, rtol, fro_limit = tol
    out = {}
    for name, (got, want) in pairs.items():
        g, w_ = got.detach().float(), want.detach().float()
        diff = (g - w_).abs()
        fro = float(diff.norm() / w_.norm().clamp_min(1e-30))
        ok = not bool((diff > atol + rtol * w_.abs()).any()) \
            and fro <= fro_limit
        out[name] = [float(diff.max()), fro, ok]
    return out


def _timed(fn, world):
    """Median ms of ``fn`` from idle devices (all ranks past a barrier) to
    the end of its work on this one."""
    import time
    import torch.distributed as dist
    fn()
    times = []
    for _ in range(CARD_REPS):
        torch.cuda.synchronize()
        dist.barrier(group=world)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _card_attention(r, n, dev, world):
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import (ring_attention,
                                            ulysses_attention)
    from horovod_tpu_torch.parallel.axis import all_to_all, ppermute
    from horovod_tpu_torch.parallel.ring_attention import _ring_local
    c = CARD_ATTN
    shape = (1, c["heads"], c["seq"], c["head_dim"])
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    s = c["seq"] // n

    def loc(x, j=r):
        return x[:, :, j * s:(j + 1) * s].contiguous()

    def fwd_bwd(fn, full=False):
        leaves = [(x if full else loc(x)).detach().requires_grad_()
                  for x in (q, k, v)]
        o = fn(*leaves)
        return [o] + list(torch.autograd.grad(o, leaves,
                                              do if full else loc(do)))

    def whole(*a):
        return fa.flash_attention(*a, causal=True)
    witness = [loc(x) for x in fwd_bwd(whole, full=True)]
    res = {"witness_ms": _timed(lambda: fwd_bwd(whole, full=True), world)}
    names = ("O", "dQ", "dK", "dV")
    for key, fn, tols in (
            ("ring", ring_attention, (RING_FWD_TOL,) + (RING_GRAD_TOL,) * 3),
            ("ulysses", ulysses_attention, (BF16_TOL,) * 4)):
        fa.reset_launches()
        got = fwd_bwd(lambda *a: fn(*a, world, causal=True))
        torch.cuda.synchronize()
        checks = {}
        for name, g, w_, tol in zip(names, got, witness, tols):
            checks.update(_card_checks({name: (g, w_)}, tol))
        res[key] = {"checks": checks,
                    "launches": dict(fa.LAUNCHES),
                    "ms": _timed(lambda: fwd_bwd(
                        lambda *a: fn(*a, world, causal=True)), world)}

    # The ring's kernels alone: this rank's n LSE-mode calls and merges,
    # forward and backward, through the ring's own loop on chunks already
    # in place (the rotation an index into them).
    chunks = [(loc(k, j), loc(v, j)) for j in range(n)]

    def kernels_only():
        held = [r]

        def rotate(kv):
            held[0] = (held[0] - 1) % n
            return lambda: chunks[held[0]]

        def attend(qc, kc, vc, q_offset, k_offset):
            return fa.flash_attention(qc, kc, vc, causal=True,
                                      q_offset=q_offset, k_offset=k_offset,
                                      with_lse=True)
        ql = loc(q).requires_grad_()
        o = _ring_local(ql, chunks[r], r, n, rotate, attend)
        torch.autograd.grad(o.to(q.dtype), ql, loc(do))
    res["ring"]["kernels_ms"] = _timed(kernels_only, world)
    kv = chunks[r]
    perm = [(i, (i + 1) % n) for i in range(n)]
    res["ring"]["ppermute_bytes"] = 2 * kv[0].numel() * kv[0].element_size()
    res["ring"]["ppermute_ms"] = _timed(lambda: ppermute(kv, perm, world),
                                        world)
    stacked = torch.stack((loc(q), loc(k), loc(v)))
    res["ulysses"]["a2a_bytes"] = stacked.numel() * stacked.element_size()
    res["ulysses"]["a2a_ms"] = _timed(
        lambda: all_to_all(stacked, world, 2, 3), world)
    return res


def _card_moe(r, n, dev, world):
    from horovod_tpu_torch.parallel import moe_apply
    from horovod_tpu_torch.parallel.axis import all_to_all, psum
    c = CARD_MOE
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(n * c["tokens"], c["d"], generator=gen,
                    device=dev).to(torch.bfloat16)
    ws = [torch.randn(shape, generator=gen, device=dev) * shape[-2] ** -0.5
          for shape in ((c["d"], c["e"]), (c["e"], c["d"], c["f"]),
                        (c["e"], c["f"], c["d"]))]
    kw = dict(k=c["k"], capacity_factor=c["capacity_factor"])
    e_loc = c["e"] // n

    def xs(j):
        return x[j * c["tokens"]:(j + 1) * c["tokens"]]

    def mine(w_):
        return w_[r * e_loc:(r + 1) * e_loc]

    def ep():
        leaves = [ws[0].detach().requires_grad_()] + [
            mine(w_).detach().requires_grad_() for w_ in ws[1:]]
        y, aux = moe_apply(xs(r), *leaves, axis=world, **kw)
        loss = psum((y.float() ** 2).mean(), world) + aux
        return [y, aux] + list(torch.autograd.grad(loss, leaves))

    def witness():
        leaves = [w_.detach().requires_grad_() for w_ in ws]
        total, ys, auxs = 0.0, [], []
        for j in range(n):
            y, aux = moe_apply(xs(j), *leaves, **kw)
            total = total + (y.float() ** 2).mean() + aux / n
            ys.append(y)
            auxs.append(aux)
        g = torch.autograd.grad(total, leaves)
        return [ys[r], sum(auxs) / n, g[0], mine(g[1]), mine(g[2])]
    got, want = ep(), witness()
    checks = _card_checks({"y": (got[0], want[0])}, BF16_TOL)
    checks.update(_card_checks({"aux": (got[1], want[1])}, (0, 1e-5, 1e-5)))
    checks.update(_card_checks(dict(zip(
        ("d w_gate", "d w_in", "d w_out"), zip(got[2:], want[2:]))),
        (float("inf"), 0.0, MOE_GRAD_FRO)))
    cap = int(np.ceil(c["k"] * c["tokens"] * c["capacity_factor"] / c["e"]))
    buf = torch.randn(c["e"], cap, c["d"], generator=gen,
                      device=dev).to(torch.bfloat16)
    return {"checks": checks, "ms": _timed(ep, world),
            "witness_ms": _timed(witness, world),
            "a2a_bytes": buf.numel() * buf.element_size(),
            "a2a_ms": _timed(lambda: all_to_all(buf, world, 0, 1), world)}


def card_case(r, n, out):
    import chip_smoke
    from horovod_tpu_torch import models, parallel
    dev = torch.device("cuda", r)
    mesh = parallel.make_mesh(parallel.MeshConfig(dp=1, sp=n))
    world = mesh["sp"].get_group()
    out["attention"] = _card_attention(r, n, dev, world)
    torch.cuda.empty_cache()
    out["moe"] = _card_moe(r, n, dev, world)
    torch.cuda.empty_cache()
    for stages in (n, 2 * n):
        out[f"pipeline_{stages}"] = chip_smoke._pipeline_child(
            models, parallel, world, stages=stages)
        torch.cuda.empty_cache()


def main():
    mode, rank, size, port, out_dir = sys.argv[1:6]
    rank, size = int(rank), int(size)
    torch.set_num_threads(1)
    import datetime
    import torch.distributed as dist
    card = mode == "card"
    try:
        kw = {}
        if card:
            # A collective that never completes fails the job after the
            # timeout instead of holding the GPUs.
            torch.cuda.set_device(rank)
            kw = dict(device_id=torch.device("cuda", rank),
                      timeout=datetime.timedelta(seconds=300))
        dist.init_process_group("nccl" if card else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=size, **kw)
        out = {}
        (card_case if card else CASES[mode])(rank, size, out)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        with open(os.path.join(out_dir, f"r{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    if card:
        import json
        with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
            json.dump(out, f)
    else:
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), **out)


if __name__ == "__main__":
    main()

"""One rank of a 4-rank gloo job of the port's ``resharding/``,
``parallel/sharding.py`` and ``parallel/twod.py`` on the CPU, for
tests/test_torch_port_resharding.py and tests/test_torch_port_sharding.py.

    python torch_port_sharding_worker.py MODE RANK SIZE MASTER_PORT OUT

MODE:

- ``reshard``: ``make_jit_executor`` over a one-axis ``DeviceMesh`` and
  ``execute_group`` over the world group on the programs of ``GROUP_CASES``
  (destination cohorts smaller than the source, pending sums, mixed
  dtypes); each rank writes its destination buffers.
- ``shard_fsdp`` / ``shard_dp``: ``shard_model`` of the TransformerLM whose
  flax parameters ``OUT/../params.npz`` holds (the test writes it), at
  (dp 1, fsdp 2, tp 2) / (dp 2, fsdp 1, tp 2): 3 AdamW steps on this rank's
  batch slice; losses and, from rank 0, the gathered parameters.
- ``twod``: ``TwoDZero`` at (dp 2, tp 2) on the toy loss of
  tests/test_twod.py, 2 steps against the port's same-mesh oracle, then
  ``reshard_2d`` to (dp 1, tp 2) and one step on the new mesh against the
  oracle there.

Every case writes ``OUT/r<rank>.npz``; a failure writes ``OUT/r<rank>.err``
and exits 1. MODE ``card`` (tests/test_torch_port_sharding_cuda.py) runs
rank r on ``cuda:r`` of an NCCL group at the TransformerLM's full width
and writes ``OUT/r<rank>.json``.
"""

import functools
import os
import subprocess
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 4
# The sharded TransformerLM of tests/test_parallel.py's FSDP test.
LM = dict(vocab_size=128, hidden=32, layers=2, heads=2, max_len=16)
LM_BATCH, LM_STEPS, LM_LR, LM_WD = 8, 3, 1e-2, 1e-4
SHARD_MESHES = {"shard_fsdp": dict(dp=1, fsdp=2, tp=2),
                "shard_dp": dict(dp=2, fsdp=1, tp=2)}
TWOD_LR = 1e-2
JIT_CASE = dict(meta=[((8, 4), "float32"), ((16,), "float32")], seed=13)


def rand_tree(meta, seed):
    """tests/test_resharding.py's ``_rand_tree``."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) if shape
            else np.asarray(rng.randn(), dtype)
            for shape, dtype in meta]


def lm_batch():
    rng = np.random.RandomState(3)
    x = rng.randint(0, LM["vocab_size"], size=(LM_BATCH, LM["max_len"]))
    y = rng.randint(0, LM["vocab_size"], size=(LM_BATCH, LM["max_len"]))
    return x, y


def twod_params(seed=1):
    """tests/test_twod.py's ``_params``, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"mlp_in": {"kernel": rng.normal(size=(8, 4)).astype(np.float32),
                       "bias": rng.normal(size=(4,)).astype(np.float32)},
            "scale": rng.normal(size=(8,)).astype(np.float32)}


def twod_batch(seed=2):
    return np.random.default_rng(seed).normal(size=(16, 8)).astype(
        np.float32)


def twod_loss(p, b):
    """tests/test_twod.py's column-decomposable toy loss."""
    h = b * p["scale"]
    y = h @ p["mlp_in"]["kernel"] + p["mlp_in"]["bias"]
    return torch.sum(y * y)


def port_plan(meta, n):
    """The port's ZeRO plan of leaves ``meta`` over ``n`` ranks."""
    from horovod_tpu_torch.ops.zero import plan_zero
    return plan_zero([torch.empty(s, dtype=getattr(torch, d), device="meta")
                      for s, d in meta], n)


def group_cases(resharding, plan):
    """name -> (src spec, dst spec, meta, per-source-rank leaves), in the
    package ``resharding`` with its ``plan(meta, n)``."""
    out = {}
    meta = [((37,), "float32"), ((13, 5), "float32"), ((5,), "float32")]
    z4 = resharding.zero_flat_spec(plan(meta, 4), axis="z")
    leaves = rand_tree(meta, 0)
    out["zero4_to_rep2"] = (z4, resharding.replicated_spec(3, {"s": 2}),
                            meta, {r: leaves for r in range(4)})
    leaves3 = rand_tree(meta, 3)
    z2 = resharding.zero_flat_spec(plan(meta, 2), axis="z")
    out["zero4_to_zero2"] = (z4, z2, meta, {r: leaves3 for r in range(4)})
    rows = [((13, 5), "float32")]
    out["zero4_to_rows3"] = (
        resharding.zero_flat_spec(plan(rows, 4), axis="z"),
        resharding.Spec({"s": 3}, [resharding.Sharded("s", 0, even=False)]),
        rows, {r: rand_tree(rows, 5) for r in range(4)})
    summed = [((8, 4), "float32")]
    base = rand_tree(summed, 11)
    out["pending_sum"] = (
        resharding.Spec({"d": 4}, [resharding.Replicated()],
                        pending_sum=True),
        resharding.Spec({"d": 4}, [resharding.Sharded("d", 0)]),
        summed, {r: [lv * (r + 1) for lv in base] for r in range(4)})
    mixed = [((8, 6), "float32"), ((10,), "bfloat16"), ((3,), "int32")]
    rng = np.random.RandomState(21)
    mleaves = [rng.randn(8, 6).astype(np.float32),
               torch.tensor(rng.randn(10), dtype=torch.bfloat16),
               rng.randint(-50, 50, size=(3,)).astype(np.int32)]
    out["mixed_rep4_to_zero2"] = (
        resharding.Spec({"m": 4}, [resharding.Sharded("m", 0),
                                   resharding.Replicated(),
                                   resharding.Replicated()]),
        resharding.zero_flat_spec(plan(mixed, 2), axis="m"),
        mixed, {r: mleaves for r in range(4)})
    return out


def _np(t):
    """A numpy copy (``.numpy()`` of a CPU tensor aliases it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


# ---------------------------------------------------------------------------
# reshard
# ---------------------------------------------------------------------------

def reshard_case(r, n, out):
    from torch.distributed.device_mesh import DeviceMesh
    from horovod_tpu_torch import resharding
    meta = JIT_CASE["meta"]
    leaves = rand_tree(meta, JIT_CASE["seed"])
    src = resharding.zero_flat_spec(port_plan(meta, n), axis="hvd")
    dst = resharding.Spec({"hvd": n}, [resharding.Sharded("hvd", 1),
                                       resharding.Sharded("hvd", 0)])
    program = resharding.plan_redistribution(src, dst, meta)
    mesh = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("hvd",))
    run = resharding.make_jit_executor(program, mesh, "hvd")
    got = run(resharding.buffers_of_tree(src, meta, leaves, r))
    for key, buf in got.items():
        out[f"jit_{key[0]}{key[1]}"] = _np(buf)
    for name, (s, d, m, per_rank) in group_cases(resharding,
                                                  port_plan).items():
        program = resharding.plan_redistribution(s, d, m,
                                                 bucket_bytes=64)
        mine = resharding.buffers_of_tree(s, m, per_rank[r], r) \
            if r < s.world else {}
        bufs, rep = resharding.execute_group(
            program, resharding.reader_for_buffers({r: mine}))
        for key, buf in bufs.items():
            out[f"{name}_{key[0]}{key[1]}"] = _np(buf)
        out[f"{name}_peak"] = np.array(rep["peak_bytes"])
        if name == "zero4_to_zero2":
            back = resharding.plan_redistribution(d, s, m, bucket_bytes=64)
            again, _ = resharding.execute_group(
                back, resharding.reader_for_buffers({r: bufs}))
            for key, buf in again.items():
                out[f"roundtrip_{key[0]}{key[1]}"] = _np(buf)


# ---------------------------------------------------------------------------
# shard_model
# ---------------------------------------------------------------------------

def _load_flax(path):
    """The flax tree written by the test (``a/b/c`` keys)."""
    tree = {}
    for key, val in np.load(path).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def shard_case(r, n, out, mode, params_path):
    from horovod_tpu_torch import models
    from horovod_tpu_torch.models.transformer import params_from_flax
    from horovod_tpu_torch.parallel import MeshConfig, make_mesh
    from horovod_tpu_torch.parallel.sharding import shard_model
    cfg = models.TransformerConfig(dtype=torch.float32, causal=True,
                                   use_rope=True, attention_impl="flash",
                                   **LM)
    model = models.TransformerLM(cfg)
    model.load_state_dict(params_from_flax(_load_flax(params_path), cfg))
    mesh = make_mesh(MeshConfig(**SHARD_MESHES[mode]))
    sm = shard_model(model, mesh)
    for name, t in sm.local_state_dict().items():
        out[f"init_{name}"] = _np(t)
    opt = torch.optim.AdamW(sm.parameters(), lr=LM_LR, weight_decay=LM_WD)
    x, y = (sm.local_batch(torch.as_tensor(a)) for a in lm_batch())
    losses = [float(sm.train_step(opt, x, y)) for _ in range(LM_STEPS)]
    out["losses"] = np.array(losses)
    out["local_shapes"] = np.array(
        [str(tuple(p.shape)) for p in sm.parameters()])
    full = sm.full_state_dict()
    if r == 0:
        for name, t in full.items():
            out[f"param_{name}"] = _np(t)


# ---------------------------------------------------------------------------
# TwoDZero
# ---------------------------------------------------------------------------

def _oracle(tz, leaves, opt):
    """The same-mesh data-parallel reference step on ``tz``'s mesh:
    tensor-local ``leaves``, the gradients of tp-replicated leaves summed
    over tp, then averaged over dp, and one replicated inner optimizer
    ``opt`` over the local leaves."""
    import torch.distributed as dist
    from horovod_tpu_torch.utils import tree as T
    specs = tz._spec_leaves()

    def step(batch):
        ps = [p.detach().requires_grad_() for p in leaves]
        loss = twod_loss(T.unflatten(tz.treedef, ps), batch)
        grads = list(torch.autograd.grad(loss, ps))
        for i, sp in enumerate(specs):
            if tz.tp > 1 and tz._tp_replicated(sp):
                dist.all_reduce(grads[i], group=tz._group("tp"))
        for g in grads:
            dist.all_reduce(g, group=tz._group("dp"))
            g.div_(tz.dp)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        total = loss.detach().clone()
        for a in ("dp", "tp"):
            dist.all_reduce(total, group=tz._group(a))
        return total
    return step


def twod_case(r, n, out):
    from horovod_tpu_torch.utils import tree as T
    glob = T.map_with_path(lambda _, a: torch.as_tensor(a), twod_params())
    twod_run(r, glob, torch.as_tensor(twod_batch()),
             functools.partial(torch.optim.Adam, lr=TWOD_LR), out)


def twod_run(r, glob, batch, inner, out):
    """``TwoDZero`` at (dp 2, tp 2) from the global tree ``glob``, 2 steps
    on this rank's dp share of ``batch`` beside the same-mesh oracle, then
    ``reshard_2d`` to (dp 1, tp 2) and one step of each on the whole
    batch. Writes losses, parameters and moments (numpy) into ``out``."""
    from horovod_tpu_torch.parallel import twod
    from horovod_tpu_torch.utils import tree as T
    mesh4 = twod.make_mesh_2d(2, 2)
    mesh2 = twod.make_mesh_2d(1, 2)
    tz4 = twod.TwoDZero(inner, mesh4)
    local = tz4.shard(glob)
    d = tz4._coord("dp")
    rows = batch.shape[0] // 2
    mine = batch[d * rows:(d + 1) * rows]
    state = tz4.init_state(local)
    step = tz4.make_step(twod_loss)
    o_leaves = [x.clone() for x in T.leaves(local)]
    o_opt = inner(o_leaves)
    o_step = _oracle(tz4, o_leaves, o_opt)
    p = local
    for i in range(2):
        p, state, loss = step(p, state, mine)
        out[f"loss{i}"] = _np(loss)
        out[f"oracle_loss{i}"] = _np(o_step(mine))
    for j, leaf in enumerate(T.leaves(p)):
        out[f"p4_{j}"] = _np(leaf)
        out[f"oracle_p4_{j}"] = _np(o_leaves[j])
    for k in range(len(tz4.plan.buckets)):
        for slot, v in state.moments(k).items():
            out[f"m4_{k}_{slot}"] = _np(v)
    # (2, 2) -> (1, 2): ranks 2 and 3 leave; the moments move by the plan.
    tz2 = twod.TwoDZero(inner, mesh2)
    new_state = twod.reshard_2d(state, tz4, tz2, glob)
    out["on_new"] = np.array(new_state is not None)
    if r >= 2:
        return
    for k in range(len(tz2.plan.buckets)):
        for slot, v in new_state.moments(k).items():
            out[f"m2_{k}_{slot}"] = _np(v)
    # The next step on the new mesh (dp 1: the whole batch), and the
    # oracle's next step there from its own parameters and state (ranks 0
    # and 1 keep their tp slices).
    pa, _, la = tz2.make_step(twod_loss)(p, new_state, batch)
    out["loss_after"] = _np(la)
    out["oracle_loss_after"] = _np(_oracle(tz2, o_leaves, o_opt)(batch))
    for j, leaf in enumerate(T.leaves(pa)):
        out[f"p2_{j}"] = _np(leaf)
        out[f"oracle_p2_{j}"] = _np(o_leaves[j])


def twod_moved(res, r):
    """On new rank r (tp slice r), whether each moment of bucket k equals
    the old dp ranks' windows of that slice, concatenated (up to the new
    vector's length)."""
    ok = True
    for key in [k for k in res[r] if k.startswith("m2_")]:
        slot_key = "m4_" + key[3:]
        if res[r][key].ndim == 0:
            ok &= bool(res[r][key] == res[r][slot_key])
            continue
        old = np.concatenate([res[dd * 2 + r][slot_key] for dd in range(2)])
        new = res[r][key]
        size = min(len(new), len(old))
        ok &= bool(np.array_equal(new[:size], old[:size]))
    return ok


# ---------------------------------------------------------------------------
# axis: the tiled all_gather / psum_scatter and their backwards
# ---------------------------------------------------------------------------

AXIS = dict(shape=(2, 8, 3), x_seed=40, c_seed=50)


def axis_inputs(n):
    """Global x (2, 8, 3), per-rank cotangent weights (n, 2, 8, 3) and
    (n, 2, 8 // n, 3), and one weight shared by every rank."""
    c = AXIS
    x = np.random.RandomState(c["x_seed"]).normal(size=c["shape"]).astype(
        np.float32)
    rng = np.random.RandomState(c["c_seed"])
    per_rank = rng.normal(size=(n,) + c["shape"]).astype(np.float32)
    scattered = rng.normal(size=(n, 2, 8 // n, 3)).astype(np.float32)
    shared = rng.normal(size=c["shape"]).astype(np.float32)
    stacked = rng.normal(size=(n,) + c["shape"]).astype(np.float32)
    return x, per_rank, scattered, shared, stacked


def axis_case(r, n, out):
    import torch.distributed as dist
    from horovod_tpu_torch.parallel import axis
    world = dist.group.WORLD
    x, per_rank, scattered, shared, stacked = axis_inputs(n)
    local = torch.tensor(x[:, 2 * r:2 * r + 2]).requires_grad_()
    g = axis.all_gather(local, world, dim=1)
    (g * torch.tensor(per_rank[r])).sum().backward()
    out["gathered"], out["gather_grad"] = _np(g), _np(local.grad)
    local.grad = None
    g = axis.all_gather_invariant(local, world, dim=1)
    (g * torch.tensor(shared)).sum().backward()
    out["invariant"], out["invariant_grad"] = _np(g), _np(local.grad)
    mine = torch.tensor(stacked[r]).requires_grad_()
    s = axis.psum_scatter(mine, world, dim=1)
    (s * torch.tensor(scattered[r])).sum().backward()
    out["scattered"], out["scatter_grad"] = _np(s), _np(mine.grad)
    try:
        axis.psum_scatter(torch.zeros(3, 5), world, dim=1)
    except ValueError as e:
        out["indivisible_error"] = np.array(str(e))


CASES = {"reshard": reshard_case, "twod": twod_case, "axis": axis_case}


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
            torch.cuda.set_device(rank)
            kw = dict(device_id=torch.device("cuda", rank),
                      timeout=datetime.timedelta(seconds=300))
        dist.init_process_group("nccl" if card else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=size, **kw)
        out = {}
        if card:
            card_case(rank, size, out)
        elif mode in SHARD_MESHES:
            shard_case(rank, size, out, mode,
                       os.path.join(os.path.dirname(out_dir), "params.npz"))
        else:
            CASES[mode](rank, size, out)
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


# ---------------------------------------------------------------------------
# The jobs, for the tests
# ---------------------------------------------------------------------------

class Jobs:
    """4-rank jobs of this worker, one per mode, started together;
    :meth:`get` waits for one and returns each rank's outputs."""

    def __init__(self, root, modes, timeout=300):
        import torch_port_launch
        self.root, self.procs, self.done = root, {}, {}
        self.timeout = timeout
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
        env.update(OMP_NUM_THREADS="1")
        for mode in modes:
            out = root / mode
            out.mkdir()
            port = torch_port_launch.free_port()
            self.procs[mode] = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, str(r),
                 str(N), str(port), str(out)],
                env=env, stdout=open(out / f"log{r}.txt", "w"),
                stderr=subprocess.STDOUT) for r in range(N)]

    def get(self, mode):
        if mode not in self.done:
            codes = []
            for p in self.procs[mode]:
                try:
                    codes.append(p.wait(timeout=self.timeout))
                except subprocess.TimeoutExpired:
                    self.kill()
                    codes.append("timeout")
            out = self.root / mode
            if codes != [0] * N:
                logs = "\n".join((out / f"log{r}.txt").read_text()[-3000:]
                                 for r in range(N))
                self.done[mode] = AssertionError(
                    f"{mode} job exited {codes}:\n{logs}")
            else:
                self.done[mode] = [dict(np.load(out / f"r{r}.npz"))
                                   for r in range(N)]
        if isinstance(self.done[mode], Exception):
            raise self.done[mode]
        return self.done[mode]

    def kill(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


CARD_MESHES = {"dp2_tp2": dict(dp=2, tp=2), "fsdp2_tp2": dict(fsdp=2, tp=2),
               "tp4": dict(dp=1, tp=4)}


def card_case(r, n, out):
    """The full-width TransformerLM under ``shard_model`` at each of
    ``CARD_MESHES`` against one GPU's steps from the same weights,
    ``execute_group`` moving the full tree Replicated(4) -> ZeroFlat(4)
    and back, and ``TwoDZero`` at (2, 2) with its reshard to (1, 2) at the
    MLP's widths against the oracle."""
    import chip_smoke as cs
    import torch.distributed as dist
    from horovod_tpu_torch import models, parallel, resharding
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import zero
    from horovod_tpu_torch.parallel import sharding
    ref = cs.lm_reference(models)
    out["ref"] = {k: ref[k] for k in ("losses", "ms", "peak_gib")}
    # the reference parameters wait on the host: the sharded runs' peak
    # memory is their own
    ref_params = {k: v.cpu() for k, v in ref.pop("params").items()}
    torch.cuda.empty_cache()
    for label, kw in CARD_MESHES.items():
        mesh = parallel.make_mesh(parallel.MeshConfig(**kw))
        got = cs.lm_sharded(fa, models, sharding, mesh)
        fro = {k: cs._rel_fro([got["params"][k].cpu()], [v])
               for k, v in ref_params.items()}
        # Biases start at zero: after 3 steps each is ~3 lr of Adam steps
        # whose signs follow gradients that are rounding noise where the
        # exact gradient vanishes (the key bias: softmax ignores it), so
        # their own relative error is no measure; they count in the whole
        # tree's.
        weights = [k for k in fro if not k.endswith(".bias")]
        worst = max(weights, key=fro.get)
        worst_bias = max((k for k in fro if k.endswith(".bias")),
                         key=fro.get)
        out[label] = {
            "losses": got["losses"], "launches": got["launches"],
            "ms": got["ms"], "peak_gib": got["peak_gib"],
            "local_param_bytes": got["local_param_bytes"],
            "loss_rel": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "tree_fro": cs._rel_fro(
                [got["params"][k].cpu() for k in ref_params],
                list(ref_params.values())),
            "worst_fro": fro[worst], "worst_name": worst,
            "worst_bias_fro": fro[worst_bias],
            "worst_bias_name": worst_bias}
        print(f"[card {r}] {label}: {out[label]}", flush=True)
        del got
        torch.cuda.empty_cache()
    dist.barrier()
    out["group"] = cs.group_round_trip(
        resharding, zero, [v.cuda() for v in ref_params.values()],
        dist.group.WORLD, n, src_axis="src")
    del ref, ref_params
    torch.cuda.empty_cache()
    glob, batch = cs.twod_inputs(torch.device("cuda", r))
    t = {}
    twod_run(r, glob, batch, functools.partial(torch.optim.Adam,
                                               lr=TWOD_LR), t)
    everyone = [None] * n
    dist.all_gather_object(everyone, t)
    tw = {"losses": [float(t["loss0"]), float(t["loss1"])],
          "oracle_equal": all(np.array_equal(t[k], t["oracle_" + k])
                              for k in t if "oracle_" + k in t
                              and not k.endswith("_after")
                              and not k.startswith("p2_"))}
    if r < 2:
        tw.update(
            moments_moved=twod_moved(everyone, r),
            after_equal=all(np.array_equal(t[k], t["oracle_" + k])
                            for k in t if k.startswith("p2_")
                            or k == "loss_after"),
            loss_after=float(t["loss_after"]))
    out["twod"] = tw


if __name__ == "__main__":
    main()

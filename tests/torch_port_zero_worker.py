"""One rank of a ZeRO-1 launcher job of the port on the CPU, for
tests/test_torch_port_zero.py (the plane comes from the environment:
tcp-native by default, the delegated plane over gloo with
``HVDTPU_CPU_OPERATIONS=nccl``; over NCCL with ``PORT_TEST_DEVICE=cuda``,
rank r on ``cuda:r``, for tests/test_torch_port_nccl.py).

    python torch_port_zero_worker.py MODE RANK SIZE RDV_DIR MASTER_PORT OUT

MODE ``zero``: the JAX package's test model (leaves of 37, 5 and 13x5
elements, ``tests/test_zero.py``'s ``_params`` and ``_batch``, rank r on
rows 2r, 2r+1) trained 3 steps replicated and under ZeRO with SGD-momentum
and Adam, Sum and Average, one bucket and several; the sharded update's
state bytes; int8/fp8 legs with error feedback (the legs alone on fixed
inputs, and 2 train steps) and fp16 legs; the elastic version bump. MODE
``mismatch``: rank 0 plans with ``HVDTPU_ZERO_BUCKET_BYTES=256``, the
others with 400. MODE ``memory`` (CUDA only): peak allocated memory of a
replicated and a ZeRO run of the full-width, full-depth TransformerLM. Each rank writes
``OUT/r<rank>.json`` (its checks) and ``OUT/r<rank>.npz`` (parameters,
moments, leg outputs) for the JAX package's run of the same inputs.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_port_launch  # noqa: E402

DEV = torch.device(os.environ.get("PORT_TEST_DEVICE", "cpu"))
STEPS = 3
CODEC_STEPS = 2
LEG_N = 700            # elements of the fixed-input leg check
# Rank 0 plans 2 buckets of 66 and 42 elements at 2 ranks, the others 70
# and 38: one chunk of the same width either way, which only the plan
# probe tells apart.
MISMATCH_BUDGET = {0: "256"}   # the other ranks: 400


def jax_params(seed=0):
    """``tests/test_zero.py``'s ``_params`` as numpy, in JAX's leaf order
    (sorted keys: a, b, w)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(37).astype(np.float32)
    w = rng.randn(13, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    return {"a": a, "b": b, "w": w}


def jax_batch(n, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(2 * n, 13).astype(np.float32),
            rng.randn(2 * n, 5).astype(np.float32))


def leg_inputs(rank, step, n):
    """This rank's padded gradient bucket and update shard of the leg
    check at ``step`` (the JAX side builds the same from the same seed)."""
    from horovod_tpu_torch.compression.codecs import padded_len
    padded = padded_len(LEG_N, n, 256)
    rng = np.random.RandomState(1000 * rank + step)
    g = np.zeros(padded, np.float32)
    g[:LEG_N] = rng.randn(LEG_N) * np.repeat(
        rng.uniform(0.01, 3.0, -(-LEG_N // 50)), 50)[:LEG_N]
    u = (rng.randn(padded // n) * 1e-2).astype(np.float32)
    return g, u


def make_params():
    return [torch.tensor(v, device=DEV, requires_grad=True)
            for v in jax_params().values()]


def loss_fn(params, batch):
    a, b, w = params
    x, y = batch
    return ((x @ w + b - y) ** 2).mean() + (a ** 2).mean()


def train(hvd, train_mod, rank, size, make_opt, steps=STEPS, **kw):
    """``steps`` steps from the JAX package's parameters on this rank's two
    rows; returns (losses, params as numpy, the DistributedOptimizer)."""
    x, y = jax_batch(size)
    batch = (torch.tensor(x[2 * rank:2 * rank + 2], device=DEV),
             torch.tensor(y[2 * rank:2 * rank + 2], device=DEV))
    params = make_params()
    opt = train_mod.DistributedOptimizer(make_opt(params), **kw)
    step = train_mod.make_train_step(loss_fn, opt)
    losses = [step(params, batch).item() for _ in range(steps)]
    return losses, [p.detach().cpu().numpy() for p in params], opt


def sgd(params):
    return torch.optim.SGD(params, lr=0.1, momentum=0.9)


def adam(params):
    return torch.optim.Adam(params, lr=1e-2)


def zero_checks(hvd, rank, size, out_dir):
    from horovod_tpu_torch import train as train_mod
    from horovod_tpu_torch.ops import zero as zero_ops
    out, arrays = {}, {}
    # -- bit-identical to the replicated update, or within 1e-6 ----------
    diffs = {}
    for oname, make_opt in (("sgd", sgd), ("adam", adam)):
        for op_name in ("Average", "Sum"):
            op = getattr(hvd, op_name)
            for budget in (None, "256"):
                if budget:
                    os.environ["HVDTPU_ZERO_BUCKET_BYTES"] = budget
                try:
                    lr, pr, _ = train(hvd, train_mod, rank, size, make_opt,
                                      op=op)
                    lz, pz, zopt = train(hvd, train_mod, rank, size,
                                         make_opt, op=op, zero=True)
                finally:
                    os.environ.pop("HVDTPU_ZERO_BUCKET_BYTES", None)
                key = f"{oname}.{op_name}.{budget or 'default'}"
                diffs[key] = {
                    "equal": lr == lz and all(
                        np.array_equal(a, b) for a, b in zip(pr, pz)),
                    "close": all(np.allclose(b, a, rtol=1e-6, atol=1e-6)
                                 for a, b in zip(pr, pz)),
                    "max_abs": max(float(np.max(np.abs(a - b)))
                                   for a, b in zip(pr, pz)),
                    "loss_rel": max(abs(a - b) / abs(a)
                                    for a, b in zip(lr, lz)),
                    "buckets": len(zopt._zero_rt.plan.buckets)}
                if budget is None and op_name == "Average":
                    for i, p in enumerate(pz):
                        arrays[f"{oname}.p{i}"] = p
                    arrays[f"{oname}.losses"] = np.array(lz)
                    per_leaf, scalars, windows = zero_ops.unshard_moments(
                        zopt._zero_rt)
                    for slot, leaves in per_leaf.items():
                        for i, v in enumerate(leaves):
                            if v is not None:
                                arrays[f"{oname}.{slot}.{i}"] = v
                    out[f"{oname}.windows"] = windows
                    out[f"{oname}.state_bytes"] = \
                        zopt._zero_rt.state_bytes()
                    out[f"{oname}.plan"] = zopt._zero_rt.plan.signature()
                    out[f"{oname}.replicated_state_bytes"] = sum(
                        v.numel() * v.element_size()
                        for st in train(hvd, train_mod, rank, size,
                                        make_opt, steps=1)[2].inner
                        .state.values() for v in st.values()
                        if torch.is_tensor(v))
    out["diffs"] = diffs

    # -- the wire legs alone, on fixed inputs, two steps with EF ---------
    for codec in ("int8", "fp8"):
        p = torch.zeros(LEG_N, device=DEV, requires_grad=True)
        rt = zero_ops.ZeroRuntime(torch.optim.SGD([p], lr=0.1), codec=codec)
        rt.init_state()
        for step in range(CODEC_STEPS):
            g, u = leg_inputs(rank, step, size)
            shard, = rt._reduce_scatter([torch.tensor(g[:LEG_N],
                                                      device=DEV)])
            full, = rt._gather([torch.tensor(u, device=DEV)])
            arrays[f"leg.{codec}.{step}.shard"] = shard.cpu().numpy()
            arrays[f"leg.{codec}.{step}.res_s"] = rt.res_s[0].cpu().numpy()
            arrays[f"leg.{codec}.{step}.full"] = \
                full.reshape(-1)[:LEG_N].cpu().numpy()
            arrays[f"leg.{codec}.{step}.res_g"] = rt.res_g[0].cpu().numpy()

    # -- the codec legs through the train step --------------------------
    for codec in ("none", "int8", "fp8", "fp16"):
        losses, pc, copt = train(hvd, train_mod, rank, size, sgd,
                                 steps=CODEC_STEPS, zero=True,
                                 compression=getattr(hvd.Compression, codec))
        rt = copt._zero_rt
        out[f"{codec}.error_feedback"] = rt.error_feedback
        out[f"{codec}.residuals"] = len(rt.res_s or ())
        arrays[f"{codec}.losses"] = np.array(losses)
        for i, p in enumerate(pc):
            arrays[f"{codec}.p{i}"] = p

    # -- the elastic version bump ----------------------------------------
    from horovod_tpu_torch.torch.elastic import TorchState
    _, _, zopt = train(hvd, train_mod, rank, size, adam, steps=1, zero=True)
    state = TorchState(optimizer=zopt)
    os.environ["HVDTPU_ELASTIC_VERSION"] = "7"
    try:
        for what, call in (("step", zopt.step), ("sync", state.sync)):
            try:
                call()
                out[f"bump.{what}"] = "no error"
            except RuntimeError as e:
                out[f"bump.{what}"] = str(e)
    finally:
        os.environ.pop("HVDTPU_ELASTIC_VERSION", None)
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **arrays)
    return out


def mismatch_checks(hvd, rank, size):
    from horovod_tpu_torch import train as train_mod
    os.environ["HVDTPU_ZERO_BUCKET_BYTES"] = MISMATCH_BUDGET.get(rank, "400")
    try:
        train(hvd, train_mod, rank, size, sgd, steps=1, zero=True)
        return {"error": "no error"}
    except hvd.HorovodInternalError as e:
        return {"error": str(e)}


def memory_checks(hvd, rank, size):
    """Peak allocated memory of replicated and ZeRO AdamW steps of the
    full-width, full-depth TransformerLM (the flash kernels, batch 8 x 512
    a rank), each in a fresh model; and the two runs' losses."""
    from horovod_tpu_torch import models, train as train_mod
    cfg = models.TransformerConfig(vocab_size=30522, hidden=1024, layers=24,
                                   heads=16, max_len=512, causal=True,
                                   use_rope=True, attention_impl="flash")
    gen = torch.Generator(device=DEV).manual_seed(rank)
    x = torch.randint(0, cfg.vocab_size, (8, cfg.max_len), device=DEV,
                      generator=gen)

    def lm_loss(m, batch):
        logits = m(batch)
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), batch.reshape(-1))

    out = {}
    for zero in (False, True):
        key = "zero" if zero else "replicated"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(DEV)
        model = models.TransformerLM(cfg, device=DEV,
                                     generator=torch.Generator(
                                         device=DEV).manual_seed(0))
        opt = train_mod.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4), zero=zero)
        step = train_mod.make_train_step(lm_loss, opt)
        out[f"{key}.losses"] = [step(model, x).item() for _ in range(3)]
        torch.cuda.synchronize(DEV)
        out[f"{key}.peak"] = torch.cuda.max_memory_allocated(DEV)
        out[f"{key}.state_bytes"] = (
            opt._zero_rt.state_bytes() if zero else sum(
                v.numel() * v.element_size()
                for st in opt.inner.state.values() for v in st.values()
                if torch.is_tensor(v)))
        del model, opt, step
    return out


def main():
    mode, rank, size, rdv, port, out_dir = sys.argv[1:7]
    rank, size = int(rank), int(size)
    from horovod_tpu_torch import native
    peers = torch_port_launch.peers(rdv, rank, size,
                                    native.reserve_listen_port)
    os.environ.update(torch_port_launch.launcher_env(rank, size, peers,
                                                     int(port)))
    import horovod_tpu_torch as hvd
    global DEV
    if DEV.type == "cuda":
        DEV = torch.device("cuda", rank)
        torch.cuda.set_device(DEV)
    hvd.init(device="cpu" if DEV.type == "cpu" else None)
    try:
        if mode == "zero":
            checks = zero_checks(hvd, rank, size, out_dir)
        elif mode == "mismatch":
            checks = mismatch_checks(hvd, rank, size)
        else:
            checks = memory_checks(hvd, rank, size)
    finally:
        hvd.shutdown()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(checks, f)


if __name__ == "__main__":
    main()

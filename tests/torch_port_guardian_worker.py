"""One rank of a launcher job of the port for tests/test_torch_port_guardian.py,
tests/test_torch_port_checkpoint.py and tests/test_torch_port_guardian_cuda.py
(run as ``python -m horovod_tpu_torch.runner.launch -np N python
torch_port_guardian_worker.py MODE OUT``; the launcher's KV store is the
guardian's board).

MODE ``codec``: per-call wire codecs on the delegated plane with
``HVDTPU_COMPRESSION`` unset: an eager int8 allreduce over two steps under
one name, ``train.DistributedOptimizer(compression=int8)``'s reduced
gradients, and three allreduces with different stamps (int8, fp8, none)
submitted together, so that the core fuses them into one response. MODE
``mismatch``: rank 1 submits a named allreduce in another shape. MODE
``silent``: rank 0 submits a name the other ranks never do, and times its
failure. MODE ``stall_elastic``: the same under ``hvd.elastic.run``, in
the first attempt only. MODE ``zero_save``: ZeRO-1 SGD with momentum, 3
steps, a checkpoint, 2 more steps. MODE ``zero_restore``: the checkpoint
restored at this world size, 2 steps. MODE ``lm`` (CUDA): full-width
TransformerLM steps, AdamW, optionally ZeRO, a checkpoint saved or
restored. MODE ``frozen`` (CUDA): the last rank stops itself with SIGSTOP
in its cycle thread, before it issues its part of a response the others
already handed to NCCL. Each rank writes ``OUT/r<rank>.json`` and, where it
has arrays, ``OUT/r<rank>.npz``.
"""

import json
import os
import signal
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEVICE = os.environ.get("PORT_TEST_DEVICE", "cpu")
C_N = (1500, 700, 300)   # the optimizer's leaves: one response, ragged
M_N = 1300               # each of the mixed-stamp allreduces
SILENT_TIMEOUT = float(os.environ.get("GUARD_TEST_TIMEOUT", "3"))
ZERO_ROWS = 6            # the global batch of the ZeRO checkpoint jobs
CKPT_STEP = 3
MORE_STEPS = 2


def c_value(rank, step, n, tag):
    """A gradient-like vector whose blocks span four decades."""
    rng = np.random.RandomState(7919 * rank + 101 * step + n + len(tag))
    scale = 10.0 ** rng.randint(-3, 1, size=n // 100 + 1)
    return (rng.randn(n) * np.repeat(scale, 100)[:n]).astype(np.float32)


def write(out, rank, res, arrays=None):
    with open(os.path.join(out, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    if arrays:
        np.savez(os.path.join(out, f"r{rank}.npz"), **arrays)


def dev():
    from horovod_tpu_torch import basics
    return basics.device()


def codec_checks(hvd, rank, out):
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch import basics, train
    res, arrays = {}, {}
    plane = lambda: basics.runtime().coordinator._compression  # noqa: E731
    for step in (0, 1):
        x = torch.from_numpy(c_value(rank, step, C_N[0], "e")).to(dev())
        arrays[f"eager_{step}"] = ht.allreduce(
            x, name="c1.eager", op=hvd.Sum,
            compression=hvd.Compression.int8).cpu().numpy()
        arrays[f"eager_res_{step}"] = \
            plane().residuals.get("c1.eager")[0].cpu().numpy()
    # The optimizer: its grouped "grad" allreduce, Average, int8 stamps.
    params = [torch.nn.Parameter(torch.zeros(n, device=dev())) for n in C_N]
    opt = train.DistributedOptimizer(torch.optim.SGD(params, lr=0.0),
                                     compression=hvd.Compression.int8)
    backend = basics.runtime().backend
    before = (backend.responses, backend.quantized_responses)
    for i, p in enumerate(params):
        p.grad = torch.from_numpy(c_value(rank, 0, C_N[i], "g")).to(dev())
    opt.synchronize()
    res["opt_responses"] = [backend.responses - before[0],
                            backend.quantized_responses - before[1]]
    for i, p in enumerate(params):
        arrays[f"grad_{i}"] = p.grad.cpu().numpy()
        arrays[f"grad_res_{i}"] = \
            plane().residuals.get(f"grad.{i}")[0].cpu().numpy()
    # Three stamps in one response.
    hvd.barrier()
    before = (backend.responses, backend.quantized_responses)
    handles = [ht.allreduce_async(
        torch.from_numpy(c_value(rank, 0, M_N, tag)).to(dev()),
        name=f"mix.{tag}", op=hvd.Sum,
        compression=getattr(hvd.Compression, tag))
        for tag in ("int8", "fp8", "none")]
    for tag, h in zip(("int8", "fp8", "none"), handles):
        arrays[f"mix_{tag}"] = hvd.synchronize(h).cpu().numpy()
    res["mix_responses"] = [backend.responses - before[0],
                            backend.quantized_responses - before[1]]
    res["backend"] = backend.name
    write(out, rank, res, arrays)


def mismatch_checks(hvd, rank, out):
    from horovod_tpu_torch import basics
    res = {"guard_on": basics.runtime().coordinator._guardian is not None}
    shape = (5,) if rank == 1 else (4,)
    try:
        hvd.allreduce(torch.ones(shape, device=dev()), name="mm",
                      op=hvd.Sum)
        res["error"] = None
    except Exception as e:  # noqa: BLE001 - recorded for the test
        res["error"] = type(e).__name__
        res["message"] = str(e)
        res["divergences"] = [list(map(str, d))
                              for d in getattr(e, "divergences", [])]
    post = hvd.allreduce(torch.ones(4, device=dev()), name="post",
                         op=hvd.Sum)
    res["post"] = post.cpu().tolist()
    write(out, rank, res)


def silent_checks(hvd, rank, out):
    res = {}
    warm = hvd.allreduce(torch.ones(4, device=dev()), name="warm",
                         op=hvd.Sum)
    res["warm"] = warm.cpu().tolist()
    sync = os.path.join(out, "lonely.done")
    if rank == 0:
        t0 = time.monotonic()
        try:
            hvd.allreduce(torch.ones(8, device=dev()), name="lonely")
            res["error"] = None
        except Exception as e:  # noqa: BLE001 - recorded for the test
            res["error"] = type(e).__name__
            res["message"] = str(e)
        res["elapsed"] = time.monotonic() - t0
        open(sync, "w").close()
    else:
        deadline = time.monotonic() + 120
        while not os.path.exists(sync):
            assert time.monotonic() < deadline, "no signal from rank 0"
            time.sleep(0.05)
    post = hvd.allreduce(torch.ones(4, device=dev()), name="post",
                         op=hvd.Sum)
    res["post"] = post.cpu().tolist()
    write(out, rank, res)


def stall_elastic(hvd, out):
    """Rank 0 submits a name no other rank does, in the first attempt; the
    others commit (checking for membership changes) until rank 0 is done
    with it. Attempts and errors are counted in files, so that a respawned
    process (exit-restart mode) continues the count."""
    import horovod_tpu_torch.torch as ht
    wid = os.environ.get("HVDTPU_WORKER_ID", "static:0").replace(":", "_")
    log = os.path.join(out, f"attempts.{wid}")
    sync = os.path.join(out, "lonely.done")

    def attempts():
        with open(log) as f:
            return [line.split() for line in f.read().splitlines()]

    @ht.elastic.run
    def train(state):
        with open(log, "a") as f:
            f.write("attempt\n")
        first = len([a for a in attempts() if a[0] == "attempt"]) == 1
        out_ = hvd.allreduce(torch.ones(4, device=dev()), op=hvd.Sum,
                             name="warm")
        state.total += float(out_[0])
        state.commit()
        if first:
            if hvd.rank() == 0:
                try:
                    hvd.allreduce(torch.ones(8, device=dev()),
                                  name="lonely")
                except Exception as e:
                    with open(log, "a") as f:
                        f.write(f"error {type(e).__name__}\n")
                    with open(sync, "w") as f:
                        f.write(type(e).__name__)
                    raise
            else:
                # Until rank 0's error: on a fatal one return, else commit
                # until its reset bumps the membership version (the commit
                # raises HostsUpdatedInterrupt).
                deadline = time.monotonic() + 120
                while True:
                    assert time.monotonic() < deadline, "no signal"
                    if os.path.exists(sync):
                        with open(sync) as f:
                            if f.read() == "StalledTensorError":
                                return None
                    time.sleep(0.2)
                    state.commit()
        out_ = hvd.allreduce(torch.ones(4, device=dev()), op=hvd.Sum,
                             name="done")
        return float(out_[0])

    hvd.init(device="cpu" if DEVICE == "cpu" else None)
    state = ht.elastic.ObjectState(total=0.0)
    res = {"worker": wid}
    try:
        res["result"] = train(state)
        res["final_error"] = None
    except Exception as e:  # noqa: BLE001 - recorded for the test
        res["final_error"] = type(e).__name__
        res["final_message"] = str(e)
    lines = attempts()
    res["attempts"] = len([a for a in lines if a[0] == "attempt"])
    res["errors"] = [a[1] for a in lines if a[0] == "error"]
    res["rank"] = hvd.rank()
    hvd.shutdown()
    with open(os.path.join(out, f"w{wid}.json"), "w") as f:
        json.dump(res, f)


# -- ZeRO-1 through a checkpoint ----------------------------------------------

def zero_batch():
    from torch_port_zero_worker import jax_batch
    x, y = jax_batch(ZERO_ROWS // 2)
    return x, y


def zero_train(hvd, steps, dist_opt, params):
    from horovod_tpu_torch import train
    from torch_port_zero_worker import loss_fn
    n, r = hvd.size(), hvd.rank()
    x, y = zero_batch()
    per = ZERO_ROWS // n
    batch = (torch.tensor(x[r * per:(r + 1) * per], device=dev()),
             torch.tensor(y[r * per:(r + 1) * per], device=dev()))
    step = train.make_train_step(loss_fn, dist_opt)
    return [step(params, batch).item() for _ in range(steps)]


def zero_opt(params):
    from horovod_tpu_torch import train
    return train.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1, momentum=0.9), zero=True)


def zero_save(hvd, rank, out):
    from horovod_tpu_torch import checkpoint
    from torch_port_zero_worker import make_params
    params = make_params()
    opt = zero_opt(params)
    losses = zero_train(hvd, CKPT_STEP, opt, params)
    full = opt.state_dict()
    checkpoint.save_step(os.path.join(out, "ckpt"), CKPT_STEP,
                         {"params": [p.detach() for p in params],
                          "opt": full, "losses": losses})
    arrays = {}
    if rank == 0:
        for slot, leaves in full["zero"]["slots"].items():
            for i, v in enumerate(leaves):
                arrays[f"{slot}.{i}"] = v
    losses += zero_train(hvd, MORE_STEPS, opt, params)
    for i, p in enumerate(params):
        arrays[f"p{i}"] = p.detach().cpu().numpy()
    write(out, rank, {"losses": losses,
                      "signature": opt._zero_rt.plan.signature()}, arrays)


def zero_restore(hvd, rank, out, ckpt_dir):
    from horovod_tpu_torch import checkpoint, functions
    from torch_port_zero_worker import make_params
    # The state crosses in several broadcasts, as a full-width one does.
    functions.OBJECT_CHUNK_BYTES = 1000
    step, state = checkpoint.restore_latest(ckpt_dir)
    params = make_params()
    with torch.no_grad():
        for p, v in zip(params, state["params"]):
            p.copy_(torch.from_numpy(v))
    opt = zero_opt(params)
    opt.load_state_dict(state["opt"])
    losses = zero_train(hvd, MORE_STEPS, opt, params)
    write(out, rank, {"step": step, "losses": losses,
                      "saved_losses": list(state["losses"])},
          {f"p{i}": p.detach().cpu().numpy() for i, p in enumerate(params)})


# -- the card: the full-width TransformerLM -----------------------------------

def lm_setup(global_batch=8):
    from horovod_tpu_torch import models
    cfg = models.TransformerConfig(vocab_size=30522, hidden=1024, layers=24,
                                   heads=16, max_len=512, causal=True,
                                   use_rope=True, attention_impl="flash")
    d = dev()
    x = torch.randint(0, cfg.vocab_size, (global_batch, cfg.max_len),
                      device=d, generator=torch.Generator(
                          device=d).manual_seed(1234))
    n, r = _size_rank()
    per = global_batch // n
    return cfg, x[r * per:(r + 1) * per]


def _size_rank():
    from horovod_tpu_torch import basics
    return basics.size(), basics.rank()


def lm_loss(m, batch):
    logits = m(batch)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), batch.reshape(-1))


def lm_checks(hvd, rank, out):
    """``LM_STEPS`` AdamW steps (SGD with momentum under ``LM_OPT=sgd``)
    of the full-width TransformerLM on this rank's share of one global
    batch of 8; ``LM_ZERO=1`` shards the state;
    ``LM_SAVE_AT=k`` saves ``{params, opt}`` after step k into
    ``LM_CKPT``; ``LM_RESTORE=1`` starts from ``LM_CKPT``'s newest step.
    Records the losses, the step times and the final parameters' digest
    (rank 0 writes the parameters)."""
    from horovod_tpu_torch import checkpoint, models, train
    steps = int(os.environ.get("LM_STEPS", "5"))
    zero = os.environ.get("LM_ZERO") == "1"
    save_at = int(os.environ.get("LM_SAVE_AT", "0"))
    ckpt_dir = os.environ.get("LM_CKPT", os.path.join(out, "ckpt"))
    cfg, x = lm_setup()
    model = models.TransformerLM(cfg, device=dev(), generator=torch.Generator(
        device=dev()).manual_seed(0))
    if os.environ.get("LM_OPT") == "sgd":
        inner = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    else:
        inner = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                  weight_decay=1e-4)
    opt = train.DistributedOptimizer(inner, zero=zero)
    res = {"losses": [], "ms": []}
    if os.environ.get("LM_RESTORE") == "1":
        t0 = time.perf_counter()
        step0, state = checkpoint.restore_latest(ckpt_dir)
        model.load_state_dict(checkpoint.to_tensors(state["model"]))
        opt.load_state_dict(state["opt"])
        res["restored_step"] = step0
        res["restore_s"] = time.perf_counter() - t0
    step = train.make_train_step(lm_loss, opt)
    for k in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["losses"].append(step(model, x).item())
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        if save_at and k + 1 == save_at:
            t0 = time.perf_counter()
            checkpoint.save_step(ckpt_dir, save_at, {
                "model": model.state_dict(), "opt": opt.state_dict()})
            res["save_s"] = time.perf_counter() - t0
    arrays = {}
    if rank == 0:
        arrays = {k: v.detach().float().cpu().numpy()
                  for k, v in model.state_dict().items()}
    write(out, rank, res, arrays)


def frozen_checks(hvd, rank, out):
    """The last rank freezes itself with SIGSTOP. On the card it does so
    from its cycle thread, before it issues its part of the first response
    of step 3, which the others have already handed to NCCL (the
    full-width TransformerLM); on the CPU from its main thread, after a
    warm-up allreduce, before the next one. The others' watchdog aborts.
    Rank 0 shuts down, writes its results, then kills the frozen rank."""
    from horovod_tpu_torch import basics
    size = hvd.size()
    freeze_file = os.path.join(out, "frozen.json")

    def freeze():
        with open(freeze_file + ".tmp", "w") as f:
            json.dump({"t": time.time(), "pid": os.getpid()}, f)
        os.replace(freeze_file + ".tmp", freeze_file)
        os.kill(os.getpid(), signal.SIGSTOP)

    res = {"losses": []}
    if DEVICE == "cuda":
        from horovod_tpu_torch import models, train
        backend = basics.runtime().backend
        armed = {"on": False}
        if rank == size - 1:
            real = backend._execute

            def execute(d):
                if armed["on"]:
                    freeze()
                return real(d)
            backend._execute = execute
        cfg, x = lm_setup()
        model = models.TransformerLM(cfg, device=dev(),
                                     generator=torch.Generator(
                                         device=dev()).manual_seed(0))
        opt = train.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4))
        step = train.make_train_step(lm_loss, opt)
        for k in range(2):
            res["losses"].append(step(model, x).item())
        hvd.barrier()
        armed["on"] = rank == size - 1

        def work():
            for k in range(3):
                res["losses"].append(step(model, x).item())
    else:
        hvd.allreduce(torch.ones(4), name="warm", op=hvd.Sum)
        hvd.barrier()
        if rank == size - 1:
            freeze()
        while not os.path.exists(freeze_file):
            time.sleep(0.01)

        def work():
            hvd.allreduce(torch.ones(4), name="after", op=hvd.Sum)
    try:
        work()
        res["error"] = None
    except Exception as e:  # noqa: BLE001 - recorded for the test
        res["t_error"] = time.time()
        res["error"] = type(e).__name__
        res["message"] = str(e)[:2000]
    t0 = time.perf_counter()
    hvd.shutdown()
    res["shutdown_s"] = time.perf_counter() - t0
    if rank == 0:
        with open(freeze_file) as f:
            frozen = json.load(f)
        res["freeze_to_error_s"] = res.get("t_error", 0.0) - frozen["t"]
    write(out, rank, res)
    if rank == 0:
        os.kill(frozen["pid"], signal.SIGKILL)


def main():
    mode, out = sys.argv[1], sys.argv[2]
    import horovod_tpu_torch as hvd
    if mode == "stall_elastic":
        stall_elastic(hvd, out)
        return
    hvd.init(device="cpu" if DEVICE == "cpu" else None)
    rank = hvd.rank()
    try:
        if mode == "codec":
            codec_checks(hvd, rank, out)
        elif mode == "mismatch":
            mismatch_checks(hvd, rank, out)
        elif mode == "silent":
            silent_checks(hvd, rank, out)
        elif mode == "zero_save":
            zero_save(hvd, rank, out)
        elif mode == "zero_restore":
            zero_restore(hvd, rank, out, sys.argv[3])
        elif mode == "lm":
            lm_checks(hvd, rank, out)
        elif mode == "frozen":
            frozen_checks(hvd, rank, out)
            return
        else:
            raise ValueError(f"unknown mode {mode}")
    finally:
        if hvd.is_initialized():
            hvd.shutdown()


if __name__ == "__main__":
    main()

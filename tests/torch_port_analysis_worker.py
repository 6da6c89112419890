"""One rank of the analyzer's launcher jobs on the card
(tests/test_torch_port_analysis_cuda.py): ``python -m
horovod_tpu_torch.runner.launch -np N python torch_port_analysis_worker.py
MODE OUT``. Each rank writes ``OUT/r<rank>.json``.

MODE ``calib`` (with ``HVDTPU_TRACE=1``): ``allreduce_async`` of the
full-width flagship TransformerLM's gradient leaves (vocab 30522, hidden
1024, 24 layers, 16 heads: one fp32 tensor per parameter, random from a
seed), ``ANALYSIS_WARMUP`` warm-up steps, then ``ANALYSIS_STEPS`` timed
steps, each ended by waiting for the card; rank 0's result holds
``{"n", "step_s", "leaves", "step_bytes"}`` with ``step_s`` the median
step, the statistic the calibration takes per run.

MODE ``train``: the same model trained, one sequence of 512 tokens per rank,
AdamW, the gradients averaged by one ``allreduce_async`` per parameter
after the backward; the timed steps' median (each ended by waiting for the
card) is the measured step that ``hvd-lint perf`` predicts for
:func:`train_job`.

MODE ``diverge`` (with ``HVDTPU_CONSISTENCY_CHECK=1``): every rank
allreduces ``step0``, ``step1``, ... but rank 1 allgathers ``step3``; each
rank's consistency check refuses the slot before it is dispatched and the
flight recorder leaves its postmortem, which ``hvd-lint explain`` maps to
the collectives of :func:`diverge_job`.

MODE ``skip`` (with ``HVDTPU_COLLECTIVE_TIMEOUT``): every rank allreduces
``skip0``, ``skip1``, ... but rank 1 skips ``skip3``, so rank 0 waits in
``skip3`` while rank 1 waits in ``skip4`` until the stuck-collective
watchdog aborts the job and the flight recorder leaves its postmortem.

``PORT_TEST_DEVICE=cpu`` runs any mode on the CPU; ``ANALYSIS_LAYERS`` and
``ANALYSIS_HIDDEN`` narrow the model there.
"""

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

DEVICE = os.environ.get("PORT_TEST_DEVICE", "cuda")
LAYERS = int(os.environ.get("ANALYSIS_LAYERS", "24"))
HIDDEN = int(os.environ.get("ANALYSIS_HIDDEN", "1024"))
WARMUP = int(os.environ.get("ANALYSIS_WARMUP", "5"))
STEPS = int(os.environ.get("ANALYSIS_STEPS", "30"))
DIVERGE_STEPS = 6


def flagship(device):
    from horovod_tpu_torch import models
    cfg = models.TransformerConfig(
        vocab_size=30522, hidden=HIDDEN, layers=LAYERS, heads=16,
        max_len=512, causal=True, use_rope=True, attention_impl="flash")
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, models.TransformerLM(cfg, device=device, generator=gen), gen


def _wait(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calib_job(hvd, device):
    _, model, _ = flagship(device)
    grads = [p.detach().clone() for p in model.parameters()]
    del model
    step_bytes = sum(g.numel() * g.element_size() for g in grads)

    def one_step():
        handles = [hvd.allreduce_async(g, name=f"grad.{i}", op=hvd.Sum)
                   for i, g in enumerate(grads)]
        for h in handles:
            hvd.synchronize(h)
        _wait(device)

    for _ in range(WARMUP):
        one_step()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        one_step()
        times.append(time.perf_counter() - t0)
    return {"n": hvd.size(), "step_s": statistics.median(times),
            "steps_s": times, "leaves": len(grads),
            "step_bytes": step_bytes}


def train_job(hvd, device):
    cfg, model, gen = flagship(device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = [p for p in model.parameters()]
    opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)
    x = torch.randint(0, cfg.vocab_size, (hvd.size(), cfg.max_len),
                      device=device, generator=gen)[hvd.rank():hvd.rank() + 1]
    losses, times = [], []
    for _ in range(WARMUP + STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        logits = model(x)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), x.reshape(-1))
        loss.backward()
        handles = [hvd.allreduce_async(p.grad, name=f"grad.{i}",
                                       op=hvd.Average)
                   for i, p in enumerate(params)]
        for p, h in zip(params, handles):
            p.grad = hvd.synchronize(h)
        opt.step()
        _wait(device)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return {"n": hvd.size(), "step_s": statistics.median(times[WARMUP:]),
            "steps_s": times, "losses": losses}


def diverge_job(hvd, device):
    x = torch.ones(1024, device=device)
    done = []
    try:
        for epoch in range(DIVERGE_STEPS):
            if hvd.rank() == 1 and epoch == 3:
                hvd.allgather(x, name=f"step{epoch}")
            else:
                hvd.allreduce(x, name=f"step{epoch}", op=hvd.Sum)
            done.append(epoch)
        error = None
    except Exception as exc:  # noqa: BLE001 - the abort is the point
        error = f"{type(exc).__name__}: {exc}"
    return {"done": done, "error": error}


def skip_job(hvd, device):
    x = torch.ones(1024, device=device)
    done = []
    try:
        for epoch in range(DIVERGE_STEPS):
            if hvd.rank() == 1 and epoch == 3:
                continue
            hvd.allreduce(x, name=f"skip{epoch}", op=hvd.Sum)
            done.append(epoch)
        error = None
    except Exception as exc:  # noqa: BLE001 - the abort is the point
        error = f"{type(exc).__name__}: {exc}"
    return {"done": done, "error": error}


def main():
    mode, out = sys.argv[1], sys.argv[2]
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    hvd.init(device="cpu" if DEVICE == "cpu" else None)
    device = hvd.device()
    job = {"calib": calib_job, "train": train_job,
           "diverge": diverge_job, "skip": skip_job}[mode]
    res = job(hvd, device)
    res["device"] = str(device)
    res["backend"] = basics.runtime().backend.name
    if device.type == "cuda":
        res["card"] = torch.cuda.get_device_name(device)
    with open(os.path.join(out, f"r{hvd.rank()}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()


if __name__ == "__main__":
    main()

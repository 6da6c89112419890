"""One rank of the runtime checkers' launcher jobs
(tests/test_torch_port_analysis_runtime.py on the CPU,
tests/test_torch_port_analysis_runtime_cuda.py on the card):
``python -m horovod_tpu_torch.runner.launch -np N python
torch_port_analysis_runtime_worker.py MODE OUT``. Each rank writes
``OUT/r<rank>.json``.

A TransformerLM (``RUNTIME_LAYERS`` layers of width ``RUNTIME_HIDDEN``,
weights from a seed, one 128-token sequence per rank) trains with AdamW,
its gradients averaged by one named ``allreduce_async`` per parameter
(``grad.<i>``) after the backward.

MODE ``train``: ``RUNTIME_STEPS`` steps. The result holds the losses, the
sanitizer's findings and shutdown audit, the order guard's compared
checkpoints (``verified``) and, with ``RUNTIME_TIME_RESPONSES=1`` on the
card, each NCCL response's device time (``chip_smoke.time_nccl_responses``:
CUDA events around it), for the trace-span check.

MODE ``swap``: rank ``RUNTIME_SWAP_RANK`` submits ``grad.1`` before
``grad.0`` from step ``RUNTIME_SWAP_STEP`` on; the job trains until the
order guard's ``SubmissionOrderError`` reaches the training thread (at
most ``RUNTIME_SWAP_DEADLINE`` seconds) and records its text and the
seconds from the first swapped submission.

``PORT_TEST_DEVICE=cpu`` runs on the CPU (gloo under the delegated plane).
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

DEVICE = os.environ.get("PORT_TEST_DEVICE", "cuda")
LAYERS = int(os.environ.get("RUNTIME_LAYERS", "2"))
HIDDEN = int(os.environ.get("RUNTIME_HIDDEN", "64"))
STEPS = int(os.environ.get("RUNTIME_STEPS", "6"))
SWAP_RANK = int(os.environ.get("RUNTIME_SWAP_RANK", "1"))
SWAP_STEP = int(os.environ.get("RUNTIME_SWAP_STEP", "2"))
SWAP_DEADLINE = float(os.environ.get("RUNTIME_SWAP_DEADLINE", "60"))
SEQ = 128


def _model(device):
    from horovod_tpu_torch import models
    cfg = models.TransformerConfig(
        vocab_size=512, hidden=HIDDEN, layers=LAYERS, heads=4,
        max_len=SEQ, causal=True)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, models.TransformerLM(cfg, device=device, generator=gen), gen


def _wait(hvd, handle, coord):
    """The handle's result; raises the order guard's error once it is set
    (a peer that raised never submits the rest of its step)."""
    while not handle.poll():
        if coord._order_error is not None:
            raise coord._order_error
        time.sleep(0.0005)
    return hvd.synchronize(handle)


def run(hvd, mode, device, coord):
    cfg, model, gen = _model(device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = list(model.parameters())
    opt = torch.optim.AdamW(params, lr=1e-3)
    x = torch.randint(0, cfg.vocab_size, (hvd.size(), SEQ), device=device,
                      generator=gen)[hvd.rank():hvd.rank() + 1]
    losses = []
    res = {"error": None, "swap_s": None}
    swapped_at = None
    step = 0
    while True:
        if mode == "train" and step == STEPS:
            break
        if swapped_at is not None and \
                time.monotonic() - swapped_at > SWAP_DEADLINE:
            break
        opt.zero_grad(set_to_none=True)
        logits = model(x)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), x.reshape(-1))
        loss.backward()
        order = list(range(len(params)))
        if mode == "swap" and hvd.rank() == SWAP_RANK and step >= SWAP_STEP:
            order[0], order[1] = 1, 0
            if swapped_at is None:
                swapped_at = time.monotonic()
        elif mode == "swap" and step == SWAP_STEP:
            swapped_at = time.monotonic()
        try:
            handles = {i: hvd.allreduce_async(params[i].grad,
                                              name=f"grad.{i}",
                                              op=hvd.Average)
                       for i in order}
            for i in order:
                params[i].grad = _wait(hvd, handles[i], coord)
        except Exception as exc:  # noqa: BLE001 - the error is the point
            res["error"] = f"{type(exc).__name__}: {exc}"
            res["swap_s"] = (None if swapped_at is None
                             else time.monotonic() - swapped_at)
            break
        opt.step()
        losses.append(loss.item())
        step += 1
    res["losses"] = losses
    res["steps"] = step
    return res


def main():
    mode, out = sys.argv[1], sys.argv[2]
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.analysis import sanitizer
    hvd.init(device="cpu" if DEVICE == "cpu" else None)
    device = hvd.device()
    rt = basics.runtime()
    coord = rt.coordinator
    timed = None
    if os.environ.get("RUNTIME_TIME_RESPONSES") == "1":
        from chip_smoke import time_nccl_responses
        timed = time_nccl_responses(rt.backend)
    verified = []
    guard = coord._order_guard
    if guard is not None:
        check = guard.verify

        def counted(gathered, num_ranks):
            idx = check(gathered, num_ranks)
            verified.append(idx)
            return idx

        guard.verify = counted
    res = run(hvd, mode, device, coord)
    if mode == "train" and guard is not None:
        # Wait for a round after the last step, so that every run is
        # checked against its peers at least once past its start.
        interval = float(os.environ.get("HOROVOD_TPU_ORDER_CHECK_INTERVAL",
                                        "5"))
        deadline = time.monotonic() + 4 * interval + 5
        want = len(verified) + 1
        while len(verified) < want and time.monotonic() < deadline:
            time.sleep(0.05)
    res.update(device=str(device), backend=rt.backend.name,
               rank=hvd.rank(), verified=verified,
               guard=None if guard is None else guard.count,
               sanitize=sanitizer.enabled())
    if timed is not None:
        torch.cuda.synchronize(device)
        res["responses"] = [[keys, start.elapsed_time(end)]
                            for keys, start, end in timed]
    if device.type == "cuda":
        res["card"] = torch.cuda.get_device_name(device)
    path = os.path.join(out, f"r{res['rank']}.json")
    with open(path, "w") as f:   # before a shutdown that may hang
        json.dump(res, f)
    hvd.shutdown()
    res["findings"] = [f.format() for f in sanitizer.findings()]
    res["leaks"] = sanitizer.audit_shutdown()
    res["shutdown"] = True
    with open(path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()

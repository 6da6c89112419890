"""Worker of the trace plane's launcher jobs: ``python -m
horovod_tpu_torch.runner.launch -np N python tests/torch_port_tracing_worker.py
MODE OUT`` with ``HVDTPU_TRACE=1`` and ``HVDTPU_TRACE_DIR`` set.

MODE ``cpu``: 3 steps of three named collectives (two allreduces, one
allgather) on the CPU; rank 0 writes nothing but its shard.

MODE ``card``: the full-width TransformerLM (vocab 30522, hidden 1024,
16 heads, seq 512, flash attention) at ``TRACE_LAYERS`` layers, one row of
the global batch per rank, through the torch binding's
``DistributedOptimizer`` (one named allreduce per gradient, submitted from
the backward's hooks); rank ``STRAGGLER_RANK`` sleeps ``STRAGGLER_MS``
before each backward. After the steps every rank pushes its metrics
snapshot to the launcher's store, and rank 0 reads the launcher's
``/metrics`` and ``/metrics.json``. Each rank writes ``OUT/r<rank>.json``.
"""

import json
import os
import sys
import time
import urllib.request

import torch

STEPS = int(os.environ.get("TRACE_STEPS", "6"))
LAYERS = int(os.environ.get("TRACE_LAYERS", "4"))
STRAGGLER_RANK = int(os.environ.get("STRAGGLER_RANK", "2"))
STRAGGLER_MS = float(os.environ.get("STRAGGLER_MS", "50"))


def cpu_job(hvd):
    for _ in range(3):
        hvd.allreduce(torch.full((8,), float(hvd.rank())), name="grad.a")
        hvd.allreduce(torch.ones(4), name="grad.b")
        hvd.allgather(torch.ones(2), name="gather")


def _launcher_get(path):
    from horovod_tpu_torch.runner import http_server
    from horovod_tpu_torch.utils import envparse
    addr = envparse.get_str(envparse.RENDEZVOUS_ADDR)
    port = envparse.get_int(envparse.RENDEZVOUS_PORT)
    req = urllib.request.Request(f"http://{addr}:{port}{path}")
    req.add_header(http_server.AUTH_HEADER,
                   envparse.get_str(envparse.JOB_TOKEN))
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read().decode()


def card_job(hvd, rank, out):
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import basics, models, telemetry
    from horovod_tpu_torch.runner import rendezvous
    device = basics.device()
    cfg = models.TransformerConfig(
        vocab_size=30522, hidden=1024, layers=LAYERS, heads=16, max_len=512,
        causal=True, use_rope=True, attention_impl="flash")
    gen = torch.Generator(device=device).manual_seed(0)
    model = models.TransformerLM(cfg, device=device, generator=gen)
    x = torch.randint(0, cfg.vocab_size, (hvd.size(), cfg.max_len),
                      device=device, generator=gen)[rank:rank + 1]
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    res = {"losses": [], "ms": []}
    for _ in range(STEPS):
        t0 = time.perf_counter()
        opt.zero_grad()
        logits = model(x)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), x.reshape(-1))
        if rank == STRAGGLER_RANK:
            time.sleep(STRAGGLER_MS / 1e3)
        loss.backward()
        opt.step()
        res["losses"].append(loss.item())
        res["ms"].append((time.perf_counter() - t0) * 1e3)
    hvd.barrier()
    addr, port, token = rendezvous.rendezvous_config()
    telemetry.push_snapshot(addr, port, token, rank)
    hvd.barrier()
    if rank == 0:
        res["metrics"] = _launcher_get("/metrics")
        res["metrics_json"] = json.loads(_launcher_get("/metrics.json"))
    res["snapshot_families"] = sorted(hvd.metrics_snapshot()["families"])
    with open(os.path.join(out, f"r{rank}.json"), "w") as f:
        json.dump(res, f)


def main():
    mode, out = sys.argv[1], sys.argv[2]
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu" if mode == "cpu" else None)
    try:
        if mode == "cpu":
            cpu_job(hvd)
        elif mode == "card":
            card_job(hvd, hvd.rank(), out)
        else:
            raise ValueError(f"unknown mode {mode}")
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()

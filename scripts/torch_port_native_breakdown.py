"""Where a step's time goes on the port's native control plane, on one GPU.

    python3 scripts/torch_port_native_breakdown.py single|native|nofr

Trains the full-width TransformerLM (chip_smoke.py's configuration) for 8
steps in a hand-written loop, timing on the host its forward and backward,
``DistributedOptimizer.synchronize`` (the wait for the cycle thread to
issue the reduction), the inner update, and the loss allreduce; then 8
steps of ResNet-50 through the torch binding's gradient hooks. ``single``
runs a single-process job; ``native`` a one-rank launcher job (the native
core negotiates, NCCL executes) and also prints the cycle thread's time by
call (wall time, GIL waits included) for the last step; ``nofr`` is
``native`` with NCCL's flight recorder off. Medians of steps 3..8.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from horovod_tpu_torch import native as hnative  # noqa: E402

variant = sys.argv[1]
if variant != "single":
    os.environ.update(HVDTPU_RANK="0", HVDTPU_SIZE="1",
                      MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(29000 + os.getpid() % 1000))
    os.environ["HVDTPU_PEERS"] = f"127.0.0.1:{hnative.reserve_listen_port()}"
if variant == "nofr":
    os.environ["TORCH_NCCL_TRACE_BUFFER_SIZE"] = "0"

import horovod_tpu_torch as hvd  # noqa: E402
import horovod_tpu_torch.torch as ht  # noqa: E402
from horovod_tpu_torch import basics, models, train  # noqa: E402

hvd.init()
rt = basics.runtime()
acc = {}


def timed(obj, name, key):
    fn = getattr(obj, name)

    def wrap(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
            acc[key + "#"] = acc.get(key + "#", 0) + 1
    setattr(obj, name, wrap)


if variant != "single":
    be = rt.backend
    import torch.distributed as dist
    for obj, name, key in (
            (be, "submit_entry", "submit_entry"),
            (be, "_enqueue_entry", "enqueue_entry"),
            (be.core, "enqueue", "core.enqueue"),
            (be.core, "run_cycle", "core.run_cycle"),
            (be, "_drain_delegated", "drain"),
            (be, "_execute", "execute"),
            (be, "_on_stream", "on_stream"),
            (dist, "all_reduce", "dist.all_reduce"),
            (be.core, "delegated_complete", "delegated_complete"),
            (be, "_sweep_completions", "sweep"),
            (be, "_sweep_one", "sweep_one"),
            (be.core, "poll", "core.poll"),
            (rt.coordinator, "submit", "coord.submit")):
        timed(obj, name, key)


def report(label, rows, names):
    med = [statistics.median(r[i] for r in rows[2:])
           for i in range(len(names))]
    print(f"BREAKDOWN {variant} {label}: " + "  ".join(
        f"{n} {m:.1f}" for n, m in zip(names, med)) + " ms", flush=True)
    if variant != "single":
        print(f"BREAKDOWN {variant} {label} cycle thread, last step: "
              + json.dumps({k: round(v * 1e3, 2) if not k.endswith("#")
                            else v for k, v in rows[-1][-1].items()}),
              flush=True)


cfg, model, step, x, y = cs.transformer_setup(hvd, models)
dopt = next(c.cell_contents for c in step.__closure__
            if isinstance(c.cell_contents, train.DistributedOptimizer))
rows = []
for _ in range(8):
    torch.cuda.synchronize()
    acc.clear()
    t0 = time.perf_counter()
    logits = model(x)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))
    loss.backward()
    t1 = time.perf_counter()
    dopt.synchronize()
    t2 = time.perf_counter()
    dopt.inner.step()
    t3 = time.perf_counter()
    dopt.zero_grad()
    mean = hvd.allreduce(loss.detach(), name="loss")
    t4 = time.perf_counter()
    mean.item()
    t5 = time.perf_counter()
    rows.append([(b - a) * 1e3 for a, b in
                 ((t0, t1), (t1, t2), (t2, t3), (t3, t4), (t4, t5),
                  (t0, t5))] + [dict(acc)])
report("transformer", rows, ["fwd+bwd host", "sync", "opt", "zero+loss",
                             "item-wait", "total"])

rmodel, rstep, rx, ry, _ = cs.resnet_setup(ht, models, train)
ropt = next(c.cell_contents for c in rstep.__closure__
            if getattr(c.cell_contents, "_hvd_wrapped", False))
rows = []
for _ in range(8):
    torch.cuda.synchronize()
    acc.clear()
    t0 = time.perf_counter()
    loss = F.cross_entropy(rmodel(rx), ry)
    loss.backward()
    t1 = time.perf_counter()
    ropt.step()
    t2 = time.perf_counter()
    ropt.zero_grad()
    t3 = time.perf_counter()
    loss.item()
    t4 = time.perf_counter()
    rows.append([(b - a) * 1e3 for a, b in
                 ((t0, t1), (t1, t2), (t2, t3), (t3, t4), (t0, t4))]
                + [dict(acc)])
report("resnet", rows, ["fwd+bwd host", "step(sync+opt)", "zero",
                        "item-wait", "total"])
hvd.shutdown()

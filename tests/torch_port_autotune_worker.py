"""One rank of the port's ``--autotune`` launcher jobs, for
tests/test_torch_port_autotune.py (CPU, the native TCP plane) and
tests/test_torch_port_autotune_cuda.py (one GPU per rank, NCCL).

    python torch_port_autotune_worker.py OUT

Steps of three named allreduces (a 1 MiB, a 64 KiB and a 4 KiB tensor)
until this rank's ``ParameterManager`` converged on every rank (an
allreduce of the ranks' flags decides, so that all ranks stop at the same
step), then writes ``OUT.r<rank>.json``: the tuner's ``applied`` sequence,
its winner, whether it warm-started, and the sum of the last step (the
reduction must stay exact whatever the knobs). The device comes from
``PORT_TEST_DEVICE`` (``cpu`` here; ``cuda`` puts rank r on its card).
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import basics  # noqa: E402

DEVICE = os.environ.get("PORT_TEST_DEVICE", "cpu")
MAX_STEPS = int(os.environ.get("AUTOTUNE_TEST_MAX_STEPS", "400"))


def main(out):
    hvd.init(device=None if DEVICE == "cuda" else DEVICE)
    rt = basics.runtime()
    tuner = rt.autotuner
    assert tuner is not None, "HVDTPU_AUTOTUNE did not build the tuner"
    dev = rt.device
    sizes = (1 << 18, 1 << 14, 1 << 10)
    steps = 0
    last = None
    while steps < MAX_STEPS:
        steps += 1
        outs = [hvd.allreduce(torch.full((n,), float(hvd.rank() + 1),
                                         device=dev),
                              op=hvd.Sum, name=f"g{i}")
                for i, n in enumerate(sizes)]
        last = [float(o[0]) for o in outs]
        flag = torch.tensor([0.0 if tuner.enabled else 1.0], device=dev)
        if float(hvd.allreduce(flag, op=hvd.Min, name="done")[0]) == 1.0:
            break
    res = {"rank": hvd.rank(), "size": hvd.size(), "steps": steps,
           "applied": [list(a) for a in tuner.applied],
           "best": list(tuner.best) if tuner.best is not None else None,
           "history": len(tuner._history), "enabled": tuner.enabled,
           "fusion_threshold": rt.coordinator.fusion_threshold,
           "cycle_time_ms": rt.coordinator.cycle_time_s * 1e3,
           "last": last, "backend": rt.backend.name}
    with open(f"{out}.r{hvd.rank()}.json", "w") as f:
        json.dump(res, f)
    hvd.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])

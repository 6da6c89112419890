"""Run phases of ``chip_smoke.py`` alone on one GPU, without the rest of
the script:

    python3 scripts/torch_port_smoke_phases.py [autotune] [chaos] [ha] [serving]

Builds the kernels and the native core, then runs the phases named (all
four by default). ``[autotune]``, ``[chaos]`` and ``[ha]`` first train the
flagship TransformerLM 5 steps on the single-process plane (the reference
losses the phases hold theirs to; ``chip_smoke.py`` passes ``[native]``'s),
and ``[ha]`` needs ``[chaos]``'s uninjected control and runs it too.
``[serving]`` needs neither. Prints ``[time] <phase> <s>`` after each, the
card's name and power limit and ``PHASES OK`` with the seconds taken.
"""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASES = ("autotune", "chaos", "ha", "serving")


def main(which):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _build, models
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA device")
    unknown = set(which) - set(PHASES)
    if unknown:
        cs.fail(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    t0 = time.perf_counter()
    _build.build_core()
    _build.build(["flash_attention"])
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s; "
           f"{torch.cuda.get_device_name(0)}")
    hvd.init()
    ref = {}
    if {"autotune", "chaos", "ha"} & set(which):
        _, model, step, x, y = cs.transformer_setup(hvd, models)
        losses = [step(model, (x, y)).item() for _ in range(cs.TRAIN_STEPS)]
        cs.log(f"[train] losses {losses}")
        del model, step
        torch.cuda.empty_cache()
        ref = {"transformer_losses": losses}
    t = time.perf_counter()
    if "autotune" in which:
        cs.log(f"[launches] [autotune] {cs.autotune_phase(ref)}")
        t = cs.phase_done("autotune", t)
    if "chaos" in which or "ha" in which:
        launches, control = cs.chaos_phase(ref)
        cs.log(f"[launches] [chaos] {launches}")
        t = cs.phase_done("chaos", t)
    if "ha" in which:
        cs.log(f"[launches] [ha] {cs.ha_phase(control)}")
        t = cs.phase_done("ha", t)
    if "serving" in which:
        cs.serving_phase(models)
        t = cs.phase_done("serving", t)
    hvd.shutdown()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cs.log(f"{smi}\nPHASES OK {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or list(PHASES))

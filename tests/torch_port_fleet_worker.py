"""Fleet-matrix training worker of the port (the counterpart of
tests/fleet_worker.py), started by tests/test_torch_port_fleet_matrix.py
through the port's elastic driver.

Runs a fixed number of optimizer steps whose loss trajectory is
**cohort-size invariant by construction**: every rank computes the same
deterministic pseudo-gradient from ``(step, params)`` (the JAX worker's
numpy function), the cohort averages it (``hvd.allreduce`` with
``op=Average`` — the identity on identical inputs at sizes 1 and 2), and
the update is applied to committed elastic state. Any lost step,
replayed-from-stale-state step, or corrupted hand-off shows up as a
per-step loss divergence against the uninterrupted trajectory.

With ``FLEET_TEST_CKPT`` set (the one-slot round trip, where the job's
only slot is lent away and a fresh process takes it back), the worker
saves ``checkpoint.save_step`` of its committed state at the commit where
it hands off after a SIGTERM, and a fresh worker resumes from the newest
such step before its first step.

Log lines: ``<wid> step=<n> rank=<r> size=<s> loss=<float> pid=<p>`` per
step, ``<wid> RESUMED step=<n>`` after a restore, ``<wid> DONE steps=<n>
...`` at the end.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import checkpoint, elastic  # noqa: E402

LOG = os.environ.get("ELASTIC_TEST_LOG", "")
STEPS = int(os.environ.get("FLEET_TEST_STEPS", "12"))
STEP_SLEEP = float(os.environ.get("FLEET_TEST_STEP_SLEEP", "0.3"))
CKPT = os.environ.get("FLEET_TEST_CKPT", "")
DIM = 8
LR = 0.1

WID = os.environ.get("HVDTPU_WORKER_ID", "static:?")


def log_line(msg):
    with open(LOG, "a") as f:
        f.write(f"{WID} {msg}\n")


def pseudo_grad(step, params):
    """Deterministic, rank-independent gradient: the trajectory is a
    pure function of the step sequence, never of cohort size."""
    phase = np.sin(0.5 * step + np.arange(DIM)).astype(np.float32)
    return params.astype(np.float32) * 0.3 + phase


def reference_losses(steps):
    """The uninterrupted trajectory, as the log prints it."""
    params = np.zeros(DIM, np.float32)
    out = []
    for step in range(steps):
        params = params - LR * pseudo_grad(step, params)
        out.append(f"{float(np.sum(params ** 2)):.10f}")
    return out


class HandoffState(elastic.ObjectState):
    """Saves a checkpoint of the commit it hands off at (the one-slot
    round trip's resume point)."""

    def check_host_updates(self):
        if CKPT and elastic.preempt_requested():
            checkpoint.save_step(CKPT, self.step,
                                 {"step": self.step, "params": self.params})
            log_line(f"SAVED step={self.step}")
        super().check_host_updates()


@elastic.run
def train(state):
    while state.step < STEPS:
        g = pseudo_grad(state.step, state.params)
        g = hvd.allreduce(torch.from_numpy(g), op=hvd.Average,
                          name=f"step{state.step}").numpy()
        state.params = state.params - LR * g
        loss = float(np.sum(state.params ** 2))
        log_line(f"step={state.step} rank={hvd.rank()} size={hvd.size()} "
                 f"loss={loss:.10f} pid={os.getpid()}")
        state.step += 1
        state.commit()
        time.sleep(STEP_SLEEP)
    return state.step


def main():
    hvd.init(device="cpu")
    state = HandoffState(step=0, params=np.zeros(DIM, np.float32))
    if CKPT:
        step, saved = checkpoint.restore_latest(CKPT)
        if step is not None:
            state.step = int(saved["step"])
            state.params = np.asarray(saved["params"], np.float32)
            state.save()
            log_line(f"RESUMED step={state.step}")
    final_step = train(state)
    log_line(f"DONE steps={final_step} rank={hvd.rank()} "
             f"size={hvd.size()} "
             f"loss={float(np.sum(state.params ** 2)):.10f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()

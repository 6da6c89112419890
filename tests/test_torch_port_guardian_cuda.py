"""The guardian and the checkpoint on the card, over NCCL, with the
full-width TransformerLM (vocab 30522, hidden 1024, 24 layers, seq 512,
one global batch of 8 split over the ranks), as launcher jobs of
tests/torch_port_guardian_worker.py (``lm`` and ``frozen``) with one rank
per GPU:

- the consistency check at ``HVDTPU_CONSISTENCY_CHECK=1`` and ``64``: the
  losses of 10 steps equal the unchecked run's (1e-6 relative; the same
  reductions in the same order), and each run's median step is printed
  beside two unchecked runs', one before and one after (run with ``-s``);
- a peer frozen with SIGSTOP inside a training step, after the others
  handed NCCL their part of a response: the survivor's watchdog
  (``HVDTPU_COLLECTIVE_TIMEOUT=10``) aborts the in-flight NCCL work and
  raises ``CollectiveAbortError`` at its next collective, within the
  timeout plus two scan periods and one step of the freeze; the time is
  printed, and the survivor shuts down;
- ZeRO-1 (SGD with momentum) saved at n = 4 after 3 steps and restored
  at n = 2 for 2 more: the final parameters within 1e-6 of a replicated
  run of 5 steps at n = 1, and the two ranks' mean loss within 1e-5
  relative of its. The consistency and frozen-peer jobs train AdamW.

Needs 4 GPUs; skips elsewhere:

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_guardian_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

FREEZE_TIMEOUT = 10.0


def _run_jobs(tmp_path_factory, jobs):
    """Launcher jobs of the worker, one after another (each takes the
    first n GPUs): ``[(name, mode, n, env)]``."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (a multi-GPU machine)")
    import torch_port_launch
    from horovod_tpu_torch import _build
    from test_torch_port_guardian import finish_job, start_job
    # The workers load the flash kernels and the core: built once first.
    _build.build(["flash_attention"])
    torch_port_launch.build_port_core()
    done = {}
    for name, mode, n, env in jobs:
        out = tmp_path_factory.mktemp(f"card-{name}")
        proc, log = start_job(out, mode, n, dict(env,
                                                 PORT_TEST_DEVICE="cuda"))
        done[name] = finish_job(out, proc, log, n)
    return done


CHECK_STEPS = "10"


@pytest.fixture(scope="module")
def check_jobs(tmp_path_factory):
    # The unchecked run first and last: its two medians are the spread.
    lm = {"LM_STEPS": CHECK_STEPS}
    done = _run_jobs(tmp_path_factory, [
        ("check0", "lm", 2, lm),
        ("check1", "lm", 2, dict(lm, HVDTPU_CONSISTENCY_CHECK="1")),
        ("check64", "lm", 2, dict(lm, HVDTPU_CONSISTENCY_CHECK="64")),
        ("check0b", "lm", 2, lm)])
    for name, job in done.items():
        res = job["res"][0]
        if res:
            print(f"[guardian card] {name}: step ms (median of steps "
                  f"2-{CHECK_STEPS}) {_median(res['ms']):.1f}, losses "
                  f"{res['losses']}", flush=True)
    return done


@pytest.fixture(scope="module")
def frozen_job(tmp_path_factory):
    job = _run_jobs(tmp_path_factory, [
        ("frozen", "frozen", 2,
         {"HVDTPU_COLLECTIVE_TIMEOUT": str(FREEZE_TIMEOUT)})])["frozen"]
    res = job["res"][0]
    if res:
        print(f"[guardian card] frozen peer: {res.get('error')} after "
              f"{res.get('freeze_to_error_s')} s (timeout "
              f"{FREEZE_TIMEOUT} s); survivor shutdown "
              f"{res.get('shutdown_s')} s", flush=True)
    return job


@pytest.fixture(scope="module")
def zero_jobs(tmp_path_factory):
    # SGD with momentum: AdamW's first steps normalize each gradient
    # element to about +-lr, so an element whose gradient sums to nearly
    # zero moves by a whole step when n (and with it the order of the
    # float32 sums) changes; that is no fault of the checkpoint.
    ckpt = tmp_path_factory.mktemp("card-ckpt")
    sgd = {"LM_OPT": "sgd"}
    done = _run_jobs(tmp_path_factory, [
        ("replicated", "lm", 1, dict(sgd, LM_STEPS="5")),
        ("zero4", "lm", 4, dict(sgd, LM_ZERO="1", LM_STEPS="3",
                                LM_SAVE_AT="3", LM_CKPT=str(ckpt))),
        ("zero2", "lm", 2, dict(sgd, LM_ZERO="1", LM_STEPS="2",
                                LM_RESTORE="1", LM_CKPT=str(ckpt)))])
    for name in ("zero4", "zero2"):
        res = done[name]["res"][0]
        if res:
            print(f"[guardian card] {name}: losses {res['losses']}, save s "
                  f"{res.get('save_s')}, restore s {res.get('restore_s')}",
                  flush=True)
    return done


def _median(v):
    v = sorted(v[1:])
    return v[len(v) // 2]


def _ok(job):
    from test_torch_port_guardian import ok
    return ok(job)


@pytest.mark.parametrize("every", ["1", "64"])
def test_the_consistency_check_keeps_the_losses(check_jobs, every):
    plain = _ok(check_jobs["check0"])["res"]
    checked = _ok(check_jobs[f"check{every}"])["res"]
    for r in range(2):
        np.testing.assert_allclose(checked[r]["losses"], plain[r]["losses"],
                                   rtol=1e-6, atol=0)


def test_a_frozen_peer_is_aborted_inside_nccl(frozen_job):
    job = frozen_job
    res = job["res"][0]
    assert res is not None, job["log"][-6000:]
    assert res["error"] == "CollectiveAbortError", res
    assert "the card (NCCL)" in res["message"] or "watchdog" in \
        res["message"], res["message"]
    scan = max(0.25, min(10.0, FREEZE_TIMEOUT / 4.0))
    step_s = 5.0
    assert 0 < res["freeze_to_error_s"] <= \
        FREEZE_TIMEOUT + 2 * scan + step_s, res
    assert res["shutdown_s"] < 60


def test_zero_saved_at_four_restored_at_two(zero_jobs):
    ref = _ok(zero_jobs["replicated"])
    _ok(zero_jobs["zero4"])
    got = _ok(zero_jobs["zero2"])
    assert got["res"][0]["restored_step"] == 3
    # Each rank's loss is the mean over its half of the batch: their mean
    # is the replicated run's loss.
    mean = np.mean([got["res"][r]["losses"] for r in range(2)], axis=0)
    np.testing.assert_allclose(mean, ref["res"][0]["losses"][3:],
                               rtol=1e-5)
    want, have = ref["arrays"][0], got["arrays"][0]
    assert sorted(want) == sorted(have)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)

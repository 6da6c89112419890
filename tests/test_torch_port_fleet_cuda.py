"""Fleet arbitration across two GPUs, over NCCL (marker ``cuda``; needs 2
CUDA devices, skips elsewhere): the headline row of
tests/test_fleet_matrix.py at full width.

- The reference: ``chip_smoke.py --fleet-child`` (the flagship
  TransformerLM, 8 steps, a commit after each) uninterrupted in a one-slot
  elastic job on GPU 0.
- The lease: the same child as a 2-rank elastic job on GPUs 0 and 1 (the
  same batch on each rank), serving worker 0 (ToyLM on GPU 0) and a router
  on the driver's KV store, the arbiter over its ``fleet`` scope. A burst
  makes the arbiter complete a ``train_to_serve`` lease: rank 1 hands off
  at a commit boundary with exit 83, rank 0 resets in process to size 1
  and trains on, serving worker 1 starts on GPU 1, the freed card.
- Every step's loss is bit-equal to the reference's (a power-of-two
  cohort averaging identical gradients), the hand-off is counted as an
  arbiter transfer, nothing failed, and every accepted request completes
  with the oracle's stream.

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_fleet_cuda.py
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
GPUS = 2


def _job(tmp, slots, with_lease=False):
    """One elastic job of the fleet child on ``slots`` GPUs; with
    ``with_lease`` the serving plane and the arbiter run beside it and a burst
    lends slot ``slots - 1`` to serving. Returns the children's reports,
    the driver and what the lease did."""
    import chip_smoke as cs
    from horovod_tpu_torch.fleet import actuators as fact
    from horovod_tpu_torch.fleet import ledger as fled
    from horovod_tpu_torch.fleet.arbiter import FleetArbiter
    from horovod_tpu_torch.fleet.policy import FleetPolicy
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         ElasticSettings)
    from horovod_tpu_torch.runner.job import Settings
    from horovod_tpu_torch.serving import autoscale
    from horovod_tpu_torch.serving.model import ToyLM
    os.makedirs(tmp)
    out = os.path.join(tmp, "fleet")
    target = os.path.join(tmp, "train.target")
    autoscale.write_target(target, [f"localhost:{slots}"])
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write("\n".join(autoscale.discovery_script_lines(target)) + "\n")
    os.chmod(script, 0o755)
    driver = ElasticDriver(ElasticSettings(
        Settings(num_proc=slots, start_timeout=300,
                 output_filename=os.path.join(tmp, "logs"),
                 env=cs._launcher_env()),
        discovery_script=script, min_np=1, max_np=slots,
        discovery_interval=0.2, sigkill_deadline=300,
        journal_dir=os.path.join(tmp, "journal")),
        cs._child("--fleet-child", out))
    box, lease, record, plane = {}, None, [], None

    def run():
        try:
            box["rc"] = driver.run()
        except Exception as e:  # noqa: BLE001 — asserted below
            box["error"] = repr(e)

    thread = threading.Thread(target=run, daemon=True)
    try:
        if with_lease:
            plane = cs._FleetPlane(driver, devices={0: "cuda:0",
                                                    1: f"cuda:{slots - 1}"})
            plane.set_slots(1)

            class Actuators(fact.TargetFileActuators):
                def set_serve_slots(self, n):
                    super().set_serve_slots(n)
                    plane.set_slots(n)

            arbiter = FleetArbiter(
                fled.LeaseLedger(fled.HttpBackend(
                    "127.0.0.1", driver.port, token=driver.token)),
                Actuators(target, target + ".serve",
                          kv_put=lambda s, k, v: driver.server.put(
                              s, k, v, term=driver._wt())),
                fact.DriverProbes(driver),
                policy=FleetPolicy(min_train_slots=1, min_serve_slots=1,
                                   window=1, cooldown_s=600.0,
                                   ebb_idle_s=600.0, scale_up_depth=8,
                                   slo_p99=0.0),
                train_slots=slots, serve_slots=1, drain_timeout=30.0)
        thread.start()
        if with_lease:
            deadline = time.monotonic() + 300
            while not any(len(r["losses"]) >= 1
                          for r in cs._fleet_results(out)):
                assert time.monotonic() < deadline and thread.is_alive(), \
                    box
                time.sleep(0.05)
            rng = np.random.default_rng(2)
            reqs = [(rng.integers(0, 97, int(rng.integers(8, 513))).tolist(),
                     int(rng.integers(16, 257)))
                    for _ in range(cs.SERVING_REQUESTS)]
            burst = cs._fleet_wave(plane.router, reqs, ToyLM(device="cpu"),
                                   record, "burst")
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and thread.is_alive():
                lease = arbiter.tick()
                if lease is not None and lease["state"] == "complete":
                    break
                time.sleep(0.25)
            lease = dict(lease or {}, serve_devices={
                wid: str(w.device) for wid, w in plane.workers.items()},
                split=dict(arbiter.split))
            for t in burst:
                t.join(timeout=300)
        thread.join(timeout=600)
        assert not thread.is_alive(), "the training job hung"
    finally:
        if plane is not None:
            plane.stop()
        if thread.is_alive():
            for w in list(driver.workers.values()) + [
                    w for w, _ in driver.stopping]:
                w.proc.kill()
        driver.server.stop()
    logs = ""
    for rank_dir in sorted(os.listdir(os.path.join(tmp, "logs"))):
        for name in ("stdout", "stderr"):
            path = os.path.join(tmp, "logs", rank_dir, name)
            if os.path.exists(path):
                logs += f"-- {rank_dir} {name}\n" + open(path).read()[-3000:]
    assert box.get("rc") == 0, (box, logs)
    return cs._fleet_results(out), driver, lease, record


def test_two_gpu_lease_keeps_the_trajectory_bit_exact(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < GPUS:
        pytest.skip(f"needs {GPUS} CUDA devices (a multi-GPU machine)")
    import chip_smoke as cs
    import torch_port_launch
    from horovod_tpu_torch import _build
    torch_port_launch.build_port_core()
    _build.build(["flash_attention"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(f"\n[fleet x{GPUS}] cards {smi}")
    ref, _, _, _ = _job(str(tmp_path / "ref"), 1)
    assert len(ref) == 1 and ref[0]["done"]
    want = ref[0]["losses"]
    assert sorted(map(int, want)) == list(range(1, cs.CHAOS_STEPS + 1))

    t0 = time.perf_counter()
    got, driver, lease, record = _job(str(tmp_path / "lease"), GPUS,
                                      with_lease=True)
    wall = time.perf_counter() - t0
    by_device = {r["device"]: r for r in got}
    print(f"[fleet x{GPUS}] lease {lease.get('id')} {lease.get('state')}, "
          f"wids {lease.get('wids')}, split {lease.get('split')}, serving "
          f"on {lease.get('serve_devices')}; preempt_causes "
          f"{driver.preempt_causes}; job {wall:.1f} s")
    for r in got:
        print(f"[fleet x{GPUS}] pid {r['pid']} on {r['device']} "
              f"({r['backend']}): sizes {r['sizes']}, losses "
              f"{r['losses']}")
    print(f"[fleet x{GPUS}] reference (one GPU): {want}")
    assert lease.get("state") == "complete", lease
    assert lease["direction"] == "train_to_serve"
    assert lease["wids"] == ["localhost:1"]
    assert lease["split"] == {"train": 1, "serve": 2, "leased": 1}
    assert lease["serve_devices"] == {0: "cuda:0", 1: "cuda:1"}
    assert set(by_device) == {"cuda:0", "cuda:1"}
    survivor, victim = by_device["cuda:0"], by_device["cuda:1"]
    assert survivor["done"] and not victim["done"]
    assert all(r["backend"] == "nccl-global" for r in got)
    # Rank 1 left at a commit boundary; rank 0 went on alone.
    assert set(survivor["sizes"].values()) == {1, 2}
    assert set(victim["sizes"].values()) == {2}
    assert sorted(map(int, survivor["losses"])) == \
        list(range(1, cs.CHAOS_STEPS + 1))
    # Every step of both ranks bit-equal to the one-GPU run.
    for r in got:
        for s, loss in r["losses"].items():
            assert loss == want[s], (r["device"], s, loss, want[s])
    assert driver.preempt_causes == {"preempt": 0, "arbiter_transfer": 1}
    assert driver.fail_counts == {} and driver.blacklist == set()
    kinds = [k for k, _ in record]
    assert kinds and set(kinds) <= {"ok", "rejected"}, kinds
    assert "ok" in kinds

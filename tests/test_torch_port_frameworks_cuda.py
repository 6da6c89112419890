"""The data, Keras and TensorFlow bindings of the port on H100s:

- **prefetch_to_device on one GPU.** Pinned host batches of the flagship's
  input shape (batch 8 x seq 512, int64 tokens and targets) feed
  ``chip_smoke.py``'s full-width TransformerLM step (``[train]``'s
  ``transformer_setup``), and batches of ResNet-50's (256 bf16 images,
  ``[resnet]``'s ``resnet_setup``) its device-bound step. Every batch
  arrives equal and on the runtime's device. Printed with the card's name and power limit: the step's median
  wall time with the prefetch (side-stream copies, an event the step's
  stream waits on) beside the same step fed by a blocking ``.to(device)``
  of the same batches, each step synchronized; the same two feeds over
  ``STEPS`` unsynchronized steps (the host runs ahead, as in training);
  and, from a ``torch.profiler`` trace of the prefetch feed, how many of
  its host-to-device copies ran while a kernel of the step ran.
- **The Keras binding, torch backend, on two GPUs**
  (tests/torch_port_frameworks_worker.py ``keras`` under the launcher):
  the gradients reach the port's grouped allreduce as CUDA tensors on each
  rank's own card, and after 3 steps the weights are bit-equal on both
  ranks. Skips where ``keras`` is absent.
- **The TF binding on two GPUs** (the worker's ``tf``): the same weights on
  both ranks after 3 steps, and the collectives keep their dtypes. Skips
  where ``tensorflow`` is absent.

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_frameworks_cuda.py
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_frameworks_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
STEPS = 8
JOB_TIMEOUT = 600


def _need(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices (a GPU machine)")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _feeds(step, host, dev):
    """The step fed by blocking ``.to(device)`` copies and by
    ``prefetch_to_device``, twice each, alternating: (median ms of steps
    2.. with each step synchronized, ms a step over the batches
    unsynchronized, (copies beside a kernel, copies) in a profile of the
    prefetch feed). Every prefetched batch must arrive equal and on
    ``dev``."""
    from horovod_tpu_torch.data import prefetch_to_device

    def feed(name):
        if name.startswith("blocking"):
            return ((x.to(dev), y.to(dev)) for x, y in host)
        return prefetch_to_device(iter(host), size=2)

    def synced(batches):
        # A step's time includes getting its batch: the blocking copy, or
        # the prefetch's wait and its next copy's issue.
        times, seen, it = [], [], iter(batches)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            step(batch).item()                   # .item() synchronizes
            times.append((time.perf_counter() - t0) * 1e3)
            seen.append(batch)
        return sorted(times[1:])[len(times[1:]) // 2], seen

    synced(feed("blocking"))                     # warm-up, both feeds
    synced(feed("prefetch"))
    names = ("blocking", "prefetch", "blocking2", "prefetch2")
    ms, ahead = {}, {}
    for name in names:
        ms[name], seen = synced(feed(name))
        assert len(seen) == len(host)
        for (x, y), (hx, hy) in zip(seen, host):
            assert x.device == dev and y.device == dev
            assert x.dtype == hx.dtype and y.dtype == hy.dtype
            assert torch.equal(x.cpu(), hx) and torch.equal(y.cpu(), hy)
    for name in names:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in feed(name):
            loss = step(batch)
        loss.item()
        ahead[name] = (time.perf_counter() - t0) * 1e3 / len(host)
    overlap = _overlapped_copies(
        lambda: [step(b) for b in feed("prefetch")])
    return ms, ahead, overlap


def _report(what, ms, ahead, overlap):
    print(f"[prefetch] {what}: median step ms of steps 2..{STEPS}, "
          f"blocking .to(device) {ms['blocking']:.2f} / "
          f"{ms['blocking2']:.2f}, prefetch_to_device(size=2) "
          f"{ms['prefetch']:.2f} / {ms['prefetch2']:.2f}; unsynchronized, "
          f"ms a step over {STEPS}: blocking {ahead['blocking']:.2f} / "
          f"{ahead['blocking2']:.2f}, prefetch {ahead['prefetch']:.2f} / "
          f"{ahead['prefetch2']:.2f}; prefetch copies that ran beside a "
          f"kernel: {overlap[0]} of {overlap[1]}; card {_card()}")


def test_prefetch_to_device_feeds_the_flagship_step():
    _need(1)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _build, models

    _build.build(["flash_attention"])
    hvd.init()
    try:
        cfg, model, step, _, _ = cs.transformer_setup(hvd, models)
        gen = torch.Generator().manual_seed(5)
        host = [tuple(torch.randint(0, cfg.vocab_size,
                                    (cs.TRAIN_BATCH, cfg.max_len),
                                    generator=gen).pin_memory()
                      for _ in range(2)) for _ in range(STEPS)]
        ms, ahead, overlap = _feeds(lambda b: step(model, b), host,
                                    hvd.device())
        _report(f"TransformerLM {cfg.layers} layers, batch "
                f"{cs.TRAIN_BATCH} x seq {cfg.max_len} int64", ms, ahead,
                overlap)
    finally:
        hvd.shutdown()


def test_prefetch_to_device_beside_a_device_bound_step():
    """ResNet-50 at batch 256 (``chip_smoke.py``'s ``[resnet]``): the
    device, not the host, sets its step, and a batch is 77 MB of bf16
    images, so a copy on the step's own stream costs step time that a
    side-stream copy can hide."""
    _need(1)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import models, train

    hvd_torch.init()
    try:
        model, step, x, y, _ = cs.resnet_setup(hvd_torch, models, train)
        gen = torch.Generator().manual_seed(6)
        host = [(torch.rand(tuple(x.shape), generator=gen)
                 .to(torch.bfloat16)
                 .to(memory_format=torch.channels_last).pin_memory(),
                 torch.randint(0, 1000, tuple(y.shape), generator=gen)
                 .pin_memory()) for _ in range(STEPS)]
        ms, ahead, overlap = _feeds(lambda b: step(model, b), host,
                                    hvd.device())
        _report(f"ResNet-50, batch {cs.RESNET_BATCH} x 3 x 224 x 224 bf16 "
                "channels_last", ms, ahead, overlap)
    finally:
        hvd.shutdown()


def _overlapped_copies(run):
    """(host-to-device copies that ran while a kernel ran, copies) in a
    ``torch.profiler`` trace of ``run()``; a stream runs its work in order,
    so a copy beside a kernel ran on another stream."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in device if "Memcpy HtoD" in e.name]
    kernels = [e for e in device if "Memcpy" not in e.name
               and "Memset" not in e.name]
    overlapped = sum(
        1 for c in copies if any(
            k.time_range.start < c.time_range.end
            and c.time_range.start < k.time_range.end for k in kernels))
    return overlapped, len(copies)


def _job(mode, out, extra):
    from test_torch_port_guardian import _env
    import torch_port_launch
    out.mkdir(parents=True, exist_ok=True)
    env = _env(dict(FRAMEWORKS_PKG="horovod_tpu_torch", **extra))
    env.pop("HVDTPU_CPU_OPERATIONS", None)
    code, log = torch_port_launch.run_launcher(
        ["-np", "2", "--start-timeout", "300", sys.executable, WORKER, mode,
         str(out)], cwd=REPO, env=env, timeout=JOB_TIMEOUT)
    assert code == 0, log[-4000:]
    import json
    res, checks = [], []
    for r in range(2):
        with np.load(out / f"r{r}.npz") as z:
            res.append(dict(z))
        checks.append(json.loads((out / f"r{r}.json").read_text()))
    return res, checks


def test_keras_torch_backend_syncs_cuda_gradients_on_two_gpus(tmp_path):
    _need(2)
    pytest.importorskip("keras")
    res, checks = _job("keras", tmp_path / "keras",
                       {"KERAS_BACKEND": "torch"})
    for r, c in enumerate(checks):
        grads = [call for call in c["seen"] if len(call) == 4]
        assert len(grads) == 3
        assert all(t == ["Tensor", f"cuda:{r}"] for call in grads
                   for t in call)
    for k in res[0]:
        np.testing.assert_array_equal(res[0][k], res[1][k])
    print(f"[keras] torch backend, 2 GPUs: losses {checks[0]['losses']}; "
          f"card {_card()}")


def test_tf_binding_on_two_gpus(tmp_path):
    _need(2)
    pytest.importorskip("tensorflow")
    res, checks = _job("tf", tmp_path / "tf", {})
    for k in res[0]:
        if k.startswith("w"):
            np.testing.assert_array_equal(res[0][k], res[1][k])
    want = {"f32": "float32", "f64": "float64", "i64": "int64"}
    assert all(dt == want[k.rsplit("_", 1)[1]]
               for k, dt in checks[0]["dtypes"].items())
    print(f"[tf] 2 GPUs: losses {checks[0]['losses']}; card {_card()}")

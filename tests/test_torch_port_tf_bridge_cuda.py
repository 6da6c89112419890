"""The ``tf.function`` bridge on H100s, replayed from TensorFlow-free
records (tests/torch_port_fixtures/tf_*.npz, written by
scripts/torch_port_tf_records.py; the GPU machine has no tensorflow):

- **ResNet-50, the TF way** (BASELINE config #2 at full width): the record
  trains at batch 256 with ``compute_dtype=torch.bfloat16`` through
  ``make_train_step`` and torch SGD with momentum, 10 steps on a fixed
  seeded batch; the loss is finite and falls, the BN moving statistics
  (buffers) change. The median ms of steps 3-10, the peak memory and one
  profiled step's device busy time are printed with the card's name and
  power limit. At batch 2 in fp32 (TF32 off) the card's forward equals the
  CPU replay of the same seeded weights within 1e-3 of the largest logit
  (cuDNN and the CPU sum in other orders through 53 convolutions).
- **A keras encoder at BERT-large widths**, the flash kernels' path: the
  causal and the unmasked record at batch 8 x seq 512 in bf16. A forward
  launches the forward kernel 24 times, a training step each of the three
  kernels 24 times, and no site falls back. The loss and the gradients
  equal those of the same record with the flash call replaced (in this
  test only) by ``reference_attention``: the loss within 1e-2 relative,
  each gradient within 5e-2 of its Frobenius norm (bf16 activations, 24
  layers; the reference computes attention in fp32), the norm floored at
  1e-4 of the whole gradient's: the key biases' gradients are zero in
  exact arithmetic (the softmax is shift-invariant) and both paths give
  rounding noise there. Both step times are printed.
- **Two H100s**: the ResNet-50 record through ``make_train_step`` at batch
  64 a rank for 3 steps leaves the parameters bit-equal across ranks, and
  the rank record gives each rank its own rank.

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_tf_bridge_cuda.py
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
FIXTURES = os.path.join(REPO, "tests", "torch_port_fixtures")
sys.path.insert(0, os.path.join(REPO, "tests"))
LAYERS = 24


def _need(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices (a GPU machine)")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


@pytest.fixture
def runtime():
    _need(1)
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    hvd.init()
    yield hvd
    hvd.shutdown()
    torch.cuda.empty_cache()


def _load(name, **kw):
    from horovod_tpu_torch.tensorflow.compile import CompiledFunction
    return CompiledFunction.from_record(
        os.path.join(FIXTURES, f"tf_{name}.npz"), seed=0, **kw)


def _timed_steps(step, batch, n):
    times, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        times.append((time.perf_counter() - t0) * 1e3)
    return times, losses


def _device_busy_ms(fn):
    """Sum of the device time of one call's CUDA kernels (profiler; the
    kernels' own rows, not the CPU ops that launched them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def test_resnet50_record_trains_at_batch_256_in_bf16(runtime):
    model = _load("resnet50", compute_dtype=torch.bfloat16)
    assert all(p.device.type == "cuda" and p.dtype == torch.float32
               for p in model.parameters())
    step = model.make_train_step(torch.optim.SGD(
        model.parameters(), lr=0.05, momentum=0.9))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(256, 224, 224, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, size=(256,)).astype(np.int32))
    batch = (x.cuda(), y.cuda())
    moving = {k: v.clone() for k, v in model.aux.items() if "moving" in k}
    torch.cuda.reset_peak_memory_stats()
    times, losses = _timed_steps(step, batch, 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = _device_busy_ms(lambda: step(batch))
    med = float(np.median(times[2:]))
    print(f"[tf-resnet50] batch 256 bf16, 224x224, SGD momentum: losses "
          f"{losses}; step ms {[round(t, 2) for t in times]}; median of "
          f"steps 3-10 {med:.2f} ms ({256e3 / med:.1f} img/s); peak "
          f"{peak:.2f} GiB; one profiled step's device busy {busy:.2f} ms; "
          f"ops {len(model._interp.graph.ops)}; card {_card()}")
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert len(moving) == 106
    assert all(not torch.equal(v, model.aux[k]) for k, v in moving.items())


def test_resnet50_record_fp32_forward_on_the_card_matches_the_cpu_replay(
        runtime):
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.RandomState(1)
        x = rng.rand(2, 224, 224, 3).astype(np.float32)
        y = rng.randint(0, 1000, size=(2,)).astype(np.int32)
        loss_c, logits_c = _load("resnet50", device="cpu")(x, y)
        loss_g, logits_g = _load("resnet50")(x, y)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert logits_g.device.type == "cuda"
    scale = float(logits_c.abs().max())
    d = float((logits_g.cpu() - logits_c).abs().max())
    print(f"[tf-resnet50] fp32 batch 2, TF32 off: card against the CPU "
          f"replay: max |d logits| {d:.3e} of max |logit| {scale:.3e}; "
          f"loss {float(loss_g):.7f} / {float(loss_c):.7f}; card {_card()}")
    assert d <= 1e-3 * scale


def _grads(model, batch):
    params = model.params
    out = model.apply(params, list(batch))[0]
    grads = torch.autograd.grad(out, list(params.values()))
    return out.detach(), grads


@pytest.mark.parametrize("name,causal", [("encoder_causal", True),
                                         ("encoder", False)])
def test_encoder_record_runs_attention_on_the_flash_kernels(
        runtime, monkeypatch, name, causal):
    from horovod_tpu_torch import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    _build.build(["flash_attention"])
    notes = []
    monkeypatch.setattr(fa, "note_flash_fallback", notes.append)
    model = _load(name, compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(2)
    ids, labels = (torch.from_numpy(rng.randint(0, 30522, size=(8, 512))
                                    .astype(np.int32)).cuda()
                   for _ in range(2))
    batch = (ids, labels)

    fa.reset_launches()
    model(*batch)
    fwd_only = dict(fa.LAUNCHES)
    fa.reset_launches()
    loss, grads = _grads(model, batch)
    fwd_bwd = dict(fa.LAUNCHES)
    plain = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", fa.reference_attention)
    fa.reset_launches()
    loss_ref, grads_ref = _grads(model, batch)
    ref_launches = sum(fa.LAUNCHES.values())
    floor = 1e-4 * float(torch.stack([r.float().norm()
                                      for r in grads_ref]).norm())
    rel = [float((g.float() - r.float()).norm()) / max(
        float(r.float().norm()), floor) for g, r in zip(grads, grads_ref)]
    dloss = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))

    def steps(n):
        step = model.make_train_step(torch.optim.SGD(model.parameters(),
                                                     lr=1e-4))
        return _timed_steps(step, batch, n)

    ref_times, _ = steps(4)
    monkeypatch.setattr(fa, "flash_attention", plain)
    fa.reset_launches()
    times, losses = steps(6)
    per_step = {k: v // 6 for k, v in fa.LAUNCHES.items() if v}
    med, ref_med = float(np.median(times[1:])), float(np.median(ref_times[1:]))
    print(f"[tf-encoder] {name} (causal {causal}), 24 layers, hidden 1024, "
          f"batch 8 x seq 512, bf16: forward launches {fwd_only}; "
          f"forward+backward {fwd_bwd}; fallbacks {notes}; loss "
          f"{float(loss):.6f} against reference_attention "
          f"{float(loss_ref):.6f} (rel {dloss:.2e}); gradients' relative "
          f"Frobenius error max {max(rel):.3e} median "
          f"{float(np.median(rel)):.3e}; step ms flash "
          f"{[round(t, 2) for t in times]} (median of steps 2-6 "
          f"{med:.2f}), reference_attention "
          f"{[round(t, 2) for t in ref_times]} (median {ref_med:.2f}); "
          f"card {_card()}")
    nonzero = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    assert nonzero(fwd_only) == {"fwd": LAYERS}
    assert nonzero(fwd_bwd) == {"fwd": LAYERS, "bwd_dkv": LAYERS,
                                "bwd_dq": LAYERS}
    assert per_step == {"fwd": LAYERS, "bwd_dkv": LAYERS, "bwd_dq": LAYERS}
    assert ref_launches == 0 and notes == []
    assert np.all(np.isfinite(losses))
    assert dloss <= 1e-2 and max(rel) <= 5e-2


def test_two_gpus_train_the_resnet50_record_in_lockstep(tmp_path):
    _need(2)
    from test_torch_port_tf_records import check_ranks, run_job
    t0 = time.perf_counter()
    code, log, ranks = run_job(tmp_path / "job", {}, image=224, batch=64,
                               steps=3)
    took = time.perf_counter() - t0
    print(f"[tf-resnet50] two GPUs, batch 64 a rank, bf16, 3 steps: exit "
          f"{code} in {took:.1f} s; ranks {ranks}; card {_card()}")
    assert code == 0, log[-4000:]
    check_ranks(ranks, "nccl")

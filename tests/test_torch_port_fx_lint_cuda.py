"""The traced-program analyzer behind ``tpu_compile(verify=...)`` on H100s:

- **BERT-large on one GPU.** ``chip_smoke.py``'s ``BertForMaskedLM``
  stand-in at its ``[bert]`` configuration (24 layers, hidden 1024, batch
  8 x seq 512, bf16 compute, dropout 0.1 through the seeded flash
  kernels) through ``tpu_compile(..., verify=True)``. The check of the
  train signature finds nothing; while it traces, no kernel is launched
  (``LAUNCHES`` unchanged), no ``torch.distributed`` collective is called
  and no port collective is submitted. The first two SGD steps' losses
  equal, bit for bit, those of the same model through ``verify=False``,
  and the first step launched the non-causal flash kernels once per layer.
  The trace's seconds are printed with the card's name and power limit.
- **Two GPUs.** tests/torch_port_fx_lint_worker.py as a launcher job over
  NCCL: a ``torch.cond`` on the traced rank that guards a ``psum`` raises
  ``CollectiveLintError`` (HVD102) on both ranks before any collective is
  issued, within the job's time limit; the hoisted body runs and its sums
  agree.

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_fx_lint_cuda.py
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
sys.path.insert(0, os.path.join(REPO, "tests"))


def _need(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices (a GPU machine)")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def test_bert_large_verify_is_trace_only_clean_and_bit_equal():
    _need(1)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _build, analysis
    from horovod_tpu_torch.ops import collectives as c
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.torch import tpu_compile

    _build.build(["flash_attention"])
    hvd.init()
    cfg = cs.BertConfig(**cs.BERT)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(cs.BERT_BATCH, cs.BERT_SEQ))).cuda()
    batch = {"input_ids": ids, "labels": ids}
    calls = []
    plain_submit, plain_all_reduce = c._submit, dist.all_reduce

    def submit(entry):
        calls.append(entry.name)
        return plain_submit(entry)

    def all_reduce(*a, **k):
        calls.append("all_reduce")
        return plain_all_reduce(*a, **k)
    traces = []
    plain_verify = analysis.verify_traceable

    def timed_verify(*a, **k):
        before, n_calls = dict(fa.LAUNCHES), len(calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diags = plain_verify(*a, **k)
        traces.append({"s": time.perf_counter() - t0, "diags": diags,
                       "launches": {n: fa.LAUNCHES[n] - before[n]
                                    for n in fa.LAUNCHES
                                    if fa.LAUNCHES[n] != before[n]},
                       "calls": calls[n_calls:]})
        return diags
    c._submit, dist.all_reduce = submit, all_reduce
    analysis.verify_traceable = timed_verify
    runs = {}
    try:
        for verify in (True, False):
            gen = torch.Generator(device="cuda").manual_seed(0)
            model = cs.BertForMaskedLM(cfg, device="cuda", generator=gen)
            comp = tpu_compile(model, compute_dtype=torch.bfloat16,
                               verify=verify)
            del model
            step = comp.make_train_step(torch.optim.SGD(
                comp.params.values(), lr=1e-4))
            fa.reset_launches()
            first = step(batch, rng=11).item()
            launches = dict(fa.LAUNCHES)
            second = step(batch, rng=12).item()
            runs[verify] = (first, second, launches, comp._verified)
            del comp, step
            torch.cuda.empty_cache()
    finally:
        c._submit, dist.all_reduce = plain_submit, plain_all_reduce
        analysis.verify_traceable = plain_verify
        hvd.shutdown()
    [trace] = traces
    layers = cfg.num_hidden_layers
    print(f"[fx-lint] BERT-large ({layers} layers, batch {cs.BERT_BATCH} x "
          f"seq {cs.BERT_SEQ}, bf16) verify=True: the train signature's "
          f"trace took {trace['s']:.3f} s; findings {trace['diags']}; "
          f"launches during it {trace['launches']}; collectives during it "
          f"{trace['calls']}; step losses checked {runs[True][:2]} "
          f"unchecked {runs[False][:2]}; first step launches "
          f"{runs[True][2]}; card {_card()}")
    assert trace["diags"] == [] and trace["launches"] == {}
    assert trace["calls"] == []
    assert runs[True][3] == {(True, True, ("input_ids", "labels"))}
    assert runs[True][:2] == runs[False][:2]
    want = {f"{k}_philox": layers for k in ("fwd", "bwd_dkv", "bwd_dq")}
    assert {k: v for k, v in runs[True][2].items() if v} == want
    assert runs[True][2] == runs[False][2]


def test_rank_guarded_psum_is_refused_on_two_gpus_before_a_collective(
        tmp_path):
    _need(2)
    from test_torch_port_fx_lint_job import check_ranks, run_job
    t0 = time.perf_counter()
    code, log, ranks = run_job(tmp_path / "job", {})
    took = time.perf_counter() - t0
    print(f"[fx-lint] two-GPU job: exit {code} in {took:.1f} s; ranks "
          f"{ranks}; card {_card()}")
    assert code == 0, log[-4000:]
    check_ranks(ranks, "nccl")

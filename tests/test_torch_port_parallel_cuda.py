"""The port's parallel strategies on 4 GPUs over NCCL, at the
TransformerLM's widths, each against a witness on one GPU (one job of
tests/torch_port_parallel_worker.py in mode ``card``, rank r on ``cuda:r``,
the axis the ``sp`` dimension of a ``make_mesh`` mesh):

- ring attention, B 1, H 16, S 32768 (8192 per rank), D 64, bf16, causal,
  forward and backward, against one flash call over the whole sequence;
  prints the step, the ring's kernels alone (its overlap: step against
  kernels) and one k/v rotation's bytes and ms;
- Ulysses at the same shapes (4 heads per rank): its all_to_all's bytes
  and ms;
- the pipeline over the full TransformerLM (seed 0), 8 microbatches of
  1 x 512, 4 stages of 6 blocks (``rounds=1``) and 8 stages of 3 blocks
  (``rounds=2``): 3 SGD steps' losses against the model's own step on one
  GPU, and the first step's gradients of each rank's stages, the embedding
  and the head;
- MoE, d_model 1024, d_ff 4096, 8 experts (2 per rank), k 2, capacity
  factor 1.25, 4096 tokens per rank: outputs, aux loss and every weight's
  gradient against ``moe_apply`` without an axis over each rank's tokens.

Needs 4 GPUs; skips elsewhere:

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_parallel_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
N = 4
TIMEOUT = 1200


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < N:
        pytest.skip(f"needs {N} CUDA devices (a multi-GPU machine)")
    import torch_port_launch
    from horovod_tpu_torch import _build
    _build.build(["flash_attention"])   # the workers load the kernels
    out = tmp_path_factory.mktemp("parallel-card")
    port = torch_port_launch.free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_port_parallel_worker.py"),
         "card", str(r), str(N), str(port), str(out)], env=env,
        stdout=open(out / f"log{r}.txt", "w"), stderr=subprocess.STDOUT)
        for r in range(N)]
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=TIMEOUT))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            codes.append("timeout")
    logs = [(out / f"log{r}.txt").read_text() for r in range(N)]
    print(logs[0][-6000:], flush=True)
    assert codes == [0] * N, "\n".join(
        f"rank {r} exited {c}:\n{log[-4000:]}"
        for r, (c, log) in enumerate(zip(codes, logs)))
    res = [json.loads((out / f"r{r}.json").read_text()) for r in range(N)]
    _report(res)
    return res


def _report(res):
    a = [r["attention"] for r in res]
    ring_ms = max(x["ring"]["ms"] for x in a)
    kern_ms = max(x["ring"]["kernels_ms"] for x in a)
    print(f"[parallel card] ring attention, {N} ranks, S 32768: step (fwd + "
          f"bwd) {ring_ms:.2f} ms (slowest rank; ranks "
          f"{[round(x['ring']['ms'], 2) for x in a]}); its kernels alone "
          f"{kern_ms:.2f} ms (ranks "
          f"{[round(x['ring']['kernels_ms'], 2) for x in a]}); step / "
          f"kernels {ring_ms / kern_ms:.3f}; one k/v rotation "
          f"{a[0]['ring']['ppermute_bytes'] / 2 ** 20:.1f} MiB in "
          f"{max(x['ring']['ppermute_ms'] for x in a):.3f} ms; one GPU over "
          f"the whole sequence {a[0]['witness_ms']:.2f} ms", flush=True)
    print(f"[parallel card] Ulysses: step "
          f"{max(x['ulysses']['ms'] for x in a):.2f} ms; q/k/v all_to_all "
          f"{a[0]['ulysses']['a2a_bytes'] / 2 ** 20:.1f} MiB per rank in "
          f"{max(x['ulysses']['a2a_ms'] for x in a):.3f} ms", flush=True)
    m = [r["moe"] for r in res]
    print(f"[parallel card] MoE: step {max(x['ms'] for x in m):.2f} ms "
          f"against {max(x['witness_ms'] for x in m):.2f} ms for the "
          f"{N} ranks' tokens on one GPU; dispatch all_to_all "
          f"{m[0]['a2a_bytes'] / 2 ** 20:.1f} MiB per rank in "
          f"{max(x['a2a_ms'] for x in m):.3f} ms", flush=True)
    for stages in (N, 2 * N):
        p = [r[f"pipeline_{stages}"] for r in res]
        print(f"[parallel card] pipeline, {stages} stages "
              f"(rounds={stages // N}): losses {p[0]['losses']} against "
              f"{p[0]['model_losses']}; step "
              f"{max(x['ms'] for x in p):.1f} ms against the model's "
              f"{p[0]['model_ms']:.1f} ms on one GPU; worst gradient "
              f"relative Frobenius error "
              f"{max(max(x['grad_fro'].values()) for x in p):.2e}; peak "
              f"memory per rank {[round(x['peak_gib'], 2) for x in p]} GiB",
              flush=True)


def _bad(checks):
    return {k: v for k, v in checks.items() if not v[2]}


def test_ring_attention_on_four_gpus_matches_one(card):
    for r, res in enumerate(card):
        ring = res["attention"]["ring"]
        assert not _bad(ring["checks"]), (r, ring["checks"])
        # n LSE-mode calls per rank, forward and backward
        assert {k: c for k, c in ring["launches"].items() if c} == \
            dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), N)


def test_ulysses_on_four_gpus_matches_one(card):
    for r, res in enumerate(card):
        uly = res["attention"]["ulysses"]
        assert not _bad(uly["checks"]), (r, uly["checks"])
        assert {k: c for k, c in uly["launches"].items() if c} == \
            dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), 1)


@pytest.mark.parametrize("stages", [N, 2 * N])
def test_pipeline_on_four_gpus_matches_the_model(card, stages):
    import chip_smoke
    for r, res in enumerate(card):
        p = res[f"pipeline_{stages}"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(p["losses"], p["model_losses"]))
        assert len(p["losses"]) == chip_smoke.PIPE_STEPS
        assert rel <= chip_smoke.PIPE_LOSS_RTOL, (r, p["losses"],
                                                  p["model_losses"])
        assert max(p["grad_fro"].values()) <= chip_smoke.PIPE_GRAD_FRO, \
            (r, p["grad_fro"])
        # every rank's own blocks, the embedding and the head were compared
        blocks = {k.split(".")[2] for k in p["grad_fro"]
                  if k.startswith("backbone.blocks.")}
        assert len(blocks) == 24 // N
        assert "backbone.tok_embed.weight" not in p["grad_fro"]
        assert {"tok_embed", "lm_head.weight"} <= set(p["grad_fro"])


def test_moe_on_four_gpus_matches_one(card):
    for r, res in enumerate(card):
        assert not _bad(res["moe"]["checks"]), (r, res["moe"]["checks"])

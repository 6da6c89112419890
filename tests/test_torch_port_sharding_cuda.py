"""The port's tensor- and FSDP-sharded TransformerLM, the redistribution
planner's group executor and 2-D ZeRO on 4 GPUs over NCCL (one job of
tests/torch_port_sharding_worker.py in mode ``card``, rank r on
``cuda:r``):

- ``shard_model`` of the full-width TransformerLM (vocab 30522, hidden
  1024, 24 layers, 16 heads, seq 512, batch 8, flash attention over each
  rank's heads, AdamW as in ``chip_smoke.py``'s [train]) at (dp 2, tp 2),
  (fsdp 2, tp 2) and (tp 4: the vocabulary does not divide, so the
  embedding and head stay whole) against the same 3 steps on one GPU from
  the same weights: losses within 2e-3 relative, the parameter tree and
  every weight matrix and LayerNorm scale within relative Frobenius error
  2e-2 (bf16 products summed in another order, as in the pipeline's card
  test; the zero-initialized biases count in the tree's error only: their
  Adam steps follow gradients that are rounding noise where the exact
  gradient vanishes), 24 launches of each kernel a step;
  prints step ms and peak memory per GPU against one GPU's;
- ``execute_group`` moving the full parameter tree from Replicated over 4
  ranks to the ZeRO-1 flat layout over 4 and back: bit-equal, with wire
  bytes and ms;
- ``TwoDZero`` at (dp 2, tp 2) on tests/test_twod.py's loss at the MLP's
  widths (1024 -> 4096, 4096 tokens): bit-equal to the same-mesh
  data-parallel oracle; ``reshard_2d`` to (dp 1, tp 2) keeps the moments
  bit-exact and the next step equals the oracle on the new mesh.

Needs 4 GPUs; skips elsewhere:

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_sharding_cuda.py
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
TIMEOUT = 1500
LOSS_RTOL = 2e-3
PARAM_FRO = 2e-2


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < N:
        pytest.skip(f"needs {N} CUDA devices (a multi-GPU machine)")
    import torch_port_launch
    from horovod_tpu_torch import _build
    _build.build(["flash_attention"])   # the workers load the kernels
    out = tmp_path_factory.mktemp("sharding-card")
    port = torch_port_launch.free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_port_sharding_worker.py"),
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
    import torch_port_sharding_worker as w
    ref = res[0]["ref"]
    print(f"[sharding card] one GPU: losses {ref['losses']}, step "
          f"{ref['ms']:.1f} ms, peak {ref['peak_gib']:.2f} GiB", flush=True)
    for label in w.CARD_MESHES:
        m = [r[label] for r in res]
        print(f"[sharding card] {label}: losses {m[0]['losses']} (worst "
              f"relative {max(x['loss_rel'] for x in m):.2e}); step "
              f"{max(x['ms'] for x in m):.1f} ms (slowest rank; ranks "
              f"{[round(x['ms'], 1) for x in m]}); peak per GPU "
              f"{[round(x['peak_gib'], 2) for x in m]} GiB; parameters per "
              f"GPU {m[0]['local_param_bytes'] / 2 ** 30:.3f} GiB; "
              f"parameter tree rel_fro {max(x['tree_fro'] for x in m):.2e}, "
              f"worst weight {max(x['worst_fro'] for x in m):.2e} "
              f"({m[0]['worst_name']}), worst bias "
              f"{max(x['worst_bias_fro'] for x in m):.2e} "
              f"({m[0]['worst_bias_name']}); launches "
              f"{m[0]['launches'][0]}", flush=True)
    for way in ("to_zero", "to_replicated"):
        g = [r["group"][way] for r in res]
        print(f"[sharding card] execute_group {way}: tree "
              f"{res[0]['group']['tree_bytes']} B, {g[0]['strategy']} "
              f"program of {g[0]['steps']} steps, wire {g[0]['wire_bytes']} "
              f"B, sent per rank {[x['sent_bytes'] for x in g]} B in "
              f"{max(x['seconds'] for x in g) * 1e3:.1f} ms, peak per rank "
              f"{[x['peak_bytes'] for x in g]} B", flush=True)
    print(f"[sharding card] TwoDZero (2, 2): losses "
          f"{res[0]['twod']['losses']}; after reshard_2d to (1, 2): "
          f"{res[0]['twod']['loss_after']}", flush=True)


@pytest.mark.parametrize("label", ["dp2_tp2", "fsdp2_tp2", "tp4"])
def test_shard_model_on_four_gpus_matches_one(card, label):
    for r, res in enumerate(card):
        got = res[label]
        assert len(got["losses"]) == 3
        assert got["loss_rel"] <= LOSS_RTOL, (r, got["losses"],
                                              res["ref"]["losses"])
        assert got["tree_fro"] <= PARAM_FRO, (r, got["tree_fro"])
        assert got["worst_fro"] <= PARAM_FRO, (r, got["worst_name"],
                                               got["worst_fro"])
        for launches in got["launches"]:
            assert launches == dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"),
                                             24)


def test_execute_group_round_trip_on_four_gpus(card):
    for r, res in enumerate(card):
        g = res["group"]
        assert g["bit_equal"], r
        assert g["to_zero"]["wire_bytes"] > 0


def test_twod_and_its_reshard_on_four_gpus(card):
    for r, res in enumerate(card):
        tw = res["twod"]
        assert tw["oracle_equal"], r
        if r < 2:
            assert tw["moments_moved"], r
            assert tw["after_equal"], r

"""Smoke run of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from this checkout (one nvcc per source, all
started together), prints each kernel instance's registers, shared memory
and spill bytes, and holds each kernel, in each dropout mode, against its
plain PyTorch version on the card. Then drives the port's two training
paths at full width:

- the TransformerLM (vocab 30522, hidden 1024, 24 layers, 16 heads, seq
  512, causal, RoPE, flash attention): 5 AdamW steps at batch 8 through
  DistributedOptimizer, every step through the three no-dropout kernels;
- BERT-large masked-LM pretraining through the torch bridge
  (``horovod_tpu_torch.torch.tpu_compile``, bf16, train-mode dropout 0.1):
  5 steps at batch 8, seq 512, every step through the seeded (Philox)
  dropout kernels, then 3 under ``HVDTPU_FLASH_DROPOUT=mask`` through the
  explicit-mask ones, then the two modes timed against each other
  (``[bert-ab]``). The card has no ``transformers``, so this script
  brings the user's side: a stand-in of HF's ``BertForMaskedLM`` in plain
  ``torch.nn`` with its layout and parameter names.

- ResNet-50 at batch 256 through Horovod's PyTorch API
  (``horovod_tpu_torch.torch``, ``[resnet]``), and that API's calls on CUDA
  tensors (``[api]``);
- ``[native]``: the control plane. A child process runs as rank 0 of a
  one-rank launcher job (``HVDTPU_PEERS`` on a port it reserves,
  ``HVDTPU_TIMELINE``): the native core (``horovod_tpu_torch/csrc/core/``,
  built with g++ while nvcc runs) negotiates and fuses every named tensor
  and NCCL executes. The TransformerLM trains 5 steps through
  ``train.DistributedOptimizer`` (losses held to [train]'s within 1e-5
  relative) and ResNet-50 5 steps through the torch binding's gradient
  hooks (within 1e-3 of [resnet]'s); it prints per step the named
  submissions, fused responses and their bytes, native cycles and the
  cycle thread's busy time, the step time beside the single-process
  plane's, 0 host waits, the [api] checks again, an alltoall's time, and
  that the timeline holds negotiated ``grad.*`` allreduces. A second child
  times the same steps without any timeline: the control plane's cost.
- ``[sanitize]``: the runtime checkers on the flagship's path. A one-rank
  launcher job on the NCCL-delegated plane, as ``[native]``'s
  (``--sanitize-child``), with ``HVDTPU_SANITIZE=1`` and
  ``HOROVOD_TPU_ORDER_CHECK=1`` (its record written at shutdown), trains
  the full-width TransformerLM 5 steps and times 10 more on the host: no
  finding, no ``LockOrderError``, a clean shutdown audit, the record equal
  to the names in the order they were submitted, the losses bit-equal to
  ``[native]``'s, 24 launches of each no-dropout kernel a step; the host
  step beside ``[native]``'s untimelined one is the checkers' cost.
- ``[elastic]``: the TransformerLM as an elastic job started by the port's
  own launcher (``python -m horovod_tpu_torch.runner.launch -np 1
  --min-np 1 --max-np 1 --host-discovery-script ...``) with this script's
  ``--elastic-child`` as the worker: ``hvd.init()`` through the launcher's
  rendezvous on the card, the grad-hook ``DistributedOptimizer``,
  ``hvd.elastic.TorchState`` committed after each of 6 steps under
  ``@hvd.elastic.run``. A ``HorovodInternalError`` injected once in step 4
  makes it restore step 3's commit and reset in process (a new NCCL group
  at the next elastic version); an ``os._exit(17)`` after step 5 makes the
  driver respawn the slot. Losses are held to [train]'s (1e-5 relative),
  the re-run step and the respawned process to the first attempt (1e-6);
  no step, commit or reset may make the host wait for the device; it
  prints the commit, restore, reset, sync and respawn times.
- ``[compress]``: Horovod's gradient-reduction options in a one-rank
  launcher job (``--compress-child``, re-initialized between parts): the
  TransformerLM 5 steps under ``HVDTPU_COMPRESSION=int8``, then ``fp8``,
  the NCCL plane's quantized pipeline reducing every fused response (step
  1 held to [native]'s loss within 1e-5, later steps within the codec's
  bound of the loss change; one step's responses held to
  ``quantized_allreduce_plain`` on the same bytes; 24 launches per step;
  no host wait), ResNet-50 5 steps with ``Compression.fp16`` and ``bf16``
  through the binding's ``DistributedOptimizer`` (within 2e-2 of
  [resnet]'s), the TransformerLM 3 steps with ``op=Adasum`` (staged
  through pinned host memory; losses equal [native]'s), and a 30522 x 1024
  ``nn.Embedding(sparse=True)`` gradient through ``sparse_allreduce_async``
  under ``HVDTPU_SPARSE=gather`` and ``dense`` (equal to the dense
  gradient). It prints wire bytes, the passes' and the staging's device
  ms, and each step beside [native]'s.
- ``[zero]``: ZeRO-1 in a one-rank launcher job (``--zero-child``): a
  replicated control run, then the TransformerLM 5 steps under
  ``HVDTPU_ZERO=1`` (gradients reduce-scattered into the rank's shard, the
  inner AdamW stepping the shard, the new parameters allgathered back, the
  124 buckets fused into chunks under the fusion threshold, each leg
  negotiated by the native core and run by NCCL): losses
  held to [native]'s (1e-6 relative), final parameters to the control
  run's; then 3 steps each with ``Compression.bf16`` and ``int8`` legs
  (step 1 within 1e-5 of the uncompressed run; int8's alltoall staged
  through pinned host memory). It prints the bucket count, legs and
  responses per step, state bytes against the replicated AdamW state, peak
  memory, each leg's ms, the staging's device ms, and the step beside the
  control's and [native]'s.

- ``[ckpt]``: a crash-safe checkpoint of ZeRO-1 state in two one-rank
  launcher jobs (``--ckpt-child``) with the stuck-collective watchdog
  armed (``HVDTPU_COLLECTIVE_TIMEOUT``): the TransformerLM under ZeRO-1
  AdamW 5 steps as a control, then 3 steps and
  ``checkpoint.save_step`` (``HVDTPU_CHECKPOINT_KEEP=1``) of the model and
  the world-size-independent ZeRO state; a new job restores the newest
  step and runs steps 4-5, held to the control's losses (1e-6 relative)
  and final parameters (equal). It prints the file's bytes, the save and
  restore seconds and GB/s, and the step beside [zero]'s.

- ``[parallel]``: the parallel strategies (``horovod_tpu_torch/parallel/``).
  Ring attention's per-rank schedule at 4 ranks over a global sequence of
  32768 (B 1, H 16, D 64, bf16, causal: the TransformerLM's heads), the 16
  ``flash_attention(..., with_lse=True, q_offset, k_offset)`` calls made
  and merged by the port's own ring loop (``_ring_local``, its rotation
  done by slicing), forward and backward against one flash call
  over the whole sequence (fully-future chunks: O = 0, LSE = -1e30, zero
  gradients), then at 4096 in float32 against dense attention; the
  LSE-mode kernels against their plain versions at the ring's chunk
  shapes (past, diagonal, future; an LSE cotangent in delta), timed beside
  SDPA; and a one-rank launcher job (``--parallel-child``) whose axis is
  the NCCL world group: ``ring_attention`` and ``ulysses_attention``
  against ``flash_attention``, ``moe_apply`` (d_model 1024, d_ff 4096, 8
  experts, 4096 tokens) against the call without an axis, and
  ``pipeline_apply`` over the full TransformerLM (4 stages of 6 blocks,
  ``rounds=4``, 8 microbatches of 1 x 512) against the model's own step:
  3 SGD steps' losses and the first step's gradients.
- ``[serving]`` (after ``[ha]``): the serving plane on the card. The
  flagship's parameters packed into ``plan_zero(n=4)`` flat bucket shards
  load back bit-equal through ``serving.state.load_from_shards``,
  replicated at serving world 1 and in rows at world 4, and through
  ``load_for_inference`` of the live ``state_dict()``; a KV store, two
  ``ServingWorker``s (ToyLM and page pool on the card) and a ``Router``
  over HTTP serve 32 concurrent requests, every stream equal to the host
  oracle, admission blocked and a sequence preempted or migrated; a
  scheduler driven alone makes one host sync a decode step; a drain of
  worker 0 in mid-flight migrates its 8 long streams to worker 1 with
  verified page digests and no recompute. ``[sharded]``'s child also
  holds ``TwoDZero.to_serving`` bit-equal to the params.
- ``[fleet]`` (after ``[serving]``): fleet arbitration on one card. An
  elastic job of the port's driver (one slot, ``--min-np 1 --max-np 1``,
  discovery from the arbiter's target file, the driver journal on) runs
  ``--fleet-child``: the flagship 8 steps, a commit after each. Beside it
  two ``ServingWorker``s (ToyLM on the card, HTTP) and a ``Router`` on the
  driver's KV store, and the ``FleetArbiter`` over the journaled ``fleet``
  scope through ``HttpBackend`` (window 1, cooldown 3 s, ebb idle 3 s,
  ``HVDTPU_FLEET_MIN_TRAIN_SLOTS=0``). A 32-request burst makes it lend
  the job's only slot (``train_to_serve``: the child checkpoints the commit
  it hands off at and exits 83, counted as ``arbiter_transfer``; serving
  grows to two workers); a calm trickle makes it take the slot back
  (``serve_to_train``: worker 1 drains, migrating its streams; a fresh
  child resumes from the checkpoint). Every stream equals the host oracle,
  the losses are held to ``[chaos]``'s control (1e-6 relative), and the
  ledger's split is read back from the journal.

``[trace]`` also holds each traced gradient allreduce's sub→fin span to
at least its NCCL device time (CUDA events around the collective on the
backend's stream): a CUDA ``fin`` is stamped at completion.

Every phase prints ``[time] <phase> <s>`` when it ends.
For each path it times 10 more steps on the host (enqueue time, step time,
calls that made the host wait for the device) and profiles one by kernel
family. Prints one JSON line of per-kernel numbers, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero,
without that line, if there is no CUDA device or any phase fails.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM
H100_HBM_BYTES = 3.35e12   # HBM3 bandwidth, H100 SXM
MAIN = dict(bh=8 * 16, seq=512, d=64, causal=True)
TRAIN_STEPS = 5
TRAIN_BATCH = 8
# Kernel against plain version: (atol, rtol, relative Frobenius) by
# dtype. Kernel and plain version round the same fp32 sums, taken in
# another order, to the output type: an element may land one ulp apart
# (at most 2^-7 of it in bf16, 2^-10 in fp16), and a rounding of P or dS
# that flips moves one term of a sum by one ulp. rtol is two ulps; atol
# covers elements near zero; the Frobenius limit catches an error spread
# over many elements (a tile's contribution lost), which stays inside
# atol.
KERNEL_TOL = {"bfloat16": (1e-2, 2 ** -6, 1e-2),
              "float16": (2e-3, 2 ** -9, 2e-3),
              "float32": (2e-5, 2e-5, 1e-5)}
_TPU_KERNEL = {"fwd": "horovod_tpu/ops/flash_attention.py:165",
               "bwd_dkv": "horovod_tpu/ops/flash_attention.py:309",
               "bwd_dq": "horovod_tpu/ops/flash_attention.py:404"}
# Source of the instance the timed (bf16) shapes run.
_SOURCE = {"fwd": "horovod_tpu_torch/csrc/flash_fwd_sm90.cu",
           "bwd_dkv": "horovod_tpu_torch/csrc/flash_dkv_sm90.cu",
           "bwd_dq": "horovod_tpu_torch/csrc/flash_dq_sm90.cu"}
_SDPA = {"fwd": "sdpa flash forward",
         "bwd_dkv": "sdpa flash backward (dQ, dK, dV in one call)",
         "bwd_dq": "sdpa flash backward (dQ, dK, dV in one call)"}
KERNELS = {
    # name -> (TPU kernel it replaces, SDPA call timed beside it, source)
    f"{k}{m}": (_TPU_KERNEL[k], _SDPA[k] + (" with dropout_p=0.1" if m
                                             else ""), _SOURCE[k])
    for m in ("", "_mask", "_philox") for k in _TPU_KERNEL}
# The no-dropout kernels in ring attention's LSE mode (with_lse=True,
# offsets, an LSE cotangent), timed at a past chunk of the ring.
KERNELS.update({
    f"{k}_lse": (_TPU_KERNEL[k], _SDPA[k].replace("sdpa flash", "sdpa flash "
                                                  "non-causal"), _SOURCE[k])
    for k in _TPU_KERNEL})
BERT = dict(vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
            num_attention_heads=16, intermediate_size=4096,
            max_position_embeddings=512)   # BASELINE config #3, bench.py
BERT_BATCH, BERT_SEQ = 8, 512
BERT_STEPS, BERT_MASK_STEPS = 5, 3
DROP_RATE = 0.1


# ---------------------------------------------------------------------------
# The user's side of the bridge: HF BertForMaskedLM (transformers 4.57,
# models/bert/modeling_bert.py) in plain torch.nn, with its layout, its
# state_dict names, its initialisation and its attention call
# (F.scaled_dot_product_attention with dropout_p in train mode).
# ---------------------------------------------------------------------------

class BertConfig:
    """The fields of HF's BertConfig that BertForMaskedLM reads, with its
    defaults (bert-base widths)."""

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 pad_token_id=0):
        self.__dict__.update(
            {k: v for k, v in locals().items() if k != "self"})


class BertEmbeddings(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
                                            padding_idx=c.pad_token_id, **dev)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size, **dev)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size, **dev)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      **dev)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)
        positions = torch.arange(c.max_position_embeddings,
                                 device=dev.get("device"))[None]
        self.register_buffer("position_ids", positions, persistent=False)
        self.register_buffer("token_type_ids", torch.zeros_like(positions),
                             persistent=False)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        x = self.word_embeddings(input_ids) \
            + self.token_type_embeddings(self.token_type_ids[:, :s])
        x = x + self.position_embeddings(self.position_ids[:, :s])
        return self.dropout(self.LayerNorm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.query = nn.Linear(c.hidden_size, c.hidden_size, **dev)
        self.key = nn.Linear(c.hidden_size, c.hidden_size, **dev)
        self.value = nn.Linear(c.hidden_size, c.hidden_size, **dev)
        self.dropout_prob = c.attention_probs_dropout_prob

    def forward(self, x, attn_mask=None):
        b, s, _ = x.shape

        def split(t):
            return t.view(b, s, self.heads, self.head_dim).transpose(1, 2)
        ctx = F.scaled_dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)),
            attn_mask=attn_mask,
            dropout_p=self.dropout_prob if self.training else 0.0,
            is_causal=False, scale=self.head_dim ** -0.5)
        return ctx.transpose(1, 2).reshape(b, s, -1)


class BertSelfOutput(nn.Module):
    def __init__(self, c, d_in, **dev):
        super().__init__()
        self.dense = nn.Linear(d_in, c.hidden_size, **dev)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      **dev)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, h, residual):
        return self.LayerNorm(self.dropout(self.dense(h)) + residual)


class BertAttention(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.self = BertSelfAttention(c, **dev)
        self.output = BertSelfOutput(c, c.hidden_size, **dev)

    def forward(self, x, attn_mask=None):
        return self.output(self.self(x, attn_mask), x)


class BertIntermediate(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.intermediate_size, **dev)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.attention = BertAttention(c, **dev)
        self.intermediate = BertIntermediate(c, **dev)
        self.output = BertSelfOutput(c, c.intermediate_size, **dev)

    def forward(self, x, attn_mask=None):
        x = self.attention(x, attn_mask)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c, **dev)
                                   for _ in range(c.num_hidden_layers))

    def forward(self, x, attn_mask=None):
        for layer in self.layer:
            x = layer(x, attn_mask)
        return x


class BertModel(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.embeddings = BertEmbeddings(c, **dev)
        self.encoder = BertEncoder(c, **dev)

    def forward(self, input_ids, attention_mask=None):
        x = self.embeddings(input_ids)
        mask = None
        if attention_mask is not None:
            # HF's SDPA path: an additive mask of the dtype's minimum where
            # a key is padding (never read on the host).
            mask = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) \
                * torch.finfo(x.dtype).min
        return self.encoder(x, mask)


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.dense = nn.Linear(c.hidden_size, c.hidden_size, **dev)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      **dev)

    def forward(self, x):
        return self.LayerNorm(F.gelu(self.dense(x)))


class BertLMPredictionHead(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.transform = BertPredictionHeadTransform(c, **dev)
        self.decoder = nn.Linear(c.hidden_size, c.vocab_size, bias=False,
                                 **dev)
        self.bias = nn.Parameter(torch.zeros(c.vocab_size, **dev))
        self.decoder.bias = self.bias

    def forward(self, x):
        return self.decoder(self.transform(x))


class BertOnlyMLMHead(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.predictions = BertLMPredictionHead(c, **dev)

    def forward(self, x):
        return self.predictions(x)


class BertForMaskedLM(nn.Module):
    """HF's BertForMaskedLM: post-LN encoder, erf GELU, MLM head whose
    decoder is tied to the word embeddings, cross-entropy over labels with
    -100 ignored. Returns a dict with ``logits`` (and ``loss`` when
    ``labels`` are given). Weights are HF's initialisation drawn from
    ``generator``."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        dev = {"device": device}
        self.config = config
        self.bert = BertModel(config, **dev)
        self.cls = BertOnlyMLMHead(config, **dev)
        self.cls.predictions.decoder.weight = \
            self.bert.embeddings.word_embeddings.weight
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)) \
                        and m is not self.cls.predictions.decoder:
                    nn.init.normal_(m.weight, 0.0, config.initializer_range,
                                    generator=generator)
                if isinstance(m, nn.Linear) and m.bias is not None:
                    m.bias.zero_()
                if isinstance(m, nn.Embedding) and m.padding_idx is not None:
                    m.weight[m.padding_idx].zero_()

    def forward(self, input_ids, labels=None, attention_mask=None):
        logits = self.cls(self.bert(input_ids, attention_mask))
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = F.cross_entropy(
                logits.view(-1, self.config.vocab_size), labels.view(-1),
                ignore_index=-100)
        return out


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps, flush_buf, warm=True):
    """Mean device ms of ``fn`` over ``reps`` runs, from CUDA events around
    each run, with the L2 cache flushed before each. Every run is queued
    behind a device-side sleep before the host waits, so the events time
    the device's work and not the host's launch overhead. ``warm``: one
    untimed run first (a plain version that takes seconds needs none)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    events = []
    torch.cuda._sleep(50_000_000)   # ~25 ms of clock cycles: host head start
    for _ in range(reps):
        flush_buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def time_once(fn, flush_buf):
    """``fn()`` once, cold, as ``time_ms(fn, 1, flush_buf, warm=False)``
    times it: its result and its device ms. A plain version that takes
    seconds gives the reference output and its time in one call."""
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    flush_buf.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def visible_pairs(s_q, s_k, q_off, k_off, kv_len, causal):
    """(query, key) pairs the mask keeps: the work this data needs."""
    rows = q_off + torch.arange(s_q)[:, None]
    cols = torch.arange(s_k)[None, :]
    keep = (cols < kv_len).expand(s_q, s_k)
    if causal:
        keep = keep & (rows >= k_off + cols)
    return int(keep.sum())


def bound(kind, bh, s_q, s_k, d, pairs, itemsize, mask_bytes=0):
    """Least time (ms) for one call, and what bounds it: each input read
    once and each output written once at HBM rate (``mask_bytes``: the
    keep-mask of the mask mode, read once), against the products of the
    visible pairs at the bf16 tensor-core rate."""
    q_bytes, k_bytes = bh * s_q * d * itemsize, bh * s_k * d * itemsize
    row_bytes = bh * s_q * 4
    if kind == "fwd":        # q, k, v -> o, lse; QK^T and PV
        nbytes = 2 * q_bytes + 2 * k_bytes + row_bytes
        flops = 4 * d * pairs * bh
    elif kind == "bwd_dkv":  # q, k, v, do, lse, delta -> dk, dv; 4 products
        nbytes = 2 * q_bytes + 4 * k_bytes + 2 * row_bytes
        flops = 8 * d * pairs * bh
    else:                    # q, k, v, do, lse, delta -> dq; 3 products
        nbytes = 3 * q_bytes + 2 * k_bytes + 2 * row_bytes
        flops = 6 * d * pairs * bh
    t_bytes = (nbytes + mask_bytes) / H100_HBM_BYTES * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, tol):
    """Max abs error of ``got`` against ``want`` (fp32). Fails unless every
    element has |got - want| <= atol + rtol * |want| and the relative
    Frobenius error ||got - want|| / ||want|| is at most ``fro``, where
    ``tol = (atol, rtol, fro)``. Prints the median |want| beside the
    limits, so the margin can be read."""
    atol, rtol, fro_limit = tol
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item()
    bad = int((diff > atol + rtol * w.abs()).sum().item())
    fro = (diff.norm() / w.norm().clamp_min(1e-30)).item()
    typical = w.abs().median().item()
    log(f"  {name:<14} max_abs_err {err:.3e}  elements past {atol:g} + "
        f"{rtol:g}*|want|: {bad}  rel_fro {fro:.2e} (limit {fro_limit:g})  "
        f"median|want| {typical:.3g}")
    if bad or not fro <= fro_limit:
        fail(f"{name}: kernel disagrees with its plain version ({bad} "
             f"elements past the limit, rel_fro {fro:.2e})")
    return err


def kernel_phase(fa):
    """Each kernel in each dropout mode against its plain version at the
    main paths' shapes and at ragged cases; times at the main paths'
    shapes (the TransformerLM's for no dropout, BERT's for dropout), each
    kernel and the port's whole backward beside SDPA's."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    results = {}

    def operands(bh, s, d, dtype):
        q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        return q, k, v, do

    lse_tol = (1e-4, 1e-5, 1e-5)   # fp32 in every case
    bert_bh = BERT_BATCH * BERT["num_attention_heads"]
    bert_d = BERT["hidden_size"] // BERT["num_attention_heads"]
    ragged = (32, 48, 250)
    cases = [
        # (label, bh, s, d, dtype, causal, lens, dropout mode, timed)
        ("main", MAIN["bh"], MAIN["seq"], MAIN["d"], torch.bfloat16,
         MAIN["causal"], (0, 0, MAIN["seq"]), "", True),
        ("ragged noncausal", 6, 300, 40, torch.bfloat16, False, (0, 0, 250),
         "", False),
        ("ragged causal offset", 6, 300, 40, torch.bfloat16, True, ragged,
         "", False),
        ("ragged causal fp32 d=128", 4, 300, 100, torch.float32, True,
         ragged, "", False),
        ("ragged causal fp16 d=128", 4, 300, 100, torch.float16, True,
         ragged, "", False),
    ]
    for mode in ("", "mask", "philox"):
        # D 128 on the 16-bit kernels: dK/dV takes 32-query sub-tiles there
        cases.append((f"ragged causal offset bf16 d=128 {mode or 'none'}", 4,
                      300, 100, torch.bfloat16, True, ragged, mode, False))
    for mode in ("mask", "philox"):
        cases += [
            (f"bert {mode}", bert_bh, BERT_SEQ, bert_d, torch.bfloat16,
             False, (0, 0, BERT_SEQ), mode, True),
            (f"ragged causal offset fp16 {mode}", 6, 300, 40, torch.float16,
             True, ragged, mode, False),
            (f"ragged causal offset fp32 {mode}", 6, 300, 40, torch.float32,
             True, ragged, mode, False),
        ]
    for label, bh, s, d, dtype, causal, lens, mode, timed in cases:
        log(f"[kernels] {label}: bh={bh} s={s} d={d} {dtype} "
            f"causal={causal} (q_off, k_off, kv_len)={lens}"
            + (f" dropout {mode} rate {DROP_RATE}" if mode else ""))
        q, k, v, do = operands(bh, s, d, dtype)
        tol = KERNEL_TOL[str(dtype).removeprefix("torch.")]
        qp, kp, vp = fa._prepare(*(x[None] for x in (q, k, v)))
        dop = fa._prepare(do[None], do[None], do[None])[0]
        s_pad = qp.shape[1]
        drop = plain_drop = None
        if mode == "mask":
            keep = torch.rand(bh, s_pad, s_pad, generator=gen, device=dev) \
                >= DROP_RATE
            drop = plain_drop = fa.Dropout(DROP_RATE,
                                           mask=keep.to(torch.uint8))
        elif mode == "philox":
            drop = fa.Dropout(DROP_RATE, seed=12345)
            # the plain mask version fed the Philox pattern
            plain_drop = fa.Dropout(DROP_RATE, mask=fa.philox_keep_mask(
                12345, bh, s_pad, s_pad, DROP_RATE, dev).to(torch.uint8))
        keep_mult = None if plain_drop is None else plain_drop.multiplier(
            bh, s_pad, s_pad, dev)
        scale = 1.0 / math.sqrt(d)
        args = (qp, kp, vp, lens, scale, causal)
        o, lse = fa.attention_fwd(*args, drop)
        o_ref, lse_ref = fa.attention_fwd_plain(*args, keep_mult)
        torch.cuda.synchronize()
        sfx = f"_{mode}" if mode else ""
        errs = {"fwd" + sfx: compare("fwd O", o, o_ref, tol)}
        seen = lse_ref > fa.NEG_INF / 2     # rows that see some key
        compare("fwd LSE", lse[seen], lse_ref[seen], lse_tol)
        if not bool((lse[~seen] == fa.NEG_INF).all()):
            fail(f"{label}: LSE of rows that see no key is not -1e30")
        delta = (dop.float() * o_ref.float()).sum(-1)
        bargs = (qp, kp, vp, dop, lse_ref, delta, lens, scale, causal)
        dk, dv = fa.attention_bwd_dkv(*bargs, drop)
        dk_ref, dv_ref = fa.attention_bwd_dkv_plain(*bargs, keep_mult)
        dq = fa.attention_bwd_dq(*bargs, drop)
        dq_ref = fa.attention_bwd_dq_plain(*bargs, keep_mult)
        torch.cuda.synchronize()
        errs["bwd_dkv" + sfx] = max(compare("bwd_dkv dK", dk, dk_ref, tol),
                                    compare("bwd_dkv dV", dv, dv_ref, tol))
        errs["bwd_dq" + sfx] = compare("bwd_dq dQ", dq, dq_ref, tol)
        if label.startswith("ragged causal"):
            # rows q_off + i < k_off see no key: O = 0 and LSE = -1e30.
            dead = lens[1] - lens[0]
            if not (o[:, :dead].float().abs().max().item() == 0.0
                    and bool((lse[:, :dead] == fa.NEG_INF).all())):
                fail(f"{label}: fully masked rows are not O=0, LSE=-1e30")
            log(f"  fully masked rows 0..{dead - 1}: O=0, LSE=-1e30 ok")
        if mode == "philox":
            o2, _ = fa.attention_fwd(*args, fa.Dropout(DROP_RATE,
                                                      seed=12346))
            if torch.equal(o2, o):
                fail(f"{label}: another seed gave the same output")
            log("  another seed gives another output: ok")
        if not timed:
            continue
        pairs = visible_pairs(s, s, *lens, causal)
        plain = {"fwd": lambda: fa.attention_fwd_plain(*args, keep_mult),
                 "bwd_dkv": lambda: fa.attention_bwd_dkv_plain(*bargs,
                                                               keep_mult),
                 "bwd_dq": lambda: fa.attention_bwd_dq_plain(*bargs,
                                                             keep_mult)}
        kern = {"fwd": lambda: fa.attention_fwd(*args, drop),
                "bwd_dkv": lambda: fa.attention_bwd_dkv(*bargs, drop),
                "bwd_dq": lambda: fa.attention_bwd_dq(*bargs, drop)}
        lib = library_times(q, k, v, do, flush_buf, causal,
                            DROP_RATE if mode else 0.0)
        mask_bytes = drop.mask.numel() if mode == "mask" else 0
        for base in ("fwd", "bwd_dkv", "bwd_dq"):
            name = base + sfx
            b_ms, b_by = bound(base, bh, qp.shape[1], kp.shape[1],
                               qp.shape[2], pairs, qp.element_size(),
                               mask_bytes)
            results[name] = {
                "max_abs_err": errs[name],
                "ms": time_ms(kern[base], 20, flush_buf),
                "plain_ms": time_ms(plain[base], 3, flush_buf),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib[base],
            }
            r = results[name]
            log(f"  {name:<14} kernel {r['ms']:.4f} ms | plain "
                f"{r['plain_ms']:.3f} ms | bound {b_ms:.4f} ms ({b_by}) | "
                f"{KERNELS[name][1]} {r['library_ms']:.4f} ms")

        # the port's whole backward as autograd runs it: delta, dK/dV, dQ
        leaves = [x.detach().requires_grad_() for x in (qp, kp, vp)]
        out = fa._FlashAttention.apply(*leaves, lens, scale, causal, drop)[0]
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, leaves, dop, retain_graph=True), 20, flush_buf)
        log(f"  {'backward' + sfx:<14} port {bwd_ms:.4f} ms (delta rowsum + "
            f"dK/dV + dQ) | {KERNELS['bwd_dq' + sfx][1]} "
            f"{lib['bwd_dq']:.4f} ms")
    return results


def attributes_phase(fa):
    """Prints the registers, shared memory and spill bytes of every kernel
    instance (kernel x dtype x head dim x dropout mode), from
    cudaFuncGetAttributes; fails if a wgmma kernel spills at head dim 64."""
    table = {}
    log("[attrs] kernel instance: registers/thread, static + dynamic shared "
        "bytes, local (spill) bytes/thread")
    for kernel in ("fwd", "bwd_dkv", "bwd_dq"):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for d in (64, 128):
                for mode in ("", "mask", "philox"):
                    a = fa.kernel_attributes(kernel, dtype, d, mode)
                    table[(kernel, str(dtype).removeprefix("torch."), d,
                           mode)] = a
                    log(f"  {kernel + ('_' + mode if mode else ''):<14} "
                        f"{str(dtype).removeprefix('torch.'):<8} d={d:<3} "
                        f"regs {a['regs']:>3}  smem {a['static_smem']} + "
                        f"{a['dynamic_smem']:>6}  local {a['local_bytes']}")
    spills = [key for key, a in table.items() if a["local_bytes"]
              and key[1] != "float32" and key[2] == 64]
    if spills:
        fail(f"the wgmma kernels spill to local memory at head dim 64: "
             f"{spills}")


def library_times(q, k, v, do, flush_buf, causal, dropout_p):
    """SDPA's flash backend on the same (B=1, H=BH, S, D) operands: a
    yardstick only, never called by the port. With dropout it draws its own
    random numbers."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (x[None].detach().clone().requires_grad_() for x in
                  (q, k, v))
    kw = dict(is_causal=causal, dropout_p=dropout_p)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(q4, k4, v4, **kw)
        fwd_ms = time_ms(fwd, 20, flush_buf)
        out = F.scaled_dot_product_attention(q4, k4, v4, **kw)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, (q4, k4, v4), do[None], retain_graph=True), 20, flush_buf)
    return {"fwd": fwd_ms, "bwd_dkv": bwd_ms, "bwd_dq": bwd_ms}


def model_check(hvd, models, torch):
    """Flash vs dense attention through the full-width model on a small
    input (2 layers, batch 2, seq 128): same weights, logits must agree to
    bf16 accuracy."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    outs = {}
    for impl in ("einsum", "flash"):
        cfg = models.TransformerConfig(
            vocab_size=30522, hidden=1024, layers=2, heads=16, max_len=128,
            causal=True, use_rope=True, attention_impl=impl)
        gen.manual_seed(1)
        model = models.TransformerLM(cfg, device=hvd.device(), generator=gen)
        tokens = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                               generator=gen)
        with torch.no_grad():
            outs[impl] = model(tokens)
    diff = (outs["flash"] - outs["einsum"]).abs()
    err = diff.max().item()
    scale = outs["einsum"].abs().max().item()
    fro = (diff.norm() / outs["einsum"].norm()).item()
    log(f"[model] flash vs dense attention logits: max_abs_err {err:.3e} "
        f"(limit {5e-2 * scale:.3e} = 5e-2 * {scale:.3g}), rel_fro "
        f"{fro:.2e} (limit 2e-2), median|logit| "
        f"{outs['einsum'].abs().median().item():.3g}: bf16 activations "
        "through 2 blocks")
    if not (math.isfinite(err) and err <= 5e-2 * scale and fro <= 2e-2):
        fail("flash-attention model logits disagree with dense attention")


def transformer_setup(hvd, models, **opt_kw):
    """The full-width TransformerLM from seed 0, its parameters broadcast,
    AdamW wrapped by DistributedOptimizer (``opt_kw``: its options), the
    train step (its ``optimizer`` attribute: the DistributedOptimizer) and
    one batch."""
    cfg = models.TransformerConfig(
        vocab_size=30522, hidden=1024, layers=24, heads=16, max_len=512,
        causal=True, use_rope=True, attention_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = models.TransformerLM(cfg, device=hvd.device(), generator=gen)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4), **opt_kw)

    def loss_fn(m, batch):
        x, y = batch
        logits = m(x)
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1))

    step = hvd.make_train_step(loss_fn, opt)
    step.optimizer = opt
    x = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len),
                      device="cuda", generator=gen)
    y = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len),
                      device="cuda", generator=gen)
    return cfg, model, step, x, y


def train_phase(hvd, fa, models, torch):
    """5 AdamW steps of the TransformerLM on the single-process plane;
    returns the kernels' launches, the losses and the median step ms."""
    cfg, model, step, x, y = transformer_setup(hvd, models)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] TransformerLM {n_params / 1e6:.1f}M params, batch "
        f"{TRAIN_BATCH} x seq {cfg.max_len}, {TRAIN_STEPS} AdamW steps")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        loss = step(model, (x, y)).item()   # .item() synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES
               if fa.LAUNCHES[n] - before[n]}
        log(f"  step {i + 1}: loss {loss:.6f}  {times[-1]:.1f} ms  "
            f"launches {per}")
        if per != dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), cfg.layers):
            fail(f"step {i + 1}: expected {cfg.layers} launches of each "
                 f"no-dropout kernel (one per layer), got {per}")
    launches = dict(fa.LAUNCHES)
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not descend: {losses}")
    flops_per_tok = 6 * n_params + 12 * cfg.layers * cfg.max_len * cfg.hidden

    def rates(step_ms):
        samples_s = TRAIN_BATCH / (step_ms / 1e3)
        mfu = samples_s * cfg.max_len * flops_per_tok / H100_BF16_FLOPS
        return (f"{samples_s:.2f} samples/s; MFU {mfu:.4f} of "
                f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[train] step ms (median of steps 2..{TRAIN_STEPS}) {steady:.1f}, "
        f"range {min(times[1:]):.1f}..{max(times[1:]):.1f}; "
        f"first step {times[0]:.1f} ms; {rates(steady)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    median, _ = host_phase(lambda: step(model, (x, y)))
    log(f"[host] at the median step: {rates(median)}")
    profile_step(lambda: step(model, (x, y)).item(), median)
    return launches, losses, steady, median


def _rel_fro(got, want):
    num = sum(float((g.float() - w.float()).norm() ** 2)
              for g, w in zip(got, want))
    den = sum(float(w.float().norm() ** 2) for w in want)
    return math.sqrt(num / max(den, 1e-30))


def dense_attention(fa):
    """A stand-in for ``fa.flash_attention`` in plain fp32 torch, written
    here and not in the port: the witness that ``[bert-check]`` holds the
    bridge's flash path to. It drops the elements the flash call would: the
    bridge's keep-mask, or the Philox pattern of its seed (whose plain
    version ``[kernels]`` holds against the seeded kernels)."""
    def attention(q, k, v, *, causal=False, sm_scale=None, dropout_mask=None,
                  dropout_rate=0.0, dropout_seed=None):
        b, h, s_q, d = q.shape
        s_k = k.shape[2]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
            * (d ** -0.5 if sm_scale is None else sm_scale)
        if causal:
            s = s.masked_fill(~torch.ones(s_q, s_k, dtype=torch.bool,
                                          device=q.device).tril(),
                              float("-inf"))
        p = torch.softmax(s, -1)
        if dropout_seed is not None:
            dropout_mask = fa.philox_keep_mask(
                dropout_seed, b * h, s_q, s_k, dropout_rate,
                q.device).view(b, h, s_q, s_k)
        if dropout_mask is not None and dropout_rate:
            p = p * dropout_mask.float() / (1.0 - dropout_rate)
        return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return attention


def bert_check(hvd_torch, fa):
    """The bridge's flash path with dropout against a dense witness: a
    2-layer stand-in at full width in train mode, one seed, in each dropout
    mode (``HVDTPU_FLASH_DROPOUT`` mask, then prng), once through the
    kernels and once with ``fa.flash_attention`` replaced by
    :func:`dense_attention`, which the bridge hands the same keep-masks or
    seeds. Loss and gradients must agree to bf16 accuracy; in eval mode the
    logits too."""
    cfg = BertConfig(**dict(BERT, num_hidden_layers=2))
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = BertForMaskedLM(cfg, device="cuda", generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                        generator=gen)
    batch = {"input_ids": ids, "labels": ids}
    kernels = fa.flash_attention

    def run(mode, attention):
        os.environ["HVDTPU_FLASH_DROPOUT"] = mode
        fa.flash_attention = attention
        try:
            compiled = hvd_torch.tpu_compile(model,
                                             compute_dtype=torch.bfloat16)
            fa.reset_launches()
            loss = compiled.loss_fn()(compiled.params, batch, rng=7)
            grads = torch.autograd.grad(loss, list(compiled.params.values()))
            logits = compiled(**batch)["logits"]
            torch.cuda.synchronize()
            return loss.item(), grads, logits, dict(fa.LAUNCHES)
        finally:
            fa.flash_attention = kernels
            del os.environ["HVDTPU_FLASH_DROPOUT"]

    for mode, sfx in (("mask", "_mask"), ("prng", "_philox")):
        l_f, g_f, z_f, n_f = run(mode, kernels)
        l_e, g_e, z_e, n_e = run(mode, dense_attention(fa))
        if not (n_f["fwd" + sfx] == n_f["bwd_dkv" + sfx]
                == n_f["bwd_dq" + sfx] == cfg.num_hidden_layers
                and not any(n_e.values())):
            fail(f"[bert-check] {mode} launches: flash run {n_f}, dense "
                 f"run {n_e}")
        fro = _rel_fro(g_f, g_e)
        zdiff = (z_f.float() - z_e.float()).abs()
        zscale = z_e.float().abs().max().item()
        zfro = _rel_fro([z_f], [z_e])
        log(f"[bert-check] {mode}: 2 layers, batch 2 x seq 128, train mode, "
            f"seed 7: loss flash {l_f:.6f} dense {l_e:.6f} (|diff| "
            f"{abs(l_f - l_e):.2e}, limit 1e-2); gradients rel_fro "
            f"{fro:.2e} (limit 2e-2); eval logits max_abs_err "
            f"{zdiff.max().item():.3e} (limit {5e-2 * zscale:.3e}), rel_fro "
            f"{zfro:.2e} (limit 2e-2)")
        if not (abs(l_f - l_e) <= 1e-2 and fro <= 2e-2
                and zdiff.max().item() <= 5e-2 * zscale and zfro <= 2e-2):
            fail(f"[bert-check] the flash dropout path ({mode}) disagrees "
                 "with dense attention fed the same dropout")


def bert_phase(hvd_torch, fa):
    """BERT-large MLM through tpu_compile: 5 steps in Philox mode (auto's
    choice on the card), 3 in mask mode, the A/B of the two, then the host
    and profile phases of the Philox step. Returns the launch counts of
    each mode's run."""
    cfg = BertConfig(**BERT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = BertForMaskedLM(cfg, device="cuda", generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    compiled = hvd_torch.tpu_compile(model, compute_dtype=torch.bfloat16)
    del model
    step = compiled.make_train_step(torch.optim.AdamW(
        compiled.params.values(), lr=1e-4))
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(BERT_BATCH, BERT_SEQ))).to("cuda")
    batch = {"input_ids": ids, "labels": ids}   # bench.py:1315
    layers = cfg.num_hidden_layers
    flops_per_tok = 6 * n_params + 12 * layers * BERT_SEQ * cfg.hidden_size
    seeds = iter(range(10 ** 6))

    def rates(step_ms):
        samples_s = BERT_BATCH / (step_ms / 1e3)
        mfu = samples_s * BERT_SEQ * flops_per_tok / H100_BF16_FLOPS
        return (f"{samples_s:.2f} samples/s; MFU {mfu:.4f} of "
                f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s")

    def run(mode, steps):
        want = {f"{k}_{mode}": layers for k in ("fwd", "bwd_dkv", "bwd_dq")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, times = [], []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(steps):
                before = dict(fa.LAUNCHES)
                t0 = time.perf_counter()
                loss = step(batch, rng=next(seeds)).item()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss)
                per = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES
                       if fa.LAUNCHES[n] - before[n]}
                log(f"  step {i + 1}: loss {loss:.6f}  {times[-1]:.1f} ms  "
                    f"launches {per}")
                if per != want:
                    fail(f"[bert] {mode} step {i + 1}: expected {want}, got "
                         f"{per}")
        fallbacks = [str(w.message) for w in caught
                     if "falls back to the einsum lowering" in str(w.message)]
        if fallbacks:
            fail(f"[bert] attention fell back: {fallbacks}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"[bert] non-finite loss: {losses}")
        if not losses[-1] < losses[0]:
            fail(f"[bert] loss did not descend: {losses}")
        steady = sorted(times[1:])[len(times[1:]) // 2]
        log(f"[bert] {mode}: step ms (median of steps 2..{steps}) "
            f"{steady:.1f}, range {min(times[1:]):.1f}.."
            f"{max(times[1:]):.1f}; first step {times[0]:.1f} ms; "
            f"{rates(steady)}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        return dict(fa.LAUNCHES)

    log(f"[bert] BertForMaskedLM stand-in {n_params / 1e6:.1f}M params "
        f"through tpu_compile (bf16), batch {BERT_BATCH} x seq {BERT_SEQ}, "
        f"dropout {DROP_RATE}, AdamW lr 1e-4; {BERT_STEPS} steps with the "
        f"seeded (Philox) kernels, auto's choice on the card")
    launches = run("philox", BERT_STEPS)
    log(f"[bert] {BERT_MASK_STEPS} steps under HVDTPU_FLASH_DROPOUT=mask")
    os.environ["HVDTPU_FLASH_DROPOUT"] = "mask"
    try:
        launches.update({n: c for n, c in run("mask",
                                              BERT_MASK_STEPS).items()
                         if n.endswith("_mask")})
    finally:
        del os.environ["HVDTPU_FLASH_DROPOUT"]
    bridge_ab(compiled, step, batch, seeds)
    median, syncs = host_phase(lambda: step(batch, rng=next(seeds)),
                               label="bert step")
    if syncs:
        fail(f"[host] {syncs} calls inside the bert steps made the host wait "
             "for the device")
    log(f"[host] bert step at the median: {rates(median)}")
    profile_step(lambda: step(batch, rng=next(seeds)).item(), median,
                 label="bert step")
    return launches


class Fp32LayerNorm(TorchFunctionMode):
    """LayerNorm of bf16 inputs through fp32 casts, the reroute the torch
    bridge once made (it now leaves LayerNorm to torch, which computes in
    fp32 and rounds once): ``[bert-ab]`` times the two against each other.
    Entered around a step, it sees the calls the bridge passes on."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.layer_norm:
            return self.layer_norm(*args, **kwargs)
        return func(*args, **kwargs)

    @staticmethod
    def layer_norm(x, normalized_shape, weight=None, bias=None, eps=1e-5):
        return F.layer_norm(x.float(), normalized_shape,
                            None if weight is None else weight.float(),
                            None if bias is None else bias.float(),
                            eps).to(x.dtype)


def bridge_ab(compiled, step, batch, seeds, rounds=4):
    """The BERT step's two dropout modes (HVDTPU_FLASH_DROPOUT mask, and
    auto, which takes Philox on the card), and torch's LayerNorm against
    the fp32 reroute, alternated in this run. Each block of a variant: one
    step to warm up, two steps started on an idle device (the ms the host
    takes to enqueue each, and until the device has finished it), and one
    profiled step (its device busy ms: the sum of its kernels' times, which
    waits for the host do not enter). First, the loss of each variant at
    the same params and seed."""
    variants = {"mask": ("mask", False), "philox": ("auto", False),
                "philox, fp32 LayerNorm": ("auto", True)}
    enqueue, step_ms, busy = ({v: [] for v in variants} for _ in range(3))
    peak = dict.fromkeys(variants, 0)
    losses = {}

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, rng=next(seeds))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    for r in range(rounds + 1):
        for name, (mode, fp32_ln) in variants.items():
            os.environ["HVDTPU_FLASH_DROPOUT"] = mode
            try:
                with Fp32LayerNorm() if fp32_ln else contextlib.nullcontext():
                    if r == 0:
                        with torch.no_grad():
                            losses[name] = compiled.loss_fn()(
                                compiled.params, batch, rng=99).item()
                        continue
                    torch.cuda.reset_peak_memory_stats()
                    timed()
                    for _ in range(2):
                        enq, total = timed()
                        enqueue[name].append(enq)
                        step_ms[name].append(total)
                    busy[name].append(sum(ms for _, ms, _ in device_kernels(
                        lambda: step(batch, rng=next(seeds)).item())))
                    peak[name] = max(peak[name],
                                     torch.cuda.max_memory_allocated())
            finally:
                del os.environ["HVDTPU_FLASH_DROPOUT"]

    def spread(v):
        v = sorted(v)
        return (f"median {(v[len(v) // 2 - 1] + v[len(v) // 2]) / 2:.2f} "
                f"min {v[0]:.2f} max {v[-1]:.2f}")
    log(f"[bert-ab] {rounds} rounds of {len(variants)} variants, each block "
        f"a warm-up step, 2 steps from an idle device, 1 profiled step")
    for name in variants:
        log(f"  {name:<23} device busy ms {spread(busy[name])}; host "
            f"enqueue ms {spread(enqueue[name])}; step ms "
            f"{spread(step_ms[name])}; peak memory "
            f"{peak[name] / 2 ** 30:.2f} GiB; loss at seed 99 "
            f"{losses[name]:.6f}")


def host_phase(run, steps=10, label="step"):
    """Host side of ``steps`` more train steps, each started on an idle
    device: the ms the host takes to enqueue a step (``run`` returns the
    loss without reading it), the ms until the device has finished it,
    and every call inside a step that made the host wait for the device
    (CUDA sync debug mode)."""
    enqueue, total, syncs = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                run()
                enqueue.append((time.perf_counter() - t0) * 1e3)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
        syncs += [f"{w.filename}:{w.lineno}" for w in caught
                  if "called a synchronizing" in str(w.message)]

    def spread(v):
        v = sorted(v)
        return f"median {v[len(v) // 2]:.1f} min {v[0]:.1f} max {v[-1]:.1f}"
    log(f"[host] {label}: {steps} more steps: host enqueue ms "
        f"{spread(enqueue)}; "
        f"step ms {spread(total)}; synchronizing calls inside the steps: "
        f"{len(syncs)}")
    for site in sorted(set(syncs)):
        log(f"  x{syncs.count(site)} {site}")
    return sorted(total)[steps // 2], len(syncs)


def device_kernels(run):
    """(name, device ms, launches) of each kernel that ``run`` launched,
    from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            # optimizer/profiler ranges on the GPU timeline are not
            # kernels: counting them would count their kernels twice
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))
            and e.self_device_time_total > 0]


ATTENTION_FAMILIES = {"flash attention kernels": ("flash_",),
                      "matmul (cuBLAS/CUTLASS)": ("gemm", "cutlass", "xmma",
                                                  "sm90_", "nvjet")}
# Checked in order: cuDNN's BatchNorm kernels also carry "cudnn".
RESNET_FAMILIES = {"BN": ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                          "bn_bp"),
                   "optimizer": ("multi_tensor",),
                   "convolutions and matmuls": (
                       "conv", "cudnn", "xmma", "implicit", "dgrad",
                       "wgrad", "fprop", "gemm", "cutlass", "sm90_",
                       "nvjet")}


def profile_step(run, step_ms, label="step", families=ATTENTION_FAMILIES,
                 other="other"):
    """Device time of one more train step by kernel family (after the
    counted steps), and the device's idle share of the unprofiled median
    step time ``step_ms`` of the host phase (the profiler itself slows the
    host). A kernel goes to the first family one of whose keys its name
    contains, else to ``other``."""
    kernels = device_kernels(run)
    busy = sum(ms for _, ms, _ in kernels)
    if busy == 0:
        log("[profile] the profiler saw no device time: not measured")
        return
    split = dict.fromkeys(list(families) + [other], 0.0)
    for name, ms, _ in kernels:
        fam = next((f for f, keys in families.items()
                    if any(k in name.lower() for k in keys)), other)
        split[fam] += ms
    log(f"[profile] one {label}: device busy {busy:.2f} ms of the "
        f"{step_ms:.1f} ms median step: idle share "
        f"{max(0.0, 1 - busy / step_ms):.3f}")
    for fam, ms in split.items():
        log(f"  {fam:<26} {ms:8.2f} ms  {ms / busy:.3f} of device time")
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:10]:
        log(f"  {ms:8.2f} ms  x{count:<4} {name[:90]}")


RESNET_BATCH = 256     # per GPU
RESNET_STEPS = 5
# bf16 against fp32 logits of the same ResNet-50 at initialisation, by
# relative Frobenius error: bf16 rounds each conv's input and kernel to 8
# bits of mantissa (unit roundoff 2^-9); at initialisation the logits pass
# the stem, the four projection convs and the head (each block's last
# BatchNorm has scale 0), ~6 roundings of 2 * 2^-9 each: ~1e-2.
RESNET_CHECK_TOL = 3e-2


def train_flops_per_image(model, image_size=224):
    """FLOPs of one trained image: 2 x the multiply-adds of the forward's
    convolutions and dense head, counted from their shapes, x 3 for the
    forward and the backward's input and weight gradients. BatchNorm,
    ReLU, pooling and the update are not counted."""
    flops = 0

    def count(mod, inp, out):
        nonlocal flops
        if isinstance(mod, nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels
            flops += 2 * k * out[0].numel()
        else:
            flops += 2 * mod.in_features * mod.out_features
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros(1, 3, image_size, image_size,
                              device=next(model.parameters()).device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return 3 * flops


def api_phase(hvd_torch, label="[api]", joined_rank=-1):
    """Horovod's torch API on CUDA tensors at size 1: an async in-place
    allreduce polled and synchronized, a grouped one, alltoall with splits,
    reducescatter and join (``joined_rank``: -1 in a single-process job, 0
    in a one-rank launcher job), each checked for values, dtype and device,
    with the host allowed to wait for nothing."""
    hvd = hvd_torch
    x = torch.arange(8, device="cuda", dtype=torch.bfloat16)
    xs = [torch.ones(3, device="cuda"),
          torch.arange(6, device="cuda", dtype=torch.float32)]
    splits = torch.tensor([6], dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = hvd.allreduce_async_(x, op=hvd.Sum, prescale_factor=2.0)
        polled = isinstance(hvd.poll(h), bool)
        out = hvd.synchronize(h)
        grouped = hvd.synchronize(hvd.grouped_allreduce_async(
            xs, op=hvd.Average, postscale_factor=3.0))
        a2a, recv = hvd.alltoall(xs[1], splits=splits)
        rs = hvd.reducescatter(xs[0])
        joined = hvd.join()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    checks = {
        "allreduce_async_ poll": polled and hvd.poll(h) is True,
        "allreduce_async_ in place": (
            out is x and x.dtype == torch.bfloat16 and x.device.type == "cuda"
            and torch.equal(x, 2 * torch.arange(8, device="cuda",
                                                dtype=torch.bfloat16))),
        "grouped_allreduce_async": all(
            g.device == t.device and g.dtype == t.dtype
            and torch.equal(g, 3 * t) for g, t in zip(grouped, xs)),
        "alltoall splits": (torch.equal(a2a, xs[1])
                            and a2a.device.type == "cuda"
                            and recv.dtype == torch.int32
                            and recv.tolist() == [6]),
        "reducescatter": rs.device.type == "cuda" and torch.equal(rs, xs[0]),
        "join": joined == joined_rank,
    }
    log(f"{label} " + ", ".join(f"{k}: {'ok' if v else 'FAILED'}"
                                for k, v in checks.items()))
    if not all(checks.values()):
        fail(f"{label} the torch API at size 1 on CUDA tensors: {checks}")


def resnet_check(models):
    """The bf16 ResNet-50 against the same weights in fp32, train-mode
    logits at initialisation, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((16, 3, 224, 224), device="cuda", generator=gen)
    logits = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen.manual_seed(0)
        model = models.ResNet50(num_classes=1000, dtype=dtype,
                                device="cuda", generator=gen)
        model = model.to(memory_format=torch.channels_last)
        with torch.no_grad():
            logits[dtype] = model(x.to(memory_format=torch.channels_last))
    got, want = logits[torch.bfloat16], logits[torch.float32]
    fro = _rel_fro([got], [want])
    finite = bool(torch.isfinite(got).all())
    log(f"[resnet-check] bf16 vs fp32 ResNet-50 logits at initialisation "
        f"(batch 16, 224x224, train mode): rel_fro {fro:.3e} (limit "
        f"{RESNET_CHECK_TOL:.0e}), max_abs_err "
        f"{(got - want).abs().max().item():.3e}, max|logit| "
        f"{want.abs().max().item():.3g}, shape {tuple(got.shape)}")
    if not (finite and got.shape == (16, 1000) and fro <= RESNET_CHECK_TOL):
        fail("bf16 ResNet-50 logits disagree with fp32")


def resnet_setup(hvd, models, train, compression=None):
    """ResNet-50 from seed 0, its parameters and SGD state broadcast, the
    optimizer wrapped by the torch binding's DistributedOptimizer (with
    ``compression``), the has_aux train step, one batch and the FLOPs of a
    trained image."""
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = models.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                            device="cuda", generator=gen)
    model = model.to(memory_format=torch.channels_last)
    flops = train_flops_per_image(model)
    x = torch.rand((RESNET_BATCH, 3, 224, 224), device="cuda",
                   generator=gen).to(torch.bfloat16).to(
                       memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (RESNET_BATCH,), device="cuda",
                      generator=gen)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters(),
                                   compression=compression)

    def loss_fn(m, batch):
        bx, by = batch
        return F.cross_entropy(m(bx), by)
    return model, train.make_train_step(loss_fn, opt, has_aux=True), x, y, \
        flops


def resnet_phase(hvd_torch, models, train):
    """Horovod's PyTorch recipe on ResNet-50 (1000 classes, 224x224, bf16
    compute, fp32 parameters, channels_last), batch 256 per GPU, random
    images and labels from seed 0, SGD(lr=0.1) as bench.py trains it:
    broadcast the parameters and optimizer state, wrap the optimizer,
    train RESNET_STEPS steps through make_train_step(has_aux=True)."""
    hvd = hvd_torch
    hvd.init()
    model, step, x, y, flops = resnet_setup(hvd, models, train)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[resnet] ResNet-50 {n_params / 1e6:.2f}M params, batch "
        f"{RESNET_BATCH} x 3 x 224 x 224 bf16 channels_last, SGD lr 0.1, "
        f"{RESNET_STEPS} steps through horovod_tpu_torch.torch "
        f"(size {hvd.size()}); {flops / 1e9:.3f} GFLOP per trained image "
        "(3 x 2 x conv and dense multiply-adds, from their shapes)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss = step(model, (x, y)).item()   # .item() synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        log(f"  step {i + 1}: loss {loss:.6f}  {times[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(v) for v in losses):
        fail(f"[resnet] non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"[resnet] loss did not descend: {losses}")
    bn = model.bn_init
    if int(bn.num_batches_tracked) != RESNET_STEPS or not bool(
            torch.isfinite(bn.running_var).all()):
        fail("[resnet] BatchNorm statistics were not tracked")

    def rates(step_ms):
        img_s = RESNET_BATCH / (step_ms / 1e3)
        return (f"{img_s:.1f} img/s per GPU; MFU "
                f"{img_s * flops / H100_BF16_FLOPS:.4f} of "
                f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[resnet] step ms (median of steps 2..{RESNET_STEPS}) "
        f"{steady:.1f}, range {min(times[1:]):.1f}..{max(times[1:]):.1f}; "
        f"first step {times[0]:.1f} ms; {rates(steady)}; peak memory "
        f"{peak:.2f} GiB; losses {[round(v, 6) for v in losses]}")
    median, syncs = host_phase(lambda: step(model, (x, y)),
                               label="resnet step")
    if syncs:
        fail(f"[host] {syncs} calls inside the resnet steps made the host "
             "wait for the device")
    log(f"[host] resnet step at the median: {rates(median)}")
    profile_step(lambda: step(model, (x, y)).item(), median,
                 label="resnet step", families=RESNET_FAMILIES,
                 other="elementwise and other")
    return losses, steady, median

# [native]: a one-rank launcher job in a child process. TransformerLM
# losses must equal [train]'s (an average over one rank through NCCL is
# exact: the same kernels on the same inputs); ResNet-50's may differ by
# cuDNN's choice of algorithms, which its benchmark mode makes anew.
NATIVE_TRANSFORMER_RTOL = 1e-5
NATIVE_RESNET_ATOL = 1e-3
A2A_MIB = 16


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def native_phase(train_losses, train_ms, resnet_losses, resnet_ms):
    """Drive the native control plane on the card. A child process runs as
    rank 0 of a one-rank launcher job (``HVDTPU_RANK``/``HVDTPU_SIZE``,
    ``HVDTPU_PEERS`` on a port the child reserves, ``MASTER_ADDR``/
    ``MASTER_PORT``, ``HVDTPU_TIMELINE``): the native core negotiates and
    fuses every named tensor and NCCL executes. Its losses are held to
    [train]'s and [resnet]'s; its step time beside theirs (``*_ms``: the
    median of their counted steps and their [host] median) is the control
    plane's cost at size 1."""
    import socket
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hvd-native-") as tmp:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            master = sock.getsockname()[1]
        env = dict(os.environ, HVDTPU_RANK="0", HVDTPU_SIZE="1",
                   HVDTPU_LOCAL_RANK="0", HVDTPU_LOCAL_SIZE="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))
        out = os.path.join(tmp, "native.json")
        # The job with its timelines (the checks), then the same steps
        # without any timeline (the control plane's own cost).
        for args, extra in ((["--native-child", out], dict(
                HVDTPU_TIMELINE=os.path.join(tmp, "timeline.json"))),
                            (["--native-child", out + ".bare", "bare"], {})):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), *args],
                env={**env, **extra}, timeout=900)
            if proc.returncode != 0:
                fail(f"[native] the one-rank launcher job exited "
                     f"{proc.returncode}")
        with open(out) as f:
            res = json.load(f)
        with open(out + ".bare") as f:
            bare = json.load(f)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(res["transformer_losses"], train_losses))
    diff = max(abs(a - b) for a, b in zip(res["resnet_losses"],
                                          resnet_losses))
    log(f"[native] TransformerLM losses {res['transformer_losses']} against "
        f"[train]'s: max relative difference {rel:.2e} (limit "
        f"{NATIVE_TRANSFORMER_RTOL:.0e}); ResNet-50 losses "
        f"{res['resnet_losses']} against [resnet]'s: max difference "
        f"{diff:.2e} (limit {NATIVE_RESNET_ATOL:.0e})")
    for label, ms, ref, host, ref_host in (
            ("TransformerLM", res["transformer_ms"], train_ms[0],
             res["transformer_host_ms"], train_ms[1]),
            ("ResNet-50", res["resnet_ms"], resnet_ms[0],
             res["resnet_host_ms"], resnet_ms[1])):
        log(f"[native] {label} step ms (median of steps 2..5, timeline on) "
            f"{ms:.1f} against {ref:.1f} on the single-process plane: "
            f"{ms - ref:+.1f} ms ({(ms - ref) / ref:+.1%}); [host] median "
            f"(Python timeline off) {host:.1f} against {ref_host:.1f}: "
            f"{host - ref_host:+.1f} ms ({(host - ref_host) / ref_host:+.1%})")
    for label, host, ref_host in (
            ("TransformerLM", bare["transformer_host_ms"], train_ms[1]),
            ("ResNet-50", bare["resnet_host_ms"], resnet_ms[1])):
        log(f"[native] {label} [host] median without any timeline {host:.1f} "
            f"against {ref_host:.1f} on the single-process plane: "
            f"{host - ref_host:+.1f} ms ({(host - ref_host) / ref_host:+.1%})"
            ": the control plane's cost at size 1")
    if len(res["transformer_losses"]) != len(train_losses) or \
            rel > NATIVE_TRANSFORMER_RTOL:
        fail("[native] TransformerLM losses differ from [train]'s")
    if len(res["resnet_losses"]) != len(resnet_losses) or \
            diff > NATIVE_RESNET_ATOL:
        fail("[native] ResNet-50 losses differ from [resnet]'s")
    res["bare"] = bare
    return res["launches"], bare["transformer_host_ms"], res


def native_bare_child(out_path, hvd, hvd_torch, models, train):
    """The steps of ``native_child`` without timelines: 3 warm-up steps,
    then [host], of each model."""
    res = {}
    cfg, model, step, x, y = transformer_setup(hvd, models)
    rmodel, rstep, rx, ry, _ = resnet_setup(hvd_torch, models, train)
    for key, label, run in (
            ("transformer_host_ms", "native TransformerLM step, no timeline",
             lambda: step(model, (x, y))),
            ("resnet_host_ms", "native ResNet-50 step, no timeline",
             lambda: rstep(rmodel, (rx, ry)))):
        for _ in range(3):
            run().item()
        res[key], syncs = host_phase(run, label=label)
        if syncs:
            fail(f"[host] {syncs} calls inside the native steps made the "
                 "host wait for the device")
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


def native_child(out_path, bare=False):
    """The child of ``native_phase`` (run as ``chip_smoke.py --native-child
    OUT [bare]``): rank 0 of a one-rank launcher job on the NCCL-delegated
    plane. Writes its losses, step times, launches and timeline counts to
    OUT; ``bare``, only [host] step times (``native_bare_child``)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch import native as hnative
    os.environ["HVDTPU_PEERS"] = \
        f"127.0.0.1:{hnative.reserve_listen_port()}"
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import _build, basics, models, train
    from horovod_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    hvd.init()
    rt = basics.runtime()
    backend, coord = rt.backend, rt.coordinator
    if rt.mode != basics.MODE_SPMD or backend.name != "nccl-global":
        fail(f"[native] expected a launcher job on the NCCL-delegated plane, "
             f"got mode {rt.mode}, backend {backend.name}")
    if bare:
        native_bare_child(out_path, hvd, hvd_torch, models, train)
        return
    log(f"[native] rank 0 of 1, mode {rt.mode}, backend {backend.name}, "
        f"core {_build.core_path().name}, HVDTPU_PEERS "
        f"{os.environ['HVDTPU_PEERS']}; init {time.perf_counter() - t0:.2f} "
        f"s; fusion threshold {coord.fusion_threshold / 2 ** 20:.0f} MiB, "
        f"cycle {coord.cycle_time_s * 1e3:.1f} ms")

    def counters():
        return (coord.submitted, backend.responses, backend.response_bytes,
                backend.core.cycles(), backend.fusion_copy_bytes,
                coord.busy_s)

    def run_steps(label, step, model, x, y):
        losses, times = [], []
        torch.cuda.synchronize()
        for i in range(TRAIN_STEPS):
            c0 = counters()
            t0 = time.perf_counter()
            loss = step(model, (x, y)).item()   # .item() synchronizes
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            d = [b - a for a, b in zip(c0, counters())]
            log(f"  {label} step {i + 1}: loss {loss:.6f}  "
                f"{times[-1]:.1f} ms  named submissions {d[0]}, fused "
                f"responses {d[1]} ({d[2] / 2 ** 20:.1f} MiB), native cycles "
                f"{d[3]}, fusion-buffer copies {d[4] / 2 ** 20:.1f} MiB, "
                f"cycle thread busy {d[5] * 1e3:.1f} ms")
        return losses, _median(times[1:])

    cfg, model, step, x, y = transformer_setup(hvd, models)
    fa.reset_launches()
    t_losses, t_ms = run_steps("TransformerLM", step, model, x, y)
    launches = {n: fa.LAUNCHES[n] for n in ("fwd", "bwd_dkv", "bwd_dq")}
    log(f"[native] TransformerLM: launches {launches}; step ms (median of "
        f"steps 2..{TRAIN_STEPS}) {t_ms:.1f}")
    if launches != dict.fromkeys(launches, TRAIN_STEPS * cfg.layers):
        fail(f"[native] expected {cfg.layers} launches of each no-dropout "
             f"kernel per step, got {launches}")
    rmodel, rstep, rx, ry, _ = resnet_setup(hvd_torch, models, train)
    r_losses, r_ms = run_steps("ResNet-50", rstep, rmodel, rx, ry)
    log(f"[native] ResNet-50 through the grad hooks: step ms (median of "
        f"steps 2..{TRAIN_STEPS}) {r_ms:.1f}")
    # The counted steps above ran with the Python timeline on; [host] runs
    # without it.
    hvd_torch.stop_timeline()
    t_host, t_sync = host_phase(lambda: step(model, (x, y)),
                                label="native TransformerLM step")
    r_host, r_sync = host_phase(lambda: rstep(rmodel, (rx, ry)),
                                label="native ResNet-50 step")
    if t_sync or r_sync:
        fail(f"[host] {t_sync + r_sync} calls inside the native steps made "
             "the host wait for the device")
    del model, rmodel, step, rstep
    torch.cuda.empty_cache()
    api_phase(hvd_torch, label="[native api]", joined_rank=0)
    rows = A2A_MIB * 2 ** 20 // 4 // 1024
    xa = torch.randn(rows, 1024, device="cuda")
    splits = torch.tensor([rows], dtype=torch.int32, device="cuda")
    a2a = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = hvd_torch.alltoall(xa, splits=splits)
        torch.cuda.synchronize()
        a2a.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(got, xa):
        fail("[native] alltoall through the host plane changed the data")
    a2a_ms = _median(a2a[1:])
    log(f"[native] alltoall of {A2A_MIB} MiB on the card, staged through "
        f"pinned host memory to the native TCP plane and back: median "
        f"{a2a_ms:.2f} ms of 5 (first {a2a[0]:.2f} ms)")
    path = os.environ["HVDTPU_TIMELINE"]
    hvd.shutdown()
    with open(path + ".py.rank0") as f:
        events = json.load(f)
    with open(path + ".rank0") as f:
        native_events = json.load(f)
    grads = {name: {e["args"]["tensor"] for e in events
                    if e["name"] == name and e["ph"] == "B"
                    and e["args"]["tensor"].startswith("grad.")}
             for name in ("NEGOTIATE_ALLREDUCE", "ALLREDUCE")}
    negotiated = sum(e.get("name") == "NEGOTIATE" for e in native_events)
    log(f"[native] timeline {os.path.basename(path)}.py.rank0: "
        f"{len(events)} events, valid JSON; grad.* names with "
        f"NEGOTIATE_ALLREDUCE {len(grads['NEGOTIATE_ALLREDUCE'])}, with "
        f"ALLREDUCE {len(grads['ALLREDUCE'])} (e.g. "
        f"{sorted(grads['ALLREDUCE'])[:2]}); the core's "
        f"{os.path.basename(path)}.rank0: {len(native_events)} events, "
        f"{negotiated} NEGOTIATE")
    if not grads["NEGOTIATE_ALLREDUCE"] or not grads["ALLREDUCE"] \
            or not negotiated:
        fail("[native] the timeline holds no negotiated grad.* allreduce")
    with open(out_path, "w") as f:
        json.dump({"transformer_losses": t_losses, "transformer_ms": t_ms,
                   "resnet_losses": r_losses, "resnet_ms": r_ms,
                   "transformer_host_ms": t_host, "resnet_host_ms": r_host,
                   "launches": launches, "alltoall_ms": a2a_ms}, f)


# [sanitize]: the runtime checkers (analysis/sanitizer.py, the order guard
# of analysis/order_guard.py) on in [native]'s one-rank job.
SANITIZE_ENV = dict(HVDTPU_SANITIZE="1", HOROVOD_TPU_ORDER_CHECK="1")


def sanitize_phase(native_res):
    """Run ``--sanitize-child`` as rank 0 of a one-rank launcher job with
    both checkers on. ``native_res``: [native]'s result (its losses and its
    untimelined [host] step), or None to run the child once more with the
    checkers off as the reference. Returns the kernels' launches."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hvd-sanitize-") as tmp:
        runs = {}
        labels = ["checked"] + (["plain"] if native_res is None else [])
        for label in labels:
            out = os.path.join(tmp, f"{label}.json")
            env = _one_rank_env()
            if label == "checked":
                env.update(SANITIZE_ENV, HOROVOD_TPU_ORDER_CHECK_RECORD=(
                    os.path.join(tmp, "record.{rank}.json")))
            else:
                for k in SANITIZE_ENV:
                    env.pop(k, None)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--sanitize-child", out], env=env, timeout=600)
            if proc.returncode != 0:
                fail(f"[sanitize] the {label} one-rank job exited "
                     f"{proc.returncode}")
            with open(out) as f:
                runs[label] = json.load(f)
    res = runs["checked"]
    ref = native_res if native_res is not None else {
        "transformer_losses": runs["plain"]["losses"],
        "bare": {"transformer_host_ms": runs["plain"]["host_ms"]}}
    ref_host = ref["bare"]["transformer_host_ms"]
    log(f"[sanitize] HVDTPU_SANITIZE=1 HOROVOD_TPU_ORDER_CHECK=1, rank 0 of "
        f"1 on {res['backend']}: locks {res['lock_types']}; losses "
        f"{res['losses']} against [native]'s {ref['transformer_losses']}; "
        f"findings {res['findings']}, shutdown audit {res['leaks']}; record "
        f"of {len(res['record'])} submissions ({res['grads']} gradient "
        f"allreduces), the submitted names in order: "
        f"{res['record'] == res['submitted']}; launches {res['launches']}")
    log(f"[sanitize] cost of the checkers: [host] step ms {res['host_ms']:.1f}"
        f" against {ref_host:.1f} without them "
        f"({res['host_ms'] - ref_host:+.1f} ms, "
        f"{(res['host_ms'] - ref_host) / ref_host:+.1%})")
    bad = []
    if not res["enabled"] or not res["guard"]:
        bad.append("the checkers were not on")
    if res["findings"] or res["leaks"]:
        bad.append(f"findings {res['findings']}, leaks {res['leaks']}")
    if res["record"] != res["submitted"] or not res["grads"]:
        bad.append("the order guard's record is not the submitted names")
    if res["losses"] != ref["transformer_losses"]:
        bad.append("the losses are not bit-equal to [native]'s")
    want = dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"),
                         TRAIN_STEPS * res["layers"])
    if res["launches"] != want:
        bad.append(f"launches {res['launches']}, expected {want}")
    if res["syncs"]:
        bad.append(f"{res['syncs']} calls made the host wait for the device")
    if bad:
        fail("[sanitize] " + "; ".join(bad))
    return res["launches"]


def sanitize_child(out_path):
    """The child of ``sanitize_phase`` (``chip_smoke.py --sanitize-child
    OUT``): [native]'s TransformerLM steps, then [host], with whatever
    checkers the environment turns on. Writes the losses, launches, host
    step, the sanitizer's findings and shutdown audit, and the order
    guard's record beside the names submitted, in order."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch import native as hnative
    os.environ["HVDTPU_PEERS"] = \
        f"127.0.0.1:{hnative.reserve_listen_port()}"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, models
    from horovod_tpu_torch.analysis import sanitizer
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.telemetry import core as telemetry
    hvd.init()
    rt = basics.runtime()
    coord = rt.coordinator
    if rt.mode != basics.MODE_SPMD or rt.backend.name != "nccl-global":
        fail(f"[sanitize] expected a launcher job on the NCCL-delegated "
             f"plane, got mode {rt.mode}, backend {rt.backend.name}")
    submitted = []
    submit = coord.submit

    def logged(entry):
        if entry.name:
            submitted.append(entry.name)
        return submit(entry)

    coord.submit = logged
    cfg, model, step, x, y = transformer_setup(hvd, models)
    fa.reset_launches()
    losses = [step(model, (x, y)).item() for _ in range(TRAIN_STEPS)]
    launches = {n: fa.LAUNCHES[n] for n in ("fwd", "bwd_dkv", "bwd_dq")}
    host_ms, syncs = host_phase(lambda: step(model, (x, y)),
                                label="sanitize TransformerLM step")
    res = {"losses": losses, "launches": launches, "layers": cfg.layers,
           "host_ms": host_ms, "syncs": syncs, "backend": rt.backend.name,
           "enabled": sanitizer.enabled(),
           "guard": coord._order_guard is not None,
           "lock_types": sorted({type(coord._lock).__name__,
                                 type(telemetry.registry()._lock).__name__})}
    record = os.environ.get("HOROVOD_TPU_ORDER_CHECK_RECORD")
    hvd.shutdown()
    res["findings"] = [f.format() for f in sanitizer.findings()]
    res["leaks"] = sanitizer.audit_shutdown()
    res["submitted"] = submitted
    res["record"], res["grads"] = [], 0
    if record:
        with open(record.format(rank=0)) as f:
            seq = json.load(f)["sequence"]
        res["record"] = [e["name"] for e in seq]
        res["grads"] = sum(e["kind"] == "allreduce" for e in seq)
    with open(out_path, "w") as f:
        json.dump(res, f)


# [elastic]: the TransformerLM as an elastic job through the port's own
# launcher (runner/launch.py, the elastic driver) and hvd.elastic. One
# injected collective failure resets the NCCL plane in process; one worker
# exit makes the driver respawn the slot. Losses are held to [train]'s
# (the same batch every step, as [train] trains) and to each other.
ELASTIC_STEPS = 6
ELASTIC_RAISE_STEP = 4   # HorovodInternalError after optimizer.step()
ELASTIC_EXIT_STEP = 5    # os._exit(17) after this step's commit
ELASTIC_RERUN_RTOL = 1e-6


def run_launcher(cmd, cwd, env, timeout):
    """Run the port's launcher; returns (exit code, output). At the time
    limit it gets SIGINT, so that it stops its workers (they run in
    sessions of their own), then SIGKILL; that fails the run."""
    import signal
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
        return proc.returncode, out
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGINT)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        log(out[-8000:])
        fail(f"[elastic] the launcher did not finish in {timeout} s")


def elastic_phase(train_losses, train_ms, native_ms):
    """Start the elastic job and check what its two worker processes
    report (``elastic_child``) and what the driver logged. ``native_ms``
    is [native]'s bare TransformerLM step: the same control plane with one
    grouped reduction instead of the binding's grad hooks."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="hvd-elastic-") as tmp:
        script = os.path.join(tmp, "discover.sh")
        with open(script, "w") as f:
            f.write("#!/bin/sh\necho localhost:1\n")
        os.chmod(script, 0o755)
        out = os.path.join(tmp, "elastic")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
        env.update(PYTHONPATH=here, HVDTPU_LOG_LEVEL="info")
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", "1", "--min-np", "1", "--max-np", "1",
               "--host-discovery-script", script, sys.executable,
               os.path.abspath(__file__), "--elastic-child", out]
        log("[elastic] " + " ".join(cmd[1:5] + ["..."] + cmd[9:11]))
        t0 = time.perf_counter()
        rc, text = run_launcher(cmd, here, env, 900)
        wall = time.perf_counter() - t0
        for line in text.splitlines():
            if "elastic" in line.lower() or "FAILED" in line:
                log("  | " + line[-400:])
        if os.path.exists(out + ".failed"):
            fail("[elastic] a worker failed: "
                 + open(out + ".failed").read())
        if rc != 0:
            fail(f"[elastic] the launcher exited {rc}")
        runs = {}
        for tag in ("first", "respawned"):
            path = f"{out}.{tag}.json"
            if not os.path.exists(path):
                fail(f"[elastic] the {tag} worker process reported nothing")
            with open(path) as f:
                runs[tag] = json.load(f)
    first, second = runs["first"], runs["respawned"]
    versions = sorted({int(v) for v in re.findall(
        r"published version (\d+)", text)})
    log(f"[elastic] launcher exit 0 in {wall:.1f} s; the driver published "
        f"versions {versions}; first process joined "
        f"{first['versions']}, respawned process {second['versions']}")
    if versions != [0, 1, 2] or first["versions"] != [0, 1] \
            or second["versions"] != [2]:
        fail("[elastic] expected elastic versions 0 and 1 (in-process "
             "reset) then 2 (respawn)")
    if "failed (exit 17)" not in text:
        fail("[elastic] the driver did not see the worker's exit 17")
    got = [first["losses"][str(i)] for i in range(1, ELASTIC_EXIT_STEP + 1)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, train_losses))
    log(f"[elastic] losses of steps 1..{ELASTIC_EXIT_STEP} {got} against "
        f"[train]'s: max relative difference {rel:.2e} (limit "
        f"{NATIVE_TRANSFORMER_RTOL:.0e})")
    if len(train_losses) != ELASTIC_EXIT_STEP or \
            rel > NATIVE_TRANSFORMER_RTOL:
        fail("[elastic] losses differ from [train]'s")
    a, b = first["rerun"]
    rerun_rel = abs(a - b) / abs(a)
    log(f"[elastic] step {ELASTIC_RAISE_STEP}: first attempt {a!r}, re-run "
        f"after restore and reset {b!r}: relative difference "
        f"{rerun_rel:.2e} (limit {ELASTIC_RERUN_RTOL:.0e}), bit-equal "
        f"{a == b}")
    if rerun_rel > ELASTIC_RERUN_RTOL:
        fail("[elastic] the re-run step differs from its first attempt")
    re_got = [second["losses"][str(i)]
              for i in range(1, ELASTIC_EXIT_STEP + 1)]
    resp_rel = max(abs(x - y) / abs(y) for x, y in zip(re_got, got))
    log(f"[elastic] respawned process: steps 1..{ELASTIC_STEPS} losses "
        f"{[second['losses'][str(i)] for i in range(1, ELASTIC_STEPS + 1)]};"
        f" steps 1..{ELASTIC_EXIT_STEP} against the first process's: max "
        f"relative difference {resp_rel:.2e}, bit-equal {re_got == got}")
    if resp_rel > ELASTIC_RERUN_RTOL:
        fail("[elastic] the respawned process's losses differ")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[:1]
    except OSError:
        smi = []
    r = first["reset_ms"]
    log(f"[elastic] on {smi[0] if smi else 'an unnamed card'}: commit ms "
        f"(host, median of "
        f"{len(first['commit_ms'])}) {_median(first['commit_ms']):.1f}, "
        f"device {_median(first['commit_device_ms']):.2f}; restore ms "
        f"{first['restore_ms']:.1f}; reset ms {r['total']:.1f} (shutdown "
        f"{r['shutdown']:.1f}: cycle thread {r['cycle']:.1f}, native core "
        f"and process group {r['group_down']:.1f}; init {r['init']:.1f}: "
        f"bootstrap {r['bootstrap']:.1f}, native core and group "
        f"{r['group']:.1f}); sync ms at start "
        f"{first['sync_ms'][0]:.1f}, "
        f"after the reset {first['sync_ms'][1]:.1f}; respawn (exit to the "
        f"new worker's first step) {second['first_step_t'] - first['exit_t']:.1f}"
        f" s; step ms (median of steps 2..{ELASTIC_EXIT_STEP}) "
        f"{_median(first['step_ms'][1:]):.1f} against [train]'s "
        f"{train_ms:.1f} and [native]'s {native_ms:.1f} (one grouped "
        f"reduction, not the grad hooks); first process init "
        f"{first['init_s']:.1f} s")
    for tag, run in runs.items():
        bad = {k: v for k, v in run["launches"].items()
               if v != dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), 24)}
        if bad or not run["launches"]:
            fail(f"[elastic] {tag}: expected 24 launches of each no-dropout "
                 f"kernel per step, got {bad}")
        waits = {k: v for k, v in run["host_waits"].items() if v}
        log(f"[elastic] {tag}: calls that made the host wait for the "
            f"device inside steps, commits and the reset: {waits or 0}")
        if waits:
            fail(f"[elastic] {tag}: {waits} made the host wait for the "
                 "device")
    return {n: sum(run["launches"][s][n] for run in runs.values()
                   for s in run["launches"])
            for n in ("fwd", "bwd_dkv", "bwd_dq")}


def elastic_child(out):
    """One worker process of ``elastic_phase`` (``chip_smoke.py
    --elastic-child OUT``): ``hvd.init()`` through the launcher's
    rendezvous on the card, the TransformerLM under ``TorchState`` and
    ``@hvd.elastic.run``. The first process raises HorovodInternalError
    once during step 4 and exits with 17 after step 5's commit; the
    respawned one trains all 6 steps. Each writes OUT.<first|respawned>.json.
    """
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import basics, models, train
    from horovod_tpu_torch.exceptions import HorovodInternalError
    from horovod_tpu_torch.ops import flash_attention as fa
    first = not os.path.exists(out + ".exited")
    tag = "first" if first else "respawned"

    def child_fail(msg):
        with open(out + ".failed", "w") as f:
            f.write(f"{tag}: {msg}")
        fail(msg)

    versions = []      # the elastic version joined at each init
    resets = []        # basics.LAST_TIMES after each reset
    caught = []        # (window, warnings) while sync debug mode warns

    @contextlib.contextmanager
    def no_host_wait(window):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        caught.append((window, [f"{w.filename}:{w.lineno}" for w in got
                                if "called a synchronizing"
                                in str(w.message)]))

    hvd.init()
    rt = basics.runtime()
    if rt.device.type != "cuda" or rt.backend.name != "nccl-global":
        child_fail(f"hvd.init() landed on {rt.device} with backend "
                   f"{rt.backend.name}, not cuda with nccl-global")
    versions.append(int(os.environ["HVDTPU_ELASTIC_VERSION"]))
    init_s = time.perf_counter() - t_start
    log(f"[elastic] {tag} process: rank {hvd.rank()} of {hvd.size()} on "
        f"{rt.device}, backend {rt.backend.name}, version {versions}, "
        f"init {init_s:.1f} s")

    cfg = models.TransformerConfig(
        vocab_size=30522, hidden=1024, layers=24, heads=16, max_len=512,
        causal=True, use_rope=True, attention_impl="flash")
    # The weights and the batch are drawn as transformer_setup draws them.
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = models.TransformerLM(cfg, device=rt.device, generator=gen)
    x = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len),
                      device="cuda", generator=gen)
    y = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len),
                      device="cuda", generator=gen)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())

    def loss_fn(m, batch):
        logits = m(batch[0])
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), batch[1].reshape(-1))

    step_fn = train.make_train_step(loss_fn, opt)
    # Set-up: the RoPE tables are copied to the card once per process (a
    # host wait), at the first forward unless built here.
    from horovod_tpu_torch.models import transformer as tmod
    tmod._rope_tables(cfg.max_len, cfg.hidden // cfg.heads, rt.device)
    rec = {"versions": versions, "losses": {}, "attempts": [],
           "step_ms": [], "commit_ms": [], "commit_device_ms": [],
           "sync_ms": [], "launches": {}, "init_s": init_s}

    class TimedState(hvd.elastic.TorchState):
        """Times restore and sync; the reset runs under sync debug mode,
        from the end of the restore to the first sync after it."""
        _window = None

        def restore(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().restore()
            torch.cuda.synchronize()
            rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
            self._window = no_host_wait("reset")
            self._window.__enter__()

        def sync(self):
            if self._window is not None:
                self._window.__exit__(None, None, None)
                self._window = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().sync()
            torch.cuda.synchronize()
            rec["sync_ms"].append((time.perf_counter() - t0) * 1e3)

    def after_reset():
        versions.append(int(os.environ["HVDTPU_ELASTIC_VERSION"]))
        resets.append({k: dict(v) for k, v in basics.LAST_TIMES.items()})

    state = TimedState(model, opt, step=0)
    state.register_reset_callbacks([after_reset])

    def write(path_tag):
        rec["host_waits"] = {}
        for window, sites in caught:
            rec["host_waits"].setdefault(window, []).extend(sites)
        if resets:
            down, up = resets[0]["shutdown"], resets[0]["init"]
            rec["reset_ms"] = {
                "total": down["total"] + up["total"],
                "shutdown": down["total"], "cycle": down["coordinator"],
                "group_down": down["backend"], "init": up["total"],
                "bootstrap": up["bootstrap"], "group": up["backend"]}
        with open(f"{out}.{path_tag}.json", "w") as f:
            json.dump(rec, f)

    @hvd.elastic.run
    def train_loop(state):
        while state.step < ELASTIC_STEPS:
            s = state.step + 1
            before = dict(fa.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with no_host_wait(f"step {s}"):
                loss_t = step_fn(model, (x, y))
            loss = loss_t.item()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if not first and s == 1:
                rec["first_step_t"] = time.time()
            rec["launches"][f"{s}.{len(rec['attempts'])}"] = {
                n: fa.LAUNCHES[n] - before[n]
                for n in ("fwd", "bwd_dkv", "bwd_dq")}
            rec["attempts"].append([s, loss])
            log(f"  [elastic] {tag} step {s}: loss {loss:.6f} "
                f"{rec['step_ms'][-1]:.1f} ms")
            if first and s == ELASTIC_RAISE_STEP and \
                    not os.path.exists(out + ".raised"):
                open(out + ".raised", "w").close()
                raise HorovodInternalError(
                    f"injected failure during step {s}, after "
                    "optimizer.step() and before the commit")
            rec["losses"][str(s)] = loss
            state.step = s
            done = torch.cuda.Event(enable_timing=True)
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            with no_host_wait(f"commit {s}"):
                state.commit()
            rec["commit_ms"].append((time.perf_counter() - t0) * 1e3)
            done.record()
            done.synchronize()
            rec["commit_device_ms"].append(start.elapsed_time(done))
            if first and s == ELASTIC_EXIT_STEP:
                attempts = [a[1] for a in rec["attempts"]
                            if a[0] == ELASTIC_RAISE_STEP]
                rec["rerun"] = attempts[:2]
                rec["exit_t"] = time.time()
                write("first")
                open(out + ".exited", "w").close()
                sys.stdout.flush()
                os._exit(17)
        return state.step

    train_loop(state)
    if first:
        child_fail("the first process finished without its exit")
    write("respawned")
    hvd.shutdown()


# [compress]: Horovod's gradient-reduction options in a one-rank launcher
# job on the NCCL-delegated plane. An uncompressed run of the same job is
# the exact-reduction control: its losses equal [native]'s and its
# gradients pass the reduction unchanged (the reduction at one rank is the
# identity). Under int8 or fp8 step 1 equals [native]'s (the reduction
# comes after the loss). One step's gradients are read back where the
# inner optimizer reads them: each must lie within one quantization step
# of its block of the exact gradient, and most must differ from it (the
# quantized result reached .grad). The losses of steps 2-5 must move off
# [native]'s by more than the control's (the quantization reached the
# update) and by at most COMPRESS_LOSS_MOVED of the loss change L1 - Lt:
# the sound int8 and fp8 runs on an H100 move them by at most 1.9e-4 of
# it (PERF.md, [compress]), the control by 0.
COMPRESS_LOSS_MOVED = 2e-3
COMPRESS_LM_STEPS = 5
COMPRESS_ADASUM_STEPS = 3
COMPRESS_TRACE_STEP = 3          # the step whose gradients are checked
COMPRESS_RESNET_RTOL = 2e-2      # fp16/bf16 on the wire vs [resnet]
COMPRESS_SPARSE_RTOL = 1e-6


def check_written_back(pre, post, codec, block):
    """Hold one step's gradients after a quantized reduction at one rank
    (``post``) to the same gradients before it (``pre``). The pipeline
    quantizes blocks of ``block`` elements of each fused response; a
    block of an element lies within ``block - 1`` elements of it, so the
    largest magnitude in the element's tensor over that window bounds the
    block's scale, and the largest of all gradients does where the window
    reaches past the tensor's ends. Returns (the largest error in units of
    that quantization step, elements changed, nonzero elements)."""
    gmax = max(float(a.abs().max()) for a in pre)
    worst, changed, nonzero = 0.0, 0, 0
    for a, b in zip(pre, post):
        a, b = a.reshape(-1).float(), b.reshape(-1).float()
        n = a.numel()
        pad = -n % block
        chunk = F.pad(a.abs(), (0, pad)).view(-1, block).amax(1)
        near = torch.maximum(chunk, torch.maximum(
            F.pad(chunk[1:], (0, 1)), F.pad(chunk[:-1], (1, 0))))
        window = near.repeat_interleave(block)[:n]
        window[:block - 1] = gmax
        window[-(block - 1):] = gmax
        step = window / codec.qmax
        if codec.name == "fp8":
            # e4m3 keeps 3 mantissa bits: one step is at most 1/8 of the
            # element's own magnitude, above the block's subnormal floor.
            step = torch.maximum(step, a.abs() / 8)
        diff = (b - a).abs()
        worst = max(worst, float((diff / step.clamp_min(1e-30)).max()))
        changed += int((diff > 0).sum())
        nonzero += int((a != 0).sum())
    return worst, changed, nonzero


def capture_grads(model):
    """Each parameter's gradient when backward leaves it (before the
    reduction) and when the inner optimizer is about to read it (after the
    reduction wrote it back); returns (pre, post, hooks)."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook
    params = list(model.parameters())
    pre, post = [None] * len(params), []

    def keep(p, i):
        pre[i] = p.grad.detach().clone()

    def read(opt, args, kwargs):
        if not post:
            post.extend(p.grad.detach().clone() for p in params)
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, i=i: keep(p, i)) for i, p in enumerate(params)]
    hooks.append(register_optimizer_step_pre_hook(read))
    return pre, post, hooks


def compress_phase(native_res, resnet_losses):
    """Drive the gradient-reduction options on the card: a child process
    runs as rank 0 of a one-rank launcher job (``--compress-child``) and
    re-initializes between parts with the knobs each needs. Its numbers are
    held here to [native]'s (TransformerLM losses and step) and [resnet]'s
    (ResNet-50 losses). Returns the flash kernels' launches of its
    TransformerLM runs."""
    import socket
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hvd-compress-") as tmp:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            master = sock.getsockname()[1]
        env = dict(os.environ, HVDTPU_RANK="0", HVDTPU_SIZE="1",
                   HVDTPU_LOCAL_RANK="0", HVDTPU_LOCAL_SIZE="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))
        out = os.path.join(tmp, "compress.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--compress-child",
             out], env=env, timeout=900)
        if proc.returncode != 0:
            fail(f"[compress] the one-rank launcher job exited "
                 f"{proc.returncode}")
        with open(out) as f:
            res = json.load(f)
    ref = native_res["transformer_losses"]
    launches = {}

    def steps_beside(ms, model):
        """[native]'s step of ``model`` with its timelines (counted steps)
        and without any ([host] median), and ``ms`` minus each."""
        on = native_res[f"{model}_ms"]
        off = native_res["bare"][f"{model}_host_ms"]
        return (f"{on:.1f} with timelines ({ms - on:+.1f} ms), {off:.1f} "
                f"without ({ms - off:+.1f} ms)")

    def moved(got):
        """How far steps 2.. moved off [native]'s, in units of its loss
        change L1 - Lt."""
        return [abs(g - w) / max(abs(ref[0] - w), 1e-30)
                for g, w in zip(got[1:], ref[1:])]

    def check_lm(label, r):
        if r["per_step_launches"] != [dict.fromkeys(
                ("fwd", "bwd_dkv", "bwd_dq"), 24)] * len(r["losses"]):
            fail(f"[compress] {label}: expected 24 launches of each "
                 f"no-dropout kernel per step: {r['per_step_launches']}")
        if r["host_waits"]:
            fail(f"[compress] {label}: {r['host_waits']} calls made the host "
                 "wait for the device")
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c

    exact = res["exact"]
    control = moved(exact["losses"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(exact["losses"], ref))
    g = exact["grads"]
    log(f"[compress] exact-reduction control (no compression): losses "
        f"{exact['losses']}: max relative difference to [native]'s "
        f"{rel:.2e} (limit {NATIVE_TRANSFORMER_RTOL:.0e}); steps 2..5 moved "
        f"{', '.join(f'{m:.2e}' for m in control)} of L1-Lt; step "
        f"{COMPRESS_TRACE_STEP}: {g['changed']} of {g['nonzero']} nonzero "
        f"gradient elements changed by the reduction; device time of one "
        f"step {exact['device_ms']:.2f} ms")
    if len(exact["losses"]) != COMPRESS_LM_STEPS or \
            rel > NATIVE_TRANSFORMER_RTOL or g["changed"] or \
            not g["nonzero"]:
        fail("[compress] the uncompressed control differs from [native]")
    check_lm("control", exact)
    for codec in ("int8", "fp8"):
        r = res[codec]
        got = r["losses"]
        step1 = abs(got[0] - ref[0]) / abs(ref[0])
        m = moved(got)
        g = r["grads"]
        log(f"[compress] {codec}: losses {got} against [native]'s {ref}: "
            f"step 1 relative difference {step1:.2e} (limit "
            f"{NATIVE_TRANSFORMER_RTOL:.0e}); steps 2..5 moved "
            f"{', '.join(f'{v:.2e}' for v in m)} of the loss change L1-Lt "
            f"(limits: above the control's {max(control):.2e}, at most "
            f"{COMPRESS_LOSS_MOVED:.0e})")
        log(f"[compress] {codec}: step {COMPRESS_TRACE_STEP}'s gradients as "
            f"the optimizer read them: largest error {g['worst']:.3f} "
            f"quantization steps of the exact gradient (limit 1); "
            f"{g['changed']} of {g['nonzero']} nonzero elements changed "
            f"(limit: at least half)")
        added = r["device_ms"] - exact["device_ms"]
        log(f"[compress] {codec}: {r['responses']} quantized responses per "
            f"step, {r['bytes'] / 2 ** 20:.1f} MiB of gradients; wire bytes "
            f"{r['wire_bytes'] / 2 ** 20:.1f} MiB = {r['wire_ratio']:.4f} of "
            f"fp32's; device time of one step {r['device_ms']:.2f} ms "
            f"against the control's {exact['device_ms']:.2f}: the pipeline "
            f"(quantize/dequantize passes, size-1 all-to-all and allgather) "
            f"adds {added:.2f} ms; most added: "
            + ", ".join(f"{k[:60]} {v:+.2f} ms" for k, v in r["added"])
            + f"; step ms (median of steps 2..5) {r['step_ms']:.1f} against "
            f"[native]'s {steps_beside(r['step_ms'], 'transformer')}; calls "
            f"that made the host wait {r['host_waits']}")
        if len(got) != COMPRESS_LM_STEPS or step1 > NATIVE_TRANSFORMER_RTOL:
            fail(f"[compress] {codec}: step 1 loss differs from [native]'s")
        if not all(math.isfinite(v) for v in got) or not got[-1] < got[0]:
            fail(f"[compress] {codec}: losses did not descend: {got}")
        if not max(control) < max(m) <= COMPRESS_LOSS_MOVED:
            fail(f"[compress] {codec}: losses not moved by the quantization "
                 "within the limit")
        if not g["worst"] <= 1.0 or not 2 * g["changed"] >= g["nonzero"] \
                or not g["nonzero"]:
            fail(f"[compress] {codec}: the gradients the optimizer read are "
                 "not the quantized reduction")
        if not r["responses"]:
            fail(f"[compress] {codec}: no response ran the quantized "
                 "pipeline")
        check_lm(codec, r)
    for codec in ("fp16", "bf16"):
        r = res[codec]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                      resnet_losses))
        log(f"[compress] ResNet-50 {codec} through the binding's "
            f"DistributedOptimizer: losses {r['losses']}; max relative "
            f"difference to [resnet]'s {rel:.2e} (limit "
            f"{COMPRESS_RESNET_RTOL:.0e}); step ms (median of steps 2..5) "
            f"{r['step_ms']:.1f} against [native]'s ResNet-50 step "
            f"{steps_beside(r['step_ms'], 'resnet')}")
        if rel > COMPRESS_RESNET_RTOL or not r["losses"][-1] < \
                r["losses"][0]:
            fail(f"[compress] ResNet-50 {codec}: losses off [resnet]'s")
    r = res["adasum"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
    log(f"[compress] Adasum: losses {r['losses']} against [native]'s: max "
        f"relative difference {rel:.2e} (limit "
        f"{NATIVE_TRANSFORMER_RTOL:.0e}); staging copies of one step: "
        f"device to host {r['d2h_ms']:.2f} ms, host to device "
        f"{r['h2d_ms']:.2f} ms of device time, "
        f"{r['staged_bytes'] / 2 ** 30:.2f} GiB each way; device time of "
        f"one step {r['device_ms']:.2f} ms; step ms (median of steps "
        f"2..{COMPRESS_ADASUM_STEPS}) {r['step_ms']:.1f} against "
        f"[native]'s {steps_beside(r['step_ms'], 'transformer')}")
    if len(r["losses"]) != COMPRESS_ADASUM_STEPS or \
            rel > NATIVE_TRANSFORMER_RTOL:
        fail("[compress] Adasum losses differ from [native]'s")
    check_lm("Adasum", r)
    for path in ("gather", "dense"):
        r = res["sparse_" + path]
        log(f"[compress] sparse embedding gradient, HVDTPU_SPARSE={path}: "
            f"{r['nnz_rows']} of {r['rows']} rows touched (density "
            f"{r['density']:.4f}); path taken {r['path']}; bytes handed to "
            f"the collectives {r['collective_bytes'] / 2 ** 20:.2f} MiB "
            f"(dense table {r['table_bytes'] / 2 ** 20:.2f} MiB); "
            f"{r['ms']:.2f} ms; relative error against the dense gradient "
            f"{r['rel_err']:.2e} (binding), {r['ops_rel_err']:.2e} "
            f"(ops.sparse_allreduce) (limit {COMPRESS_SPARSE_RTOL:.0e})")
        if max(r["rel_err"], r["ops_rel_err"]) > COMPRESS_SPARSE_RTOL \
                or r["path"] != path:
            fail(f"[compress] sparse {path}: differs from the dense "
                 "gradient")
    return launches


def compress_child(out_path):
    """The child of ``compress_phase`` (``chip_smoke.py --compress-child
    OUT``): rank 0 of a one-rank launcher job on the NCCL-delegated plane,
    re-initialized for each part with its knobs. Writes its results to
    OUT."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import socket
    from horovod_tpu_torch import native as hnative
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import basics, models, train
    from horovod_tpu_torch.compression import codecs
    from horovod_tpu_torch.ops import flash_attention as fa
    res = {}

    def start(**knobs):
        """(Re)start the one-rank job with ``knobs`` (HVDTPU_ names, None
        unsets) on a fresh native-core listener and process-group port."""
        hvd.shutdown()
        for k, v in knobs.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        os.environ["HVDTPU_PEERS"] = \
            f"127.0.0.1:{hnative.reserve_listen_port()}"
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            os.environ["MASTER_PORT"] = str(sock.getsockname()[1])
        hvd.init()
        rt = basics.runtime()
        if rt.mode != basics.MODE_SPMD or rt.backend.name != "nccl-global":
            fail(f"[compress] expected a launcher job on the NCCL-delegated "
                 f"plane, got {rt.mode}, {rt.backend.name}")
        log(f"[compress] rank 0 of 1, backend {rt.backend.name}, knobs "
            f"{ {k: v for k, v in knobs.items() if v is not None} }")
        return rt.backend

    def host_waits(fn):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [f"{w.filename}:{w.lineno}" for w in got
                     if "called a synchronizing" in str(w.message)]

    def lm_run(label, steps, counters=None, trace=None, **opt_kw):
        """``steps`` counted TransformerLM steps, then one more under the
        profiler (its device time). ``counters()`` is read around each
        counted step; ``trace(pre, post)`` checks the gradients of step
        COMPRESS_TRACE_STEP."""
        cfg, model, step, x, y = transformer_setup(hvd, models, **opt_kw)
        # The RoPE tables are built once per process, at set-up, not in a
        # counted step (their copy from the host waits for the device).
        from horovod_tpu_torch.models import transformer as tmod
        tmod._rope_tables(cfg.max_len, cfg.hidden // cfg.heads, hvd.device())
        fa.reset_launches()
        losses, times, per_step, waits, counts = [], [], [], [], []
        checked = None
        for i in range(steps):
            torch.cuda.synchronize()
            prev = dict(fa.LAUNCHES)
            c0 = counters() if counters else ()
            armed = (capture_grads(model) if trace and
                     i + 1 == COMPRESS_TRACE_STEP else None)
            t0 = time.perf_counter()
            loss, w = host_waits(lambda: step(model, (x, y)))
            loss = loss.item()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            losses.append(loss)
            waits += w
            per_step.append({n: fa.LAUNCHES[n] - prev[n] for n in
                             ("fwd", "bwd_dkv", "bwd_dq")})
            if counters:
                counts.append([b - a for a, b in zip(c0, counters())])
            if armed:
                pre, post, hooks = armed
                for h in hooks:
                    h.remove()
                checked = trace(pre, post)
                del pre, post, armed
            log(f"  [compress] {label} step {i + 1}: loss {loss:.6f}  "
                f"{times[-1]:.1f} ms  launches {per_step[-1]}"
                + (f"  counters {counts[-1]}" if counters else ""))
        for site in sorted(set(waits)):
            log(f"  [compress] {label}: x{waits.count(site)} host wait at "
                f"{site}")
        launched = {n: fa.LAUNCHES[n] for n in ("fwd", "bwd_dkv", "bwd_dq")}
        kernels = device_kernels(lambda: step(model, (x, y)).item())
        del model, step
        torch.cuda.empty_cache()
        return {"losses": losses, "step_ms": _median(times[1:]),
                "launches": launched, "per_step_launches": per_step,
                "host_waits": len(waits), "counts": counts,
                "grads": checked, "kernels": kernels,
                "device_ms": sum(ms for _, ms, _ in kernels)}

    def grads_check(codec=None, block=None):
        def trace(pre, post):
            if codec is None:
                changed = sum(int((a != b).sum()) for a, b in zip(pre, post))
                worst = 0.0
                nonzero = sum(int((a != 0).sum()) for a in pre)
            else:
                worst, changed, nonzero = check_written_back(pre, post,
                                                             codec, block)
            return {"worst": worst, "changed": changed, "nonzero": nonzero}
        return trace

    # -- the exact-reduction control, then the catch-all wire rule -------
    start(HVDTPU_COMPRESSION=None)
    r = lm_run("control", COMPRESS_LM_STEPS, trace=grads_check())
    res["exact"] = r
    exact_kernels = {k: ms for k, ms, _ in r.pop("kernels")}
    for codec in ("int8", "fp8"):
        backend = start(HVDTPU_COMPRESSION=codec)
        c = codecs.get_codec(codec)
        r = lm_run(codec, COMPRESS_LM_STEPS, counters=lambda b=backend: (
            b.quantized_responses, b.quantized_bytes,
            b.quantized_wire_bytes),
            trace=grads_check(c, backend._q_block))
        per = list(zip(*r.pop("counts")))
        mine = {}
        for k, ms, _ in r.pop("kernels"):
            mine[k] = mine.get(k, 0.0) + ms
        added = {k: ms - exact_kernels.get(k, 0.0) for k, ms in mine.items()}
        for k, ms in exact_kernels.items():
            added.setdefault(k, -ms)
        r.update(responses=_median(per[0]), bytes=_median(per[1]),
                 wire_bytes=_median(per[2]),
                 wire_ratio=_median(per[2]) / max(_median(per[1]), 1),
                 added=sorted(added.items(), key=lambda kv: -kv[1])[:3])
        res[codec] = r

    # -- cast compressors through the binding, Adasum, sparse gather -------
    backend = start(HVDTPU_COMPRESSION=None, HVDTPU_SPARSE="gather")
    for codec in ("fp16", "bf16"):
        rmodel, rstep, rx, ry, _ = resnet_setup(
            hvd_torch, models, train,
            compression=getattr(hvd_torch.Compression, codec))
        losses, times = [], []
        for i in range(RESNET_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(rstep(rmodel, (rx, ry)).item())
            times.append((time.perf_counter() - t0) * 1e3)
            log(f"  [compress] ResNet-50 {codec} step {i + 1}: loss "
                f"{losses[-1]:.6f}  {times[-1]:.1f} ms")
        res[codec] = {"losses": losses, "step_ms": _median(times[1:])}
        del rmodel, rstep
        torch.cuda.empty_cache()

    r = lm_run("Adasum", COMPRESS_ADASUM_STEPS, op=hvd.Adasum)
    kernels = r.pop("kernels")
    r.update(d2h_ms=sum(ms for k, ms, _ in kernels
                        if k.startswith("Memcpy DtoH")),
             h2d_ms=sum(ms for k, ms, _ in kernels
                        if k.startswith("Memcpy HtoD")),
             staged_bytes=sum(b.numel() * b.element_size()
                              for bufs in backend._pinned.values()
                              for b in bufs))
    res["adasum"] = r

    def sparse_run(path, backend):
        gen = torch.Generator(device="cuda").manual_seed(0)
        emb = torch.nn.Embedding(30522, 1024, sparse=True, device="cuda")
        with torch.no_grad():
            emb.weight.copy_(torch.randn(emb.weight.shape, device="cuda",
                                         generator=gen))
        dense = torch.nn.Embedding(30522, 1024, device="cuda")
        dense.load_state_dict(emb.state_dict())
        ids = torch.randint(0, 30522, (TRAIN_BATCH, 512), device="cuda",
                            generator=gen)
        for m in (emb, dense):
            m(ids).square().mean().backward()
        want = dense.weight.grad
        grad = emb.weight.grad
        nnz = int(grad.coalesce().indices().shape[1])
        plane = basics.runtime().coordinator._sparse
        counts = dict(plane.path_counts)
        torch.cuda.synchronize()
        b0 = backend.response_bytes
        t0 = time.perf_counter()
        got = hvd_torch.synchronize(hvd_torch.sparse_allreduce_async(
            grad, name=f"emb.{path}"))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        moved = backend.response_bytes - b0
        taken = [p for p in ("gather", "dense")
                 if plane.path_counts[p] > counts[p]]
        got = got.to_dense() if got.is_sparse else got
        ops = hvd.sparse_allreduce(hvd.SparseGradient.from_coo(grad),
                                   name=f"emb.ops.{path}")
        torch.cuda.synchronize()

        def rel(a):
            return float((a - want).norm() / want.norm())
        return {"nnz_rows": nnz, "rows": 30522, "density": nnz / 30522,
                "path": taken[0] if len(taken) == 1 else str(taken),
                "collective_bytes": moved,
                "table_bytes": want.numel() * want.element_size(),
                "ms": ms, "rel_err": rel(got), "ops_rel_err": rel(ops)}
    res["sparse_gather"] = sparse_run("gather", backend)
    backend = start(HVDTPU_SPARSE="dense")
    res["sparse_dense"] = sparse_run("dense", backend)
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


# [zero]: ZeRO-1 (HVDTPU_ZERO, horovod_tpu_torch/ops/zero.py) in a one-rank
# launcher job: the gradients reduce-scatter into the rank's shard, the
# inner AdamW steps the shard, and the new parameters allgather back, every
# leg a named collective the native core negotiates and NCCL executes.
ZERO_STEPS = 5
ZERO_CODEC_STEPS = 3
ZERO_LOSS_RTOL = 1e-6     # [zero]'s losses against [native]'s
ZERO_PARAM_RTOL = 1e-6    # final parameters against the replicated run's,
#                           of the largest |parameter|
ZERO_CODEC_RTOL = 1e-5    # a compressed run's step 1 against [zero]'s
ZERO_STATE_RTOL = 1e-2    # state bytes at n = 1 against the replicated


def zero_verdict(res, native_losses):
    """The checks of ``zero_child``'s results against [native]'s
    TransformerLM losses: the failures, none when every check holds."""
    bad = []
    z, rep = res["zero"], res["replicated"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(z["losses"],
                                                  native_losses))
    if len(z["losses"]) != ZERO_STEPS or rel > ZERO_LOSS_RTOL:
        bad.append(f"losses {z['losses']} differ from [native]'s "
                   f"{native_losses} (relative {rel:.2e})")
    if not z["param_max_abs"] <= ZERO_PARAM_RTOL * z["param_max"]:
        bad.append(f"final parameters differ from the replicated run's by "
                   f"{z['param_max_abs']:.3e}")
    if abs(z["state_bytes"] - rep["state_bytes"]) > \
            ZERO_STATE_RTOL * rep["state_bytes"]:
        bad.append(f"state bytes {z['state_bytes']} at n = 1 against the "
                   f"replicated {rep['state_bytes']}")
    if z["host_waits"] or rep["host_waits"]:
        bad.append(f"{z['host_waits'] + rep['host_waits']} calls made the "
                   "host wait for the device")
    if not z["chunks"] or min(z["responses"]) < 2 * z["chunks"]:
        bad.append(f"{z['chunks']} chunks but {z['responses']} responses "
                   "per step: the legs did not run through the core")
    for label, run in res.items():
        want = [dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), 24)] * len(
            run["per_step_launches"])
        if not run["per_step_launches"] or run["per_step_launches"] != want:
            bad.append(f"{label}: expected 24 launches of each no-dropout "
                       f"kernel per step: {run['per_step_launches']}")
        if not all(math.isfinite(v) for v in run["losses"]) or \
                not run["losses"][-1] < run["losses"][0]:
            bad.append(f"{label}: losses did not descend: {run['losses']}")
    for codec in ("bf16", "int8"):
        got = res[codec]["losses"]
        rel = abs(got[0] - z["losses"][0]) / abs(z["losses"][0])
        if len(got) != ZERO_CODEC_STEPS or rel > ZERO_CODEC_RTOL:
            bad.append(f"{codec}: step 1 loss {got[0]} differs from the "
                       f"uncompressed {z['losses'][0]} ({rel:.2e})")
    return bad


def zero_phase(native_res):
    """Drive ZeRO-1 on the card: a child process runs as rank 0 of a
    one-rank launcher job (``--zero-child``), a replicated control run, then
    the TransformerLM under ``HVDTPU_ZERO=1``, then with ``Compression.bf16``
    and ``int8`` legs. Its numbers are held here to [native]'s losses and to
    the control run. Returns the flash kernels' launches of its runs."""
    import socket
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hvd-zero-") as tmp:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            master = sock.getsockname()[1]
        env = dict(os.environ, HVDTPU_RANK="0", HVDTPU_SIZE="1",
                   HVDTPU_LOCAL_RANK="0", HVDTPU_LOCAL_SIZE="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))
        out = os.path.join(tmp, "zero.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--zero-child",
             out], env=env, timeout=900)
        if proc.returncode != 0:
            fail(f"[zero] the one-rank launcher job exited "
                 f"{proc.returncode}")
        with open(out) as f:
            res = json.load(f)
    ref = native_res["transformer_losses"]
    bare = native_res["bare"]["transformer_host_ms"]
    z, rep = res["zero"], res["replicated"]
    gib = 2 ** 30
    log(f"[zero] losses {z['losses']} against [native]'s {ref}: max "
        f"relative difference "
        f"{max(abs(a - b) / abs(b) for a, b in zip(z['losses'], ref)):.2e} "
        f"(limit {ZERO_LOSS_RTOL:.0e}); final parameters against the "
        f"replicated run's: max |difference| {z['param_max_abs']:.3e} "
        f"(limit {ZERO_PARAM_RTOL:.0e} of max |p| {z['param_max']:.3g})")
    log(f"[zero] {z['buckets']} buckets (largest {z['largest_bucket'] / 2 ** 20:.1f} "
        f"MiB, HVDTPU_ZERO_BUCKET_BYTES default 16 MiB); per step: "
        f"{z['submissions']} grouped submissions (reduce-scatter, "
        f"allgather, loss) of {z['chunks']} chunks each (zero.rs.<c>, "
        f"zero.ag.<c>: the buckets fused under the {z['fusion_mib']:.0f} "
        f"MiB fusion threshold), responses {z['responses']} "
        f"({_median(z['response_bytes']) / gib:.2f} GiB), native cycles "
        f"{z['cycles']}, cycle thread busy ms {_median(z['busy_ms']):.1f}; "
        f"replicated per step: responses {rep['responses']}, cycle thread "
        f"busy ms {_median(rep['busy_ms']):.1f}")
    log(f"[zero] state bytes {z['state_bytes'] / gib:.3f} GiB against the "
        f"replicated AdamW state's {rep['state_bytes'] / gib:.3f} GiB (n = "
        f"1: the whole vector); peak memory allocated "
        f"{z['peak'] / gib:.2f} GiB against {rep['peak'] / gib:.2f} "
        f"({(z['peak'] - rep['peak']) / gib:+.2f} GiB; the shards "
        f"{z['shard_bytes'] / gib:.2f} GiB)")
    log(f"[zero] step ms (median of steps 2..{ZERO_STEPS}) {z['step_ms']:.1f}"
        f" against the replicated run's {rep['step_ms']:.1f}; [host] median "
        f"{z['host_ms']:.1f} against the replicated {rep['host_ms']:.1f} "
        f"({z['host_ms'] - rep['host_ms']:+.1f} ms) and [native]'s without "
        f"timelines {bare:.1f} ({z['host_ms'] - bare:+.1f} ms); device time "
        f"of one step {z['device_ms']:.2f} ms against {rep['device_ms']:.2f};"
        f" calls that made the host wait: {z['host_waits']} (replicated "
        f"{rep['host_waits']})")
    for codec in ("bf16", "int8"):
        r = res[codec]
        log(f"[zero] {codec} legs: losses {r['losses']} (step 1 relative "
            f"difference to [zero]'s "
            f"{abs(r['losses'][0] - z['losses'][0]) / abs(z['losses'][0]):.2e}"
            f", limit {ZERO_CODEC_RTOL:.0e}); step ms (median of steps "
            f"2..{ZERO_CODEC_STEPS}) {r['step_ms']:.1f}; reduce-scatter leg "
            f"{r['rs_ms']:.2f} ms, allgather leg {r['ag_ms']:.2f} ms (one "
            f"step, synchronized around each); device time of one step "
            f"{r['device_ms']:.2f} ms; host waits {r['host_waits']}"
            + (f"; staged alltoall: {r['staged_bytes'] / gib:.3f} GiB each "
               f"way through pinned host memory, device to host "
               f"{r['d2h_ms']:.2f} ms, host to device {r['h2d_ms']:.2f} ms "
               f"of device time" if codec == "int8" else ""))
    bad = zero_verdict(res, ref)
    if bad:
        fail("[zero] " + "; ".join(bad))
    launches = {}
    for run in res.values():
        for n, c in run["launches"].items():
            launches[n] = launches.get(n, 0) + c
    return launches, z


def zero_child(out_path):
    """The child of ``zero_phase`` (``chip_smoke.py --zero-child OUT``): rank
    0 of a one-rank launcher job on the NCCL-delegated plane. Writes its
    results to OUT."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch import native as hnative
    os.environ["HVDTPU_PEERS"] = \
        f"127.0.0.1:{hnative.reserve_listen_port()}"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, models
    from horovod_tpu_torch.models import transformer as tmod
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    rt = basics.runtime()
    backend, coord = rt.backend, rt.coordinator
    if rt.mode != basics.MODE_SPMD or backend.name != "nccl-global":
        fail(f"[zero] expected a launcher job on the NCCL-delegated plane, "
             f"got {rt.mode}, {backend.name}")
    log(f"[zero] rank 0 of 1, backend {backend.name}")
    res, kept = {}, {}

    def counters():
        return (coord.submitted, backend.responses, backend.response_bytes,
                backend.core.cycles(), coord.busy_s)

    def host_waits(fn):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [f"{w.filename}:{w.lineno}" for w in got
                     if "called a synchronizing" in str(w.message)]

    def run(label, steps, zero, host=False, **opt_kw):
        if zero:
            os.environ["HVDTPU_ZERO"] = "1"
        else:
            os.environ.pop("HVDTPU_ZERO", None)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, model, step, x, y = transformer_setup(hvd, models, **opt_kw)
        opt = step.optimizer
        if opt.zero != zero:
            fail(f"[zero] {label}: HVDTPU_ZERO did not select the mode")
        tmod._rope_tables(cfg.max_len, cfg.hidden // cfg.heads, hvd.device())
        fa.reset_launches()
        r = {"losses": [], "per_step_launches": [], "responses": [],
             "response_bytes": [], "cycles": [], "busy_ms": []}
        times, waits = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            prev, c0 = dict(fa.LAUNCHES), counters()
            t0 = time.perf_counter()
            loss, w = host_waits(lambda: step(model, (x, y)))
            loss = loss.item()
            times.append((time.perf_counter() - t0) * 1e3)
            d = [b - a for a, b in zip(c0, counters())]
            waits += w
            r["losses"].append(loss)
            r["per_step_launches"].append(
                {n: fa.LAUNCHES[n] - prev[n]
                 for n in ("fwd", "bwd_dkv", "bwd_dq")})
            r["submissions"] = d[0]
            r["responses"].append(d[1])
            r["response_bytes"].append(d[2])
            r["cycles"].append(d[3])
            r["busy_ms"].append(d[4] * 1e3)
            log(f"  [zero] {label} step {i + 1}: loss {loss:.6f}  "
                f"{times[-1]:.1f} ms  launches {r['per_step_launches'][-1]}"
                f"  submissions {d[0]}, responses {d[1]} "
                f"({d[2] / 2 ** 20:.1f} MiB), native cycles {d[3]}, cycle "
                f"thread busy {d[4] * 1e3:.1f} ms")
        for site in sorted(set(waits)):
            log(f"  [zero] {label}: x{waits.count(site)} host wait at "
                f"{site}")
        r.update(step_ms=_median(times[1:]), host_waits=len(waits),
                 peak=torch.cuda.max_memory_allocated(),
                 launches={n: fa.LAUNCHES[n]
                           for n in ("fwd", "bwd_dkv", "bwd_dq")})
        zrt = opt._zero_rt
        if zero:
            r.update(state_bytes=zrt.state_bytes(),
                     buckets=len(zrt.plan.buckets), chunks=len(zrt.chunks),
                     fusion_mib=coord.fusion_threshold / 2 ** 20,
                     largest_bucket=max(b.nbytes for b in zrt.plan.buckets),
                     shard_bytes=sum(s.numel() * s.element_size()
                                     for s in zrt.shards))
        else:
            r["state_bytes"] = sum(
                v.numel() * v.element_size()
                for st in opt.inner.state.values() for v in st.values()
                if torch.is_tensor(v))
        return r, model, step, x, y

    def finish(r, model, step, x, y):
        kernels = device_kernels(lambda: step(model, (x, y)).item())
        r["device_ms"] = sum(ms for _, ms, _ in kernels)
        return kernels

    # -- the replicated control, then ZeRO ------------------------------
    for label, zero in (("replicated", False), ("zero", True)):
        r, model, step, x, y = run(label, ZERO_STEPS, zero)
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()]).cpu()
        if zero:
            want = kept.pop("params")
            r["param_max_abs"] = float((flat - want).abs().max())
            r["param_max"] = float(want.abs().max())
        else:
            kept["params"] = flat
        del flat
        r["host_ms"], _ = host_phase(lambda: step(model, (x, y)),
                                     label=f"[zero] {label} step")
        finish(r, model, step, x, y)
        res[label] = r
        del model, step

    # -- compressed legs -------------------------------------------------
    for codec in ("bf16", "int8"):
        r, model, step, x, y = run(
            codec, ZERO_CODEC_STEPS, True,
            compression=getattr(hvd.Compression, codec))
        kernels = finish(r, model, step, x, y)
        r.update(d2h_ms=sum(ms for k, ms, _ in kernels
                            if k.startswith("Memcpy DtoH")),
                 h2d_ms=sum(ms for k, ms, _ in kernels
                            if k.startswith("Memcpy HtoD")))
        zrt = step.optimizer._zero_rt
        r["staged_bytes"] = sum(f.numel() * (1 + 4 / zrt.block)
                                for f in zrt._flat) if zrt.block else 0
        # One more step with each leg timed on its own, the device
        # synchronized around it.
        legs = {}
        for name in ("_reduce_scatter", "_gather"):
            def timed(*a, _f=getattr(zrt, name), _n=name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _f(*a)
                torch.cuda.synchronize()
                legs[_n] = (time.perf_counter() - t0) * 1e3
                return out
            setattr(zrt, name, timed)
        step(model, (x, y)).item()
        r.update(rs_ms=legs["_reduce_scatter"], ag_ms=legs["_gather"])
        res[codec] = r
        del model, step, zrt
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


CKPT_STEPS = 5             # the control run; the checkpoint after step 3
CKPT_AT = 3
CKPT_LOSS_RTOL = 1e-6      # restored steps 4-5 against the control's
CKPT_TIMEOUT_S = "60"      # HVDTPU_COLLECTIVE_TIMEOUT: the watchdog armed


def _one_rank_env(**extra):
    """The environment of a one-rank launcher job on a fresh port."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        master = sock.getsockname()[1]
    return dict(os.environ, HVDTPU_RANK="0", HVDTPU_SIZE="1",
                HVDTPU_LOCAL_RANK="0", HVDTPU_LOCAL_SIZE="1",
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master), **extra)


def ckpt_verdict(res):
    """The checks of ``[ckpt]``'s two jobs: the failures, none when every
    check holds."""
    bad = []
    ctl, save, rest = res["control"], res["save"], res["restore"]
    want = ctl["losses"][CKPT_AT:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(rest["losses"], want)) \
        if len(rest["losses"]) == len(want) else float("inf")
    if rel > CKPT_LOSS_RTOL:
        bad.append(f"restored steps {rest['losses']} against the control's "
                   f"{want} (relative {rel:.2e})")
    if save["losses"] != ctl["losses"][:CKPT_AT]:
        bad.append(f"the saving run's steps {save['losses']} are not the "
                   f"control's {ctl['losses'][:CKPT_AT]}")
    if rest["param_max_abs"] != 0.0:
        bad.append(f"final parameters differ from the control's by "
                   f"{rest['param_max_abs']:.3e}")
    if not rest["verified"]:
        bad.append(f"verify_checkpoint: {rest['verify_reason']}")
    if rest["restored_step"] != CKPT_AT or rest["kept"] != [CKPT_AT]:
        bad.append(f"restored step {rest['restored_step']}, kept "
                   f"{rest['kept']} (HVDTPU_CHECKPOINT_KEEP=1)")
    for label, run in res.items():
        want_l = [dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), 24)] * len(
            run["per_step_launches"])
        if not run["per_step_launches"] or run["per_step_launches"] != \
                want_l:
            bad.append(f"{label}: expected 24 launches of each no-dropout "
                       f"kernel per step: {run['per_step_launches']}")
        if run["host_waits"]:
            bad.append(f"{label}: {run['host_waits']} calls made the host "
                       "wait for the device")
        if not run["watchdog"]:
            bad.append(f"{label}: the watchdog was not armed")
        if not all(math.isfinite(v) for v in run["losses"]):
            bad.append(f"{label}: losses not finite: {run['losses']}")
    return bad


def ckpt_phase(zero_res):
    """Drive the crash-safe checkpoint on the card: ZeRO-1 AdamW on the
    TransformerLM in a one-rank launcher job with the stuck-collective
    watchdog armed; 5 steps as a control, then 3 steps and
    ``checkpoint.save_step`` (``HVDTPU_CHECKPOINT_KEEP=1``); a new launcher
    job restores the newest step and runs steps 4 and 5, held to the
    control's losses and final parameters. Returns the flash kernels'
    launches of its runs."""
    import shutil
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hvd-ckpt-") as tmp:
        # The checkpoint holds the parameters and both AdamW moments in
        # float32, and the control's parameters are kept beside it.
        need = 5 * 364_000_000 * 4
        free = shutil.disk_usage(tmp).free
        if free < 1.5 * need:
            fail(f"[ckpt] {tmp} has {free / 1e9:.1f} GB free; the phase "
                 f"writes about {need / 1e9:.1f} GB")
        log(f"[ckpt] {tmp}: {free / 1e9:.1f} GB free")
        res = {}
        for part in ("save", "restore"):
            out = os.path.join(tmp, f"{part}.json")
            env = _one_rank_env(HVDTPU_COLLECTIVE_TIMEOUT=CKPT_TIMEOUT_S,
                                HVDTPU_CHECKPOINT_KEEP="1")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--ckpt-child",
                 out, tmp, part], env=env, timeout=900)
            if proc.returncode != 0:
                fail(f"[ckpt] the {part} launcher job exited "
                     f"{proc.returncode}")
            with open(out) as f:
                res.update(json.load(f))
    ctl, save, rest = res["control"], res["save"], res["restore"]
    gb = rest["file_bytes"] / 1e9
    log(f"[ckpt] control losses {ctl['losses']}; saved after step "
        f"{CKPT_AT}, restored in a new launcher job: steps "
        f"{CKPT_AT + 1}-{CKPT_STEPS} {rest['losses']} (control "
        f"{ctl['losses'][CKPT_AT:]}); final parameters max |difference| "
        f"{rest['param_max_abs']:.3e}")
    log(f"[ckpt] file {rest['file_bytes']} bytes; save {save['save_s']:.2f}"
        f" s ({gb / save['save_s']:.2f} GB/s; of it the ZeRO state's "
        f"assembly {save['assemble_s']:.2f} s); restore "
        f"{rest['restore_s']:.2f} s ({gb / rest['restore_s']:.2f} GB/s); "
        f"verify_checkpoint {rest['verify_s']:.2f} s: "
        f"{rest['verified']}")
    log(f"[ckpt] step ms (median of steps 2..{CKPT_STEPS}, watchdog armed, "
        f"HVDTPU_COLLECTIVE_TIMEOUT={CKPT_TIMEOUT_S}) {ctl['step_ms']:.1f} "
        f"against [zero]'s {zero_res['step_ms']:.1f} "
        f"({ctl['step_ms'] - zero_res['step_ms']:+.1f} ms); calls that "
        f"made the host wait: "
        f"{sum(r['host_waits'] for r in res.values())}")
    bad = ckpt_verdict(res)
    if bad:
        fail("[ckpt] " + "; ".join(bad))
    launches = {}
    for run in res.values():
        for n, c in run["launches"].items():
            launches[n] = launches.get(n, 0) + c
    return launches


def ckpt_child(out_path, tmp, part):
    """A child of ``ckpt_phase`` (``chip_smoke.py --ckpt-child OUT DIR
    PART``): rank 0 of a one-rank launcher job on the NCCL-delegated plane.
    ``save``: the control run, then 3 steps and the checkpoint; ``restore``:
    the newest checkpoint under DIR, then steps 4-5."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch import native as hnative
    os.environ["HVDTPU_PEERS"] = \
        f"127.0.0.1:{hnative.reserve_listen_port()}"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, checkpoint, models
    from horovod_tpu_torch.models import transformer as tmod
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    rt = basics.runtime()
    if rt.mode != basics.MODE_SPMD or rt.backend.name != "nccl-global":
        fail(f"[ckpt] expected a launcher job on the NCCL-delegated plane, "
             f"got {rt.mode}, {rt.backend.name}")
    ckpt_dir = os.path.join(tmp, "ckpt")
    control_params = os.path.join(tmp, "control.pt")

    def host_waits(fn):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [w for w in got
                     if "called a synchronizing" in str(w.message)]

    def setup():
        torch.cuda.empty_cache()
        cfg, model, step, x, y = transformer_setup(hvd, models, zero=True)
        tmod._rope_tables(cfg.max_len, cfg.hidden // cfg.heads,
                          hvd.device())
        return model, step, x, y

    def run(label, model, step, x, y, steps):
        fa.reset_launches()
        r = {"losses": [], "per_step_launches": [], "host_waits": 0,
             "watchdog": rt.coordinator._watchdog is not None}
        times = []
        for i in range(steps):
            torch.cuda.synchronize()
            prev = dict(fa.LAUNCHES)
            t0 = time.perf_counter()
            loss, w = host_waits(lambda: step(model, (x, y)))
            loss = loss.item()
            times.append((time.perf_counter() - t0) * 1e3)
            r["host_waits"] += len(w)
            r["losses"].append(loss)
            r["per_step_launches"].append(
                {n: fa.LAUNCHES[n] - prev[n]
                 for n in ("fwd", "bwd_dkv", "bwd_dq")})
            log(f"  [ckpt] {label} step {i + 1}: loss {loss:.6f}  "
                f"{times[-1]:.1f} ms  launches {r['per_step_launches'][-1]}")
        r.update(step_ms=_median(times[1:]) if len(times) > 1 else times[0],
                 launches={n: fa.LAUNCHES[n]
                           for n in ("fwd", "bwd_dkv", "bwd_dq")})
        return r

    res = {}
    if part == "save":
        model, step, x, y = setup()
        res["control"] = run("control", model, step, x, y, CKPT_STEPS)
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, control_params)
        del model, step
        model, step, x, y = setup()
        r = run("save", model, step, x, y, CKPT_AT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_state = step.optimizer.state_dict()
        r["assemble_s"] = time.perf_counter() - t0
        checkpoint.save_step(ckpt_dir, CKPT_AT, {
            "model": model.state_dict(), "opt": opt_state,
            "losses": r["losses"]})
        r["save_s"] = time.perf_counter() - t0
        res["save"] = r
    else:
        model, step, x, y = setup()
        torch.cuda.synchronize()
        path = os.path.join(ckpt_dir, f"step_{CKPT_AT}")
        t0 = time.perf_counter()
        ok, reason = checkpoint.verify_checkpoint(path)
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_step, state = checkpoint.restore_latest(ckpt_dir)
        model.load_state_dict(checkpoint.to_tensors(state["model"]))
        step.optimizer.load_state_dict(state["opt"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del state
        r = run("restore", model, step, x, y, CKPT_STEPS - CKPT_AT)
        want = torch.load(control_params)
        got = model.state_dict()
        r.update(restored_step=got_step, restore_s=restore_s,
                 verify_s=verify_s, verified=ok, verify_reason=reason,
                 file_bytes=os.path.getsize(path),
                 kept=sorted(checkpoint._list_steps(ckpt_dir)),
                 param_max_abs=max(float((got[k].cpu() - v).abs().max())
                                   for k, v in want.items()))
        res["restore"] = r
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


# [parallel]: the parallel strategies of horovod_tpu_torch/parallel/ on the
# card. Ring attention's per-rank schedule at the TransformerLM's widths,
# emulated on one card, through the flash kernels' LSE mode (offsets, an LSE
# output, an LSE cotangent in the backward); the LSE-mode kernels against
# their plain versions at the ring's chunk shapes; and a one-rank launcher
# job that runs the four strategies through the NCCL group.
PAR_HEADS, PAR_D = 16, 64
PAR_SEQ, PAR_RANKS = 32768, 4     # the ring's global sequence and ranks
PAR_FP32_SEQ = 4096
# The ring against one call over the whole sequence (bf16): each chunk's O
# and each call's dQ, dK, dV round to bf16 once before an fp32 merge or sum
# of at most n partials, where the whole-sequence call rounds once: up to
# four ulps (2^-5 relative); atol covers elements near zero; the Frobenius
# limit catches a chunk lost or counted twice. float32 against the dense
# reference: the kernels' own limits (fwd 2e-5, gradients 5e-4).
RING_TOL = {"bfloat16": ((2e-2, 2 ** -5, 1e-2), (2e-2, 2 ** -5, 1e-2)),
            "float32": ((2e-5, 2e-5, 1e-5), (5e-4, 5e-4, 1e-4))}
# The pipeline against the model's own step (bf16 compute, fp32 logits and
# parameters): the same operations on microbatches of 1 x 512 instead of
# one batch of 8, so cuBLAS may sum the bf16 products in another order and
# round an activation the other way. A microbatch or a stage lost moves
# the loss by percent and a gradient's Frobenius norm by 0.1 or more.
PIPE_M, PIPE_STAGES = 8, 4        # microbatches of 1 x 512; rounds=4 at n=1
PIPE_STEPS, PIPE_LR = 3, 1e-2     # SGD steps on both parameter sets
PIPE_LOSS_RTOL = 1e-3
PIPE_GRAD_FRO = 2e-2
PAR_MOE = dict(tokens=4096, d=1024, f=4096, e=8, k=2, capacity_factor=1.25)
PAR_LM = dict(vocab_size=30522, hidden=1024, layers=24, heads=16,
              max_len=512)                # the TransformerLM, full depth
PAR_REPS = 3


def ring_schedule(fa, ring_local, q, k, v, n, causal=True):
    """Ring attention's per-rank schedule at ``n`` ranks on one device: for
    each rank r, the port's own loop (``ring_local``, the ``_ring_local`` of
    ``parallel/ring_attention.py``, which merges by ``_merge`` in fp32)
    with the rotation done by slicing (each step brings the chunk pair that
    rank r-1 held, as the ring's ppermute does) and
    every kernel call ``flash_attention(q_r, k, v, q_offset, k_offset,
    with_lse=True)`` on leaves of its own, so that its gradients can be
    read. Returns the (B, H, S, D) output and the calls (dicts of r, the
    chunk src it was given, the leaves q, k, v and the outputs o, lse)."""
    s = q.shape[2] // n

    def chunk(x, i):
        return x[:, :, i * s:(i + 1) * s]

    def leaf(x):
        return x.detach().clone().requires_grad_()
    outs, calls = [], []
    for r in range(n):
        held = [r]

        def rotate(kv):
            j = (held[0] - 1) % n

            def arrive():
                held[0] = j
                return chunk(k, j), chunk(v, j)
            return arrive

        def attend(qc, kc, vc, q_offset, k_offset):
            c = dict(r=r, src=held[0], q=leaf(qc), k=leaf(kc), v=leaf(vc))
            c["o"], c["lse"] = fa.flash_attention(
                c["q"], c["k"], c["v"], causal=causal, q_offset=q_offset,
                k_offset=k_offset, with_lse=True)
            calls.append(c)
            return c["o"], c["lse"]
        o = ring_local(chunk(q, r), (chunk(k, r), chunk(v, r)), r, n,
                       rotate, attend)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=2), calls


def ring_grads(calls, shape, n):
    """The schedule's dQ, dK, dV by chunk: each call's leaf gradients summed
    in fp32 into the chunk the leaf was cut from."""
    s = shape[2] // n
    sums = [torch.zeros(shape, device=calls[0]["q"].device)
            for _ in range(3)]
    for c in calls:
        for total, name, at in zip(sums, "qkv", (c["r"], c["src"],
                                                 c["src"])):
            total[:, :, at * s:(at + 1) * s] += c[name].grad.float()
    return sums


def ring_check(fa, ring_local, dtype, seq, witness, label):
    """The schedule at 4 ranks over a global ``seq`` against ``witness``
    (``"flash"``: one kernel call over the whole sequence; ``"dense"``:
    ``reference_attention``), forward and backward; a fully-future call
    must give O = 0 and LSE = -1e30 and exactly zero gradients. Returns the
    max abs errors and the LSE-mode launches."""
    n = PAR_RANKS
    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (1, PAR_HEADS, seq, PAR_D)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    fa.reset_launches()
    out, calls = ring_schedule(fa, ring_local, q, k, v, n)
    out.backward(do)
    torch.cuda.synchronize()
    lse_launches = {name: fa.LAUNCHES[name]
                    for name in ("fwd", "bwd_dkv", "bwd_dq")}
    got = [out] + ring_grads(calls, shape, n)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    if witness == "flash":
        o = fa.flash_attention(*leaves, causal=True)
    else:
        o = fa.reference_attention(*leaves, causal=True)
    want = [o] + list(torch.autograd.grad(o, leaves, do))
    fwd_tol, grad_tol = RING_TOL[str(dtype).removeprefix("torch.")]
    log(f"[parallel] {label}: the ring's schedule at {n} ranks, B 1, H "
        f"{PAR_HEADS}, S {seq} ({seq // n} per rank), D {PAR_D}, {dtype}, "
        f"causal: {len(calls)} LSE-mode calls, launches {lse_launches}, "
        f"against {witness} attention over the whole sequence")
    errs = {}
    for name, g, w, tol in zip(("O", "dQ", "dK", "dV"), got, want,
                               (fwd_tol,) + (grad_tol,) * 3):
        errs[name] = compare(f"ring {name}", g, w, tol)
    future = [c for c in calls if c["src"] > c["r"]]
    for c in future:
        if not (c["o"].float().abs().max().item() == 0.0
                and bool((c["lse"] == fa.NEG_INF).all())):
            fail(f"[parallel] {label}: the fully-future call (rank "
                 f"{c['r']}, chunk {c['src']}) is not O = 0, LSE = -1e30")
        if any(c[x].grad.float().abs().max().item() != 0.0 for x in "qkv"):
            fail(f"[parallel] {label}: the fully-future call (rank "
                 f"{c['r']}, chunk {c['src']}) has nonzero gradients")
    log(f"  {len(future)} fully-future calls: O = 0, LSE = -1e30, dQ = dK = "
        "dV = 0 exactly")
    want_launches = dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), n * n)
    if lse_launches != want_launches:
        fail(f"[parallel] {label}: expected {n * n} LSE-mode launches of "
             f"each kernel, got {lse_launches}")
    return errs, lse_launches


# The LSE mode at the ring's chunk shapes: (q_offset, k_offset, kv_len)
# of a past chunk (every key visible), the diagonal chunk and a
# fully-future one (every tile skipped), rank 1 of 4 at S 32768.
LSE_CHUNKS = {"past": (8192, 0, 8192), "diagonal": (8192, 8192, 8192),
              "future": (8192, 16384, 8192)}


def lse_kernel_rows(fa, flush_buf):
    """Each kernel in the LSE mode against its plain version at the ring's
    chunk shapes, (B*H, S, D) = (16, 8192, 64) bf16, with an LSE cotangent
    in delta; times beside the bound and SDPA's flash call (non-causal on a
    past chunk, causal on the diagonal one). Returns the rows of the
    ``kernels`` line: the past chunk's numbers, the diagonal's under
    ``diagonal``."""
    bh, s, d = PAR_HEADS, PAR_SEQ // PAR_RANKS, PAR_D
    gen = torch.Generator(device="cuda").manual_seed(3)
    tol = KERNEL_TOL["bfloat16"]
    scale = 1.0 / math.sqrt(d)
    rows = {}
    for kind, lens in LSE_CHUNKS.items():
        q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        g_lse = torch.randn(bh, s, generator=gen, device="cuda")
        args = (q, k, v, lens, scale, True)
        log(f"[parallel] LSE mode, {kind} chunk: bh={bh} s={s} d={d} bf16 "
            f"causal (q_off, k_off, kv_len)={lens}, g_lse ~ N(0, 1)")
        # The plain versions run once each, timed as they give the
        # reference (seconds a call at this shape).
        plain_ms = {}
        o, lse = fa.attention_fwd(*args)
        (o_ref, lse_ref), plain_ms["fwd"] = time_once(
            lambda: fa.attention_fwd_plain(*args), flush_buf)
        delta = ((do.float() * o_ref.float()).sum(-1) - g_lse).contiguous()
        bargs = (q, k, v, do, lse_ref, delta, lens, scale, True)
        dk, dv = fa.attention_bwd_dkv(*bargs)
        (dk_ref, dv_ref), plain_ms["bwd_dkv"] = time_once(
            lambda: fa.attention_bwd_dkv_plain(*bargs), flush_buf)
        dq = fa.attention_bwd_dq(*bargs)
        dq_ref, plain_ms["bwd_dq"] = time_once(
            lambda: fa.attention_bwd_dq_plain(*bargs), flush_buf)
        torch.cuda.synchronize()
        errs = {"fwd": compare("fwd O", o, o_ref, tol)}
        seen = lse_ref > fa.NEG_INF / 2
        if bool(seen.any()):
            compare("fwd LSE", lse[seen], lse_ref[seen], (1e-4, 1e-5, 1e-5))
        errs["bwd_dkv"] = max(compare("bwd_dkv dK", dk, dk_ref, tol),
                              compare("bwd_dkv dV", dv, dv_ref, tol))
        errs["bwd_dq"] = compare("bwd_dq dQ", dq, dq_ref, tol)
        if kind == "future":
            if not (o.float().abs().max().item() == 0.0
                    and bool((lse == fa.NEG_INF).all())
                    and all(x.float().abs().max().item() == 0.0
                            for x in (dk, dv, dq))):
                fail("[parallel] the fully-future chunk's kernels did not "
                     "give O = 0, LSE = -1e30 and zero gradients")
            log("  fully-future chunk: O = 0, LSE = -1e30, dK = dV = dQ = "
                "0 exactly")
        pairs = visible_pairs(s, s, *lens, True)
        lib = library_times(q, k, v, do, flush_buf, kind == "diagonal",
                            0.0) if kind != "future" else dict.fromkeys(errs)
        kern = {"fwd": lambda: fa.attention_fwd(*args),
                "bwd_dkv": lambda: fa.attention_bwd_dkv(*bargs),
                "bwd_dq": lambda: fa.attention_bwd_dq(*bargs)}
        for base in ("fwd", "bwd_dkv", "bwd_dq"):
            b_ms, b_by = bound(base, bh, s, s, d, pairs, 2)
            r = {"max_abs_err": errs[base],
                 "ms": time_ms(kern[base], 20, flush_buf),
                 "plain_ms": plain_ms[base] if kind != "future" else None,
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib[base]}
            plain_s = "-" if r["plain_ms"] is None else \
                f"{r['plain_ms']:.1f}"
            lib_s = "-" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            sdpa = "causal" if kind == "diagonal" else "non-causal"
            log(f"  {base + '_lse':<14} kernel {r['ms']:.4f} ms | plain "
                f"{plain_s} ms | bound {b_ms:.4f} ms ({b_by}, {pairs} "
                f"pairs) | sdpa {sdpa} {lib_s} ms")
            name = base + "_lse"
            if kind == "past":
                rows[name] = r
            else:
                rows[name][kind] = r
    return rows


def parallel_verdict(res):
    """The checks of the ``[parallel]`` child's results (its tensors it
    holds to their witnesses itself, with ``compare``): the failures, none
    when every check holds."""
    bad = []
    pipe = res["pipeline"]
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(pipe["losses"], pipe["model_losses"])) \
        if len(pipe["losses"]) == len(pipe["model_losses"]) == PIPE_STEPS \
        else float("inf")
    if not rel <= PIPE_LOSS_RTOL:
        bad.append(f"pipeline losses {pipe['losses']} against the model's "
                   f"{pipe['model_losses']} (relative {rel:.2e})")
    worst = max(pipe["grad_fro"].values()) if pipe["grad_fro"] else \
        float("inf")
    if not worst <= PIPE_GRAD_FRO:
        bad.append(f"pipeline gradients: relative Frobenius error "
                   f"{worst:.2e} (limit {PIPE_GRAD_FRO:g})")
    if not all(math.isfinite(x) for x in pipe["losses"]):
        bad.append(f"pipeline losses not finite: {pipe['losses']}")
    if res["backend"] != "nccl":
        bad.append(f"the axis was a {res['backend']} group, not NCCL")
    return bad


def parallel_phase(fa, flush_buf):
    """Drive ``horovod_tpu_torch/parallel/`` on the card: the ring's
    schedule at full width through the LSE-mode kernels (bf16 against one
    call over the whole sequence, then float32 against dense attention),
    the LSE-mode kernels against their plain versions at the chunk shapes,
    then a one-rank launcher job (``--parallel-child``) through the NCCL
    group. Returns the LSE-mode launches of the main path (the bf16
    schedule and the child's ring) and the kernel rows."""
    import tempfile
    from horovod_tpu_torch.parallel.ring_attention import _ring_local
    torch.cuda.empty_cache()
    _, lse_launches = ring_check(fa, _ring_local, torch.bfloat16, PAR_SEQ,
                                 "flash", "ring bf16")
    ring_check(fa, _ring_local, torch.float32, PAR_FP32_SEQ, "dense",
               "ring float32")
    torch.cuda.empty_cache()
    rows = lse_kernel_rows(fa, flush_buf)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="hvd-parallel-") as tmp:
        out = os.path.join(tmp, "parallel.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parallel-child",
             out], env=_one_rank_env(), timeout=900)
        if proc.returncode != 0:
            fail(f"[parallel] the one-rank launcher job exited "
                 f"{proc.returncode}")
        with open(out) as f:
            res = json.load(f)
    pipe = res["pipeline"]
    log(f"[parallel] one-rank job over the {res['backend']} group: ring "
        f"{res['ring']['ms']:.2f} ms, Ulysses {res['ulysses']['ms']:.2f} ms "
        f"(all_to_all {res['ulysses']['a2a_bytes'] / 2 ** 20:.1f} MiB in "
        f"{res['ulysses']['a2a_ms']:.3f} ms), flash alone "
        f"{res['ring']['flash_ms']:.2f} ms (fwd + bwd, S "
        f"{PAR_SEQ // PAR_RANKS}); _prepare of a q view "
        f"({res['ring']['prepare_bytes'] / 2 ** 20:.0f} MiB) "
        f"{res['ring']['prepare_ms']:.3f} ms per call, of a contiguous q "
        f"{res['ring']['prepare_contiguous_ms']:.3f} ms; MoE "
        f"{res['moe']['ms']:.2f} ms against "
        f"{res['moe']['single_ms']:.2f} ms without the axis (all_to_all "
        f"{res['moe']['a2a_bytes'] / 2 ** 20:.1f} MiB in "
        f"{res['moe']['a2a_ms']:.3f} ms)")
    log(f"[parallel] pipeline, TransformerLM {PAR_LM['layers']} layers, "
        f"{PIPE_STAGES} stages of {PAR_LM['layers'] // PIPE_STAGES} blocks "
        f"(rounds={PIPE_STAGES}), "
        f"{PIPE_M} microbatches of 1 x 512: losses {pipe['losses']} against "
        f"the model's own step {pipe['model_losses']}; gradients' relative "
        f"Frobenius error: worst {max(pipe['grad_fro'].values()):.2e} "
        f"({max(pipe['grad_fro'], key=pipe['grad_fro'].get)}); step "
        f"{pipe['ms']:.1f} ms against the model's {pipe['model_ms']:.1f} ms;"
        f" peak memory {pipe['peak_gib']:.2f} GiB")
    bad = parallel_verdict(res)
    if bad:
        fail("[parallel] " + "; ".join(bad))
    launches = {f"{k}_lse": lse_launches[k] + res["lse_launches"].get(k, 0)
                for k in lse_launches}
    return launches, rows


def _median_ms(fn, reps=PAR_REPS):
    """Median host ms of ``fn`` from an idle device to its end."""
    times = []
    fn()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def _attention_child(fa, parallel, world):
    """Ring and Ulysses at one rank's chunk (B 1, H 16, S 8192, D 64, bf16,
    causal) through the NCCL group, forward and backward, against
    ``flash_attention`` on the same inputs. The ring's LSE-mode launches
    are those of its checked run."""
    shape = (1, PAR_HEADS, PAR_SEQ // PAR_RANKS, PAR_D)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    tol = KERNEL_TOL["bfloat16"]

    def run(fn):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves)
        return [o] + list(torch.autograd.grad(o, leaves, do))
    want = run(lambda *a: fa.flash_attention(*a, causal=True))
    flash_ms = _median_ms(lambda: run(
        lambda *a: fa.flash_attention(*a, causal=True)))
    out = {}
    for key, fn in (("ring", parallel.ring_attention),
                    ("ulysses", parallel.ulysses_attention)):
        fa.reset_launches()
        got = run(lambda *a: fn(*a, world, causal=True))
        launches = {n: c for n, c in fa.LAUNCHES.items() if c}
        log(f"[parallel child] {key} over the NCCL group, S {shape[2]}: "
            f"launches {launches}")
        for name, g, w in zip(("O", "dQ", "dK", "dV"), got, want):
            compare(f"{key} {name}", g, w, tol)
        out[key] = {"launches": launches, "ms": _median_ms(
            lambda: run(lambda *a: fn(*a, world, causal=True)))}
    out["ring"]["flash_ms"] = flash_ms
    # What flash_attention's _prepare costs a ring step: each of the n
    # calls copies a q that is a view (a sequence slice of a longer
    # tensor) into the kernels' (B*H, S, D) layout; a contiguous q is
    # taken as it is.
    view = torch.cat((q, q), dim=2)[:, :, :shape[2]]
    out["ring"]["prepare_bytes"] = q.numel() * q.element_size()
    out["ring"]["prepare_ms"] = _median_ms(lambda: fa._prepare(view, k, v))
    out["ring"]["prepare_contiguous_ms"] = _median_ms(
        lambda: fa._prepare(q, k, v))
    # The stacked q, k, v all_to_all; a step also moves O's, and both again
    # in the backward.
    stacked = torch.stack((q, k, v))
    out["ulysses"]["a2a_bytes"] = stacked.numel() * stacked.element_size()
    out["ulysses"]["a2a_ms"] = _median_ms(
        lambda: parallel.axis.all_to_all(stacked, world, 2, 3))
    return out


def _moe_child(parallel, world):
    """``moe_apply`` at d_model 1024, d_ff 4096, 8 experts, k 2, capacity
    1.25, 4096 tokens (bf16 tokens, fp32 weights) through the NCCL group
    against the same call without an axis, forward and the gradients of
    every weight."""
    from horovod_tpu_torch.parallel import axis as pax
    c = PAR_MOE
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(c["tokens"], c["d"], generator=gen,
                    device="cuda").to(torch.bfloat16)
    ws = [torch.randn(shape, generator=gen, device="cuda")
          * shape[-2] ** -0.5
          for shape in ((c["d"], c["e"]), (c["e"], c["d"], c["f"]),
                        (c["e"], c["f"], c["d"]))]
    kw = dict(k=c["k"], capacity_factor=c["capacity_factor"])

    def run(ep):
        leaves = [w.detach().requires_grad_() for w in ws]
        if ep:
            y, aux = parallel.moe_apply(x, *leaves, axis=world, **kw)
            loss = pax.psum((y.float() ** 2).mean(), world) + aux
        else:
            y, aux = parallel.moe_apply(x, *leaves, **kw)
            loss = (y.float() ** 2).mean() + aux
        return [y, aux] + list(torch.autograd.grad(loss, leaves))
    want, got = run(False), run(True)
    compare("moe y", got[0], want[0], KERNEL_TOL["bfloat16"])
    for name, g, w in zip(("moe aux", "moe d w_gate", "moe d w_in",
                           "moe d w_out"), got[1:], want[1:]):
        compare(name, g, w, (1e-5, 1e-4, 1e-4))
    # The dispatch all_to_all's (E, C, d) buffer; a step moves four such
    # (dispatch and return, forward and backward).
    cap = int(np.ceil(c["k"] * c["tokens"] * c["capacity_factor"] / c["e"]))
    buf = torch.randn(c["e"], cap, c["d"], generator=gen,
                      device="cuda").to(torch.bfloat16)
    return {"ms": _median_ms(lambda: run(True)),
            "single_ms": _median_ms(lambda: run(False)),
            "a2a_bytes": buf.numel() * buf.element_size(),
            "a2a_ms": _median_ms(lambda: pax.all_to_all(buf, world, 0, 1))}


def _pipeline_child(models, parallel, world, stages=PIPE_STAGES):
    """``pipeline_apply`` on the full TransformerLM (24 layers, seed 0) over
    ``world``: ``stages`` stages (rounds = stages / ranks, the interleaved
    placement), the embedding as ``first_fn``, the final LayerNorm and LM
    head as ``last_fn``, 8 microbatches of 1 x 512 (rank j holding its
    share of the queue); PIPE_STEPS SGD steps against the model's own
    forward and backward on the batch of 8 on this card, from the same
    weights: losses, and the first step's gradients of this rank's stages,
    the embedding and the head."""
    from horovod_tpu_torch.models import transformer as tmod
    cfg = models.TransformerConfig(**PAR_LM, causal=True, use_rope=True,
                                   attention_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = models.TransformerLM(cfg, device="cuda", generator=gen)
    x = torch.randint(0, cfg.vocab_size, (PIPE_M, cfg.max_len),
                      device="cuda", generator=gen)
    y = torch.randint(0, cfg.vocab_size, (PIPE_M, cfg.max_len),
                      device="cuda", generator=gen)
    per = cfg.layers // stages
    modules = [nn.Sequential(*model.backbone.blocks[i * per:(i + 1) * per])
               for i in range(stages)]
    n = parallel.axis.axis_size(world)
    idx = parallel.axis.axis_index(world)
    rounds = stages // n
    stacked = parallel.stack_stage_params(
        [{k: p.detach() for k, p in m.named_parameters()} for m in modules],
        n_ranks=n)
    block = {k: a[idx * rounds:(idx + 1) * rounds].clone().requires_grad_()
             for k, a in stacked.items()}
    emb = model.backbone.tok_embed.weight.detach().clone().requires_grad_()
    head = {k: p.detach().clone().requires_grad_() for k, p in (
        ("ln_w", model.backbone.ln_f.weight),
        ("ln_b", model.backbone.ln_f.bias),
        ("w", model.lm_head.weight), ("b", model.lm_head.bias))}
    dt = cfg.dtype

    def first_fn(e, tokens):
        return F.embedding(tokens, e.to(dt))

    def last_fn(p, h):
        h = F.layer_norm(h.float(), (cfg.hidden,), p["ln_w"], p["ln_b"],
                         tmod.LN_EPS).to(dt)
        return F.linear(h, p["w"].to(dt), p["b"].to(dt)).float()

    stage_fn = parallel.module_stage(
        nn.Sequential(*[tmod.Block(cfg, device="meta")
                        for _ in range(per)]))
    queue = x.view(PIPE_M, 1, cfg.max_len)
    per_rank = PIPE_M // n
    queue = queue[idx * per_rank:(idx + 1) * per_rank]
    pipe_leaves = list(block.values()) + [emb] + list(head.values())

    def pipe_loss():
        out = parallel.pipeline_apply(
            stage_fn, block, queue, world, first_fn=first_fn,
            first_params=emb, last_fn=last_fn, last_params=head,
            rounds=rounds)
        return F.cross_entropy(out.reshape(-1, cfg.vocab_size),
                               y.reshape(-1))

    def model_loss():
        logits = model(x)
        return F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               y.reshape(-1))

    model_params = list(model.parameters())
    opt_p = torch.optim.SGD(pipe_leaves, lr=PIPE_LR)
    opt_m = torch.optim.SGD(model_params, lr=PIPE_LR)
    torch.cuda.reset_peak_memory_stats()
    res = {"losses": [], "model_losses": [], "grad_fro": {}}
    for step in range(PIPE_STEPS):
        opt_p.zero_grad()
        loss = pipe_loss()
        loss.backward()
        res["losses"].append(loss.item())
        opt_m.zero_grad()
        mloss = model_loss()
        mloss.backward()
        res["model_losses"].append(mloss.item())
        log(f"  pipeline step {step + 1}: loss {res['losses'][-1]:.6f} "
            f"(model {res['model_losses'][-1]:.6f})")
        if step == 0:
            named = dict(model.named_parameters())
            pairs = {"tok_embed": (emb.grad, named[
                "backbone.tok_embed.weight"].grad)}
            for key, mname in (("ln_w", "backbone.ln_f.weight"),
                               ("ln_b", "backbone.ln_f.bias"),
                               ("w", "lm_head.weight"),
                               ("b", "lm_head.bias")):
                pairs[mname] = (head[key].grad, named[mname].grad)
            for i in range(cfg.layers):
                stage, j = divmod(i, per)
                slot = stage // n     # interleaved: stage ro*n + rank
                if stage % n != idx:
                    continue
                for pname, leaf in block.items():
                    if pname.startswith(f"{j}."):
                        mname = f"backbone.blocks.{i}.{pname[len(f'{j}.'):]}"
                        pairs[mname] = (leaf.grad[slot], named[mname].grad)
            res["grad_fro"] = {k: _rel_fro([g], [w])
                               for k, (g, w) in pairs.items()}
        opt_p.step()
        opt_m.step()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    def pipe_step():
        loss = pipe_loss()
        torch.autograd.grad(loss, pipe_leaves)

    def model_step():
        loss = model_loss()
        torch.autograd.grad(loss, model_params)
    res["ms"] = _median_ms(pipe_step, 3)
    res["model_ms"] = _median_ms(model_step, 3)
    return res


def parallel_child(out_path):
    """The child of ``parallel_phase`` (``chip_smoke.py --parallel-child
    OUT``): rank 0 of a one-rank launcher job on the NCCL-delegated plane.
    Its axis is the world group the port's NCCL backend formed; ring
    attention, Ulysses, the pipeline and MoE run over it, each against a
    witness without the axis."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch import native as hnative
    os.environ["HVDTPU_PEERS"] = \
        f"127.0.0.1:{hnative.reserve_listen_port()}"
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, models, parallel
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    rt = basics.runtime()
    if rt.mode != basics.MODE_SPMD or rt.backend.name != "nccl-global":
        fail(f"[parallel] expected a launcher job on the NCCL-delegated "
             f"plane, got {rt.mode}, {rt.backend.name}")
    world = dist.group.WORLD
    res = {"backend": str(dist.get_backend(world))}
    fa.reset_launches()
    res.update(_attention_child(fa, parallel, world))
    res["lse_launches"] = res["ring"]["launches"]
    torch.cuda.empty_cache()
    res["moe"] = _moe_child(parallel, world)
    torch.cuda.empty_cache()
    res["pipeline"] = _pipeline_child(models, parallel, world)
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------
# [sharded]: parallel/sharding.py's shard_model, resharding/'s group
# executor and parallel/twod.py's TwoDZero
# ---------------------------------------------------------------------------

SHARD_STEPS = 3
SHARD_LR, SHARD_WD = 1e-4, 1e-4   # AdamW as in [train]
SHARD_TP_BH = {"tp2": TRAIN_BATCH * 16 // 2, "tp4": TRAIN_BATCH * 16 // 4}
TWOD_DIMS = dict(d=1024, f=4096, tokens=4096)   # the MLP's widths
TWOD_STEPS = 3


def sharded_kernel_rows(fa, flush_buf):
    """The three no-dropout kernels at the tensor-parallel ranks' shapes of
    the TransformerLM (B·H 8·8 at tp 2, 8·4 at tp 4; S 512, D 64, bf16,
    causal) against their plain versions, timed beside the bound and SDPA.
    Returns ``{kernel: {"tp2": row, "tp4": row}}``."""
    s, d = MAIN["seq"], MAIN["d"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    tol = KERNEL_TOL["bfloat16"]
    scale = 1.0 / math.sqrt(d)
    rows = {k: {} for k in ("fwd", "bwd_dkv", "bwd_dq")}
    for label, bh in SHARD_TP_BH.items():
        q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        lens = (0, 0, s)
        args = (q, k, v, lens, scale, True)
        log(f"[sharded] kernels at {label}: bh={bh} s={s} d={d} bf16 causal")
        o, _ = fa.attention_fwd(*args)
        o_ref, lse_ref = fa.attention_fwd_plain(*args)
        delta = (do.float() * o_ref.float()).sum(-1)
        bargs = (q, k, v, do, lse_ref, delta, lens, scale, True)
        dk, dv = fa.attention_bwd_dkv(*bargs)
        dk_ref, dv_ref = fa.attention_bwd_dkv_plain(*bargs)
        dq = fa.attention_bwd_dq(*bargs)
        dq_ref = fa.attention_bwd_dq_plain(*bargs)
        torch.cuda.synchronize()
        errs = {"fwd": compare("fwd O", o, o_ref, tol),
                "bwd_dkv": max(compare("bwd_dkv dK", dk, dk_ref, tol),
                               compare("bwd_dkv dV", dv, dv_ref, tol)),
                "bwd_dq": compare("bwd_dq dQ", dq, dq_ref, tol)}
        pairs = visible_pairs(s, s, *lens, True)
        lib = library_times(q, k, v, do, flush_buf, True, 0.0)
        kern = {"fwd": lambda: fa.attention_fwd(*args),
                "bwd_dkv": lambda: fa.attention_bwd_dkv(*bargs),
                "bwd_dq": lambda: fa.attention_bwd_dq(*bargs)}
        plain = {"fwd": lambda: fa.attention_fwd_plain(*args),
                 "bwd_dkv": lambda: fa.attention_bwd_dkv_plain(*bargs),
                 "bwd_dq": lambda: fa.attention_bwd_dq_plain(*bargs)}
        for base in rows:
            b_ms, b_by = bound(base, bh, s, s, d, pairs, 2)
            r = {"max_abs_err": errs[base],
                 "ms": time_ms(kern[base], 20, flush_buf),
                 "plain_ms": time_ms(plain[base], 3, flush_buf),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib[base]}
            rows[base][label] = r
            log(f"  {base + '_' + label:<14} kernel {r['ms']:.4f} ms | plain "
                f"{r['plain_ms']:.3f} ms | bound {b_ms:.4f} ms ({b_by}) | "
                f"{KERNELS[base][1]} {r['library_ms']:.4f} ms")
    return rows


def lm_config(models):
    return models.TransformerConfig(**PAR_LM, causal=True, use_rope=True,
                                    attention_impl="flash")


def lm_batch(cfg, device="cuda"):
    """The full-width TransformerLM from seed 0 on ``device`` and one batch
    of TRAIN_BATCH x 512 (tokens, labels)."""
    from horovod_tpu_torch import models
    gen = torch.Generator(device=device).manual_seed(0)
    model = models.TransformerLM(cfg, device=device, generator=gen)
    x, y = (torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len),
                          device=device, generator=gen) for _ in range(2))
    return model, x, y


def lm_reference(models, steps=SHARD_STEPS, timed=3):
    """The unsharded model's own steps on this card (AdamW as in
    [train]): losses, peak GiB and parameters after ``steps`` steps, then
    ``timed`` more for the step ms."""
    cfg = lm_config(models)
    model, x, y = lm_batch(cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=SHARD_LR,
                            weight_decay=SHARD_WD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(steps + timed):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        logits = model(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1))
        loss.backward()
        opt.step()
        loss = loss.item()
        times.append((time.perf_counter() - t0) * 1e3)
        if i < steps:
            losses.append(loss)
        if i == steps - 1:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            params = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
    out = {"losses": losses, "ms": _median(times[1:]), "peak_gib": peak,
           "params": params}
    del model, opt
    torch.cuda.empty_cache()
    return out


def lm_sharded(fa, models, sharding, mesh, steps=SHARD_STEPS, timed=3):
    """``shard_model`` of the full-width TransformerLM (seed 0) on ``mesh``:
    ``steps`` AdamW steps on this rank's batch slice, the flash launches of
    each, the peak GiB over them and the gathered parameters after them,
    then ``timed`` more steps for the step ms."""
    cfg = lm_config(models)
    model, x, y = lm_batch(cfg)
    sm = sharding.shard_model(model, mesh)
    del model
    torch.cuda.empty_cache()
    opt = torch.optim.AdamW(sm.parameters(), lr=SHARD_LR,
                            weight_decay=SHARD_WD)
    x, y = sm.local_batch(x), sm.local_batch(y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, launches, times = [], [], []
    for _ in range(steps + timed):
        fa.reset_launches()
        t0 = time.perf_counter()
        loss = sm.train_step(opt, x, y).item()
        times.append((time.perf_counter() - t0) * 1e3)
        if len(losses) < steps:
            losses.append(loss)
            launches.append({n: c for n, c in fa.LAUNCHES.items() if c})
            if len(losses) == steps:
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                params = sm.full_state_dict()
    out = {"losses": losses, "launches": launches,
           "ms": _median(times[1:]), "peak_gib": peak, "params": params,
           "local_param_bytes": sum(p.numel() * p.element_size()
                                    for p in sm.parameters())}
    del sm, opt
    torch.cuda.empty_cache()
    return out


def group_round_trip(resharding, zero, leaves, group, n, src_axis="hvd"):
    """``execute_group`` moves ``leaves`` from Replicated over ``n`` ranks
    (mesh axis ``src_axis``) to the ZeRO-1 flat layout over ``n`` ranks
    (axis "hvd") and back; returns the wire and placed bytes, seconds,
    peak bytes of each way, whether the round trip gave every leaf back
    bit for bit, and the hvd-sim proof of both programs (``Program.prove``
    at ``n`` symbolic ranks, run before either executes; a finding
    fails)."""
    meta = resharding.tree_meta_of(leaves)
    plan = zero.plan_zero(leaves, n)
    src = resharding.replicated_spec(len(leaves), {src_axis: n})
    dst = resharding.zero_flat_spec(plan, axis="hvd")
    flat = [t.detach().reshape(-1) for t in leaves]
    out = {}
    torch.cuda.synchronize()
    fwd = resharding.plan_redistribution(src, dst, meta)
    back = resharding.plan_redistribution(dst, src, meta)
    t0 = time.perf_counter()
    found = fwd.prove(n) + back.prove(n)
    out["prove"] = {"steps": len(fwd.steps) + len(back.steps),
                    "world": max(2, n),
                    "seconds": time.perf_counter() - t0}
    if found:
        fail("[sharded] hvd-sim refuted a redistribution program: "
             + "; ".join(d.format() for d in found))
    bufs, rep = resharding.execute_group(
        fwd, lambda r, buf, a, n_: flat[buf[1]][a:a + n_], group=group)
    out["to_zero"] = {k: rep[k] for k in ("wire_bytes", "sent_bytes",
                                          "peak_bytes", "seconds")}
    out["to_zero"].update(strategy=fwd.strategy, steps=len(fwd.steps),
                          placed_bytes=sum(rep["bytes_by_leg"].values()))
    again, rep = resharding.execute_group(
        back, lambda r, buf, a, n_: bufs[buf][a:a + n_], group=group)
    out["to_replicated"] = {k: rep[k] for k in ("wire_bytes", "sent_bytes",
                                                "peak_bytes", "seconds")}
    out["to_replicated"].update(
        strategy=back.strategy, steps=len(back.steps),
        placed_bytes=sum(rep["bytes_by_leg"].values()))
    out["bit_equal"] = all(torch.equal(again[("leaf", i)], flat[i])
                           for i in range(len(flat)))
    out["tree_bytes"] = sum(t.numel() * t.element_size() for t in flat)
    return out


def twod_inputs(device, dims=TWOD_DIMS, seed=7):
    """tests/test_twod.py's parameters and batch at ``dims`` (d -> f,
    ``tokens`` rows), from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f = dims["d"], dims["f"]
    params = {"mlp_in": {"kernel": torch.randn(d, f, generator=gen,
                                               device=device) * d ** -0.5,
                         "bias": torch.randn(f, generator=gen,
                                             device=device)},
              "scale": torch.randn(d, generator=gen, device=device)}
    batch = torch.randn(dims["tokens"], d, generator=gen, device=device)
    return params, batch


def twod_loss(p, b):
    """tests/test_twod.py's column-decomposable loss."""
    h = b * p["scale"]
    y = h @ p["mlp_in"]["kernel"] + p["mlp_in"]["bias"]
    return torch.sum(y * y)


def twod_one_card(twod, tree):
    """``TwoDZero`` at (1, 1) on the MLP's widths, TWOD_STEPS steps of
    AdamW as its inner optimizer, against plain AdamW over the same
    parameters: losses and parameters (max |diff|)."""
    import functools
    params, batch = twod_inputs("cuda")
    inner = functools.partial(torch.optim.AdamW, lr=SHARD_LR,
                              weight_decay=SHARD_WD)
    tz = twod.TwoDZero(inner, twod.make_mesh_2d(1, 1))
    local = tz.shard(params)
    state = tz.init_state(local)
    step = tz.make_step(twod_loss)
    plain = [x.clone().requires_grad_() for x in tree.leaves(params)]
    opt = inner(plain)
    out = {"losses": [], "plain_losses": [], "ms": []}
    p = local
    for _ in range(TWOD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, loss = step(p, state, batch)
        out["losses"].append(loss.item())
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        opt.zero_grad(set_to_none=True)
        ploss = twod_loss(tree.unflatten(tree.structure(params), plain),
                          batch)
        ploss.backward()
        opt.step()
        out["plain_losses"].append(ploss.item())
    out["max_param_diff"] = max(
        (a - b).abs().max().item()
        for a, b in zip(tree.leaves(p), plain))
    out["buckets"] = len(tz.plan.buckets)
    # train -> serve: the stepped params, replicated at serving world 1
    # and in rows at world 2, run by the planner's program in process
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = tz.to_serving(p)
    torch.cuda.synchronize()
    out["serve_ms"] = (time.perf_counter() - t0) * 1e3
    leaves = tree.leaves(p)
    out["serve_replicated_equal"] = all(
        torch.equal(a, b) for a, b in zip(tree.leaves(rep), leaves))
    rows_equal = True
    for host in range(2):
        rows = tz.to_serving(p, serving_world=2, serving_rank=host,
                             layout="rows")
        for a, b in zip(tree.leaves(rows), leaves):
            lo, hi = (b.shape[0] * host) // 2, (b.shape[0] * (host + 1)) // 2
            rows_equal &= bool(torch.equal(a, b[lo:hi]))
    out["serve_rows_equal"] = rows_equal
    out["serve_bytes"] = sum(x.numel() * x.element_size() for x in leaves)
    return out


def sharded_child(out_path):
    """The child of ``sharded_phase`` (``chip_smoke.py --sharded-child
    OUT``): rank 0 of a one-rank launcher job on the NCCL-delegated plane,
    its mesh the world group's. ``shard_model`` at (1, 1, 1) against the
    unsharded model's steps, ``execute_group``'s round trip of the full
    parameter tree, and ``TwoDZero`` at (1, 1) against plain AdamW."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch import native as hnative
    os.environ["HVDTPU_PEERS"] = \
        f"127.0.0.1:{hnative.reserve_listen_port()}"
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, models, parallel, resharding
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import zero
    from horovod_tpu_torch.parallel import sharding, twod
    from horovod_tpu_torch.utils import tree
    hvd.init()
    rt = basics.runtime()
    if rt.mode != basics.MODE_SPMD or rt.backend.name != "nccl-global":
        fail(f"[sharded] expected a launcher job on the NCCL-delegated "
             f"plane, got {rt.mode}, {rt.backend.name}")
    res = {"backend": str(dist.get_backend())}
    ref = lm_reference(models)
    mesh = parallel.make_mesh(parallel.MeshConfig(dp=1))
    got = lm_sharded(fa, models, sharding, mesh)
    res["lm"] = {"losses": got["losses"], "ref_losses": ref["losses"],
                 "launches": got["launches"], "ms": got["ms"],
                 "ref_ms": ref["ms"], "peak_gib": got["peak_gib"],
                 "ref_peak_gib": ref["peak_gib"],
                 "params_equal": all(torch.equal(got["params"][k], v)
                                     for k, v in ref["params"].items())}
    leaves = [v for v in got["params"].values()]
    del ref, got
    torch.cuda.empty_cache()
    res["group"] = group_round_trip(resharding, zero, leaves,
                                    dist.group.WORLD, 1)
    del leaves
    torch.cuda.empty_cache()
    res["twod"] = twod_one_card(twod, tree)
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


def sharded_verdict(res):
    """The checks of the ``[sharded]`` child's results: the failures."""
    bad = []
    lm = res["lm"]
    if lm["losses"] != lm["ref_losses"]:
        bad.append(f"shard_model losses {lm['losses']} are not the "
                   f"unsharded model's {lm['ref_losses']}")
    if not lm["params_equal"]:
        bad.append("shard_model's parameters after the steps are not the "
                   "unsharded model's")
    want = dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), PAR_LM["layers"])
    if any(launch != want for launch in lm["launches"]):
        bad.append(f"shard_model launches per step {lm['launches']}, "
                   f"expected {want}")
    if not all(math.isfinite(x) for x in lm["losses"]):
        bad.append(f"non-finite losses {lm['losses']}")
    if not res["group"]["bit_equal"]:
        bad.append("execute_group's round trip did not give the tree back")
    tw = res["twod"]
    if tw["losses"] != tw["plain_losses"] or tw["max_param_diff"] != 0.0:
        bad.append(f"TwoDZero at (1, 1) losses {tw['losses']} against "
                   f"AdamW's {tw['plain_losses']}, parameters max |diff| "
                   f"{tw['max_param_diff']:.3e}")
    if not (tw["serve_replicated_equal"] and tw["serve_rows_equal"]):
        bad.append(f"TwoDZero.to_serving is not bit-equal to the params: "
                   f"replicated {tw['serve_replicated_equal']}, rows at "
                   f"serving world 2 {tw['serve_rows_equal']}")
    if res["backend"] != "nccl":
        bad.append(f"the group was {res['backend']}, not NCCL")
    return bad


def sharded_phase(fa, flush_buf):
    """Drive ``parallel/sharding.py``, ``resharding/`` and
    ``parallel/twod.py`` on the card: the no-dropout kernels at the
    tensor-parallel ranks' shapes, then a one-rank launcher job
    (``--sharded-child``). Returns the kernels' launches on the sharded
    model's steps and the kernel rows."""
    import tempfile
    torch.cuda.empty_cache()
    rows = sharded_kernel_rows(fa, flush_buf)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="hvd-sharded-") as tmp:
        out = os.path.join(tmp, "sharded.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sharded-child",
             out], env=_one_rank_env(), timeout=600)
        if proc.returncode != 0:
            fail(f"[sharded] the one-rank launcher job exited "
                 f"{proc.returncode}")
        with open(out) as f:
            res = json.load(f)
    lm, g, tw = res["lm"], res["group"], res["twod"]
    log(f"[sharded] shard_model at mesh (1, 1, 1), TransformerLM "
        f"{PAR_LM['layers']} layers, batch {TRAIN_BATCH} x 512, "
        f"{SHARD_STEPS} AdamW steps: losses {lm['losses']} against the "
        f"unsharded model's {lm['ref_losses']} (bit-equal: "
        f"{lm['losses'] == lm['ref_losses']}; parameters equal: "
        f"{lm['params_equal']}); launches per step {lm['launches'][0]}; "
        f"step {lm['ms']:.1f} ms against {lm['ref_ms']:.1f}; peak "
        f"{lm['peak_gib']:.2f} GiB against {lm['ref_peak_gib']:.2f}")
    for way in ("to_zero", "to_replicated"):
        r = g[way]
        log(f"[sharded] execute_group {way}: {g['tree_bytes'] / 2 ** 30:.3f}"
            f" GiB tree, {r['strategy']} program of {r['steps']} steps, "
            f"wire {r['wire_bytes']} B, placed {r['placed_bytes']} B in "
            f"{r['seconds'] * 1e3:.1f} ms "
            f"({r['placed_bytes'] / r['seconds'] / 1e9:.2f} GB/s), peak "
            f"{r['peak_bytes'] / 2 ** 30:.3f} GiB")
    log(f"[sharded] execute_group round trip bit-equal: {g['bit_equal']}")
    log(f"[sharded] Program.prove (hvd-sim) of both programs before they "
        f"ran: {g['prove']['steps']} steps at {g['prove']['world']} "
        f"symbolic ranks, no finding, in {g['prove']['seconds']:.4f} s")
    log(f"[sharded] TwoDZero (1, 1), {TWOD_DIMS['d']} -> {TWOD_DIMS['f']}, "
        f"{TWOD_DIMS['tokens']} tokens, {tw['buckets']} buckets: losses "
        f"{tw['losses']} against AdamW's {tw['plain_losses']}; parameters "
        f"max |diff| {tw['max_param_diff']:.3e}; step ms "
        f"{[round(t, 2) for t in tw['ms']]}")
    log(f"[sharded] TwoDZero.to_serving of the stepped params "
        f"({tw['serve_bytes'] / 2 ** 20:.1f} MiB): replicated bit-equal "
        f"{tw['serve_replicated_equal']} in {tw['serve_ms']:.1f} ms, rows "
        f"at serving world 2 bit-equal {tw['serve_rows_equal']}")
    bad = sharded_verdict(res)
    if bad:
        fail("[sharded] " + "; ".join(bad))
    launches = {}
    for per in lm["launches"]:
        for n, c in per.items():
            launches[n] = launches.get(n, 0) + c
    return launches, rows


# ---------------------------------------------------------------------------
# [bertmodel]: the port's BertModel at BERT-large's shape, with remat
# ---------------------------------------------------------------------------

BERTMODEL_STEPS = 5
BERTMODEL_REMAT = (False, "dots", True)
# Remat changes no operation's inputs, so the losses match the no-remat
# run's; the limit leaves room for the order of floating-point atomics in
# cuBLAS/embedding backward kernels between runs.
BERTMODEL_LOSS_RTOL = 1e-4
PAD_LEN = 300            # the padded row's length in the padding witness


def noncausal_kernel_rows(fa, flush_buf):
    """The three no-dropout kernels at BertModel's shape (B·H 8·16, S 512,
    D 64, bf16, not causal) against their plain versions, timed beside the
    bound and SDPA's non-causal flash backend. Returns
    ``{kernel: {"noncausal": row}}``."""
    s, d, bh = MAIN["seq"], MAIN["d"], MAIN["bh"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    tol = KERNEL_TOL["bfloat16"]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    lens = (0, 0, s)
    args = (q, k, v, lens, scale, False)
    log(f"[bertmodel] kernels: bh={bh} s={s} d={d} bf16 non-causal, no "
        "dropout")
    o, _ = fa.attention_fwd(*args)
    o_ref, lse_ref = fa.attention_fwd_plain(*args)
    delta = (do.float() * o_ref.float()).sum(-1)
    bargs = (q, k, v, do, lse_ref, delta, lens, scale, False)
    dk, dv = fa.attention_bwd_dkv(*bargs)
    dk_ref, dv_ref = fa.attention_bwd_dkv_plain(*bargs)
    dq = fa.attention_bwd_dq(*bargs)
    dq_ref = fa.attention_bwd_dq_plain(*bargs)
    torch.cuda.synchronize()
    errs = {"fwd": compare("fwd O", o, o_ref, tol),
            "bwd_dkv": max(compare("bwd_dkv dK", dk, dk_ref, tol),
                           compare("bwd_dkv dV", dv, dv_ref, tol)),
            "bwd_dq": compare("bwd_dq dQ", dq, dq_ref, tol)}
    pairs = visible_pairs(s, s, *lens, False)
    lib = library_times(q, k, v, do, flush_buf, False, 0.0)
    kern = {"fwd": lambda: fa.attention_fwd(*args),
            "bwd_dkv": lambda: fa.attention_bwd_dkv(*bargs),
            "bwd_dq": lambda: fa.attention_bwd_dq(*bargs)}
    plain = {"fwd": lambda: fa.attention_fwd_plain(*args),
             "bwd_dkv": lambda: fa.attention_bwd_dkv_plain(*bargs),
             "bwd_dq": lambda: fa.attention_bwd_dq_plain(*bargs)}
    rows = {}
    for base in ("fwd", "bwd_dkv", "bwd_dq"):
        b_ms, b_by = bound(base, bh, s, s, d, pairs, 2)
        r = {"max_abs_err": errs[base],
             "ms": time_ms(kern[base], 20, flush_buf),
             "plain_ms": time_ms(plain[base], 3, flush_buf),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib[base]}
        rows[base] = {"noncausal": r}
        log(f"  {base + '_noncausal':<18} kernel {r['ms']:.4f} ms | plain "
            f"{r['plain_ms']:.3f} ms | bound {b_ms:.4f} ms ({b_by}) | "
            f"sdpa flash non-causal {r['library_ms']:.4f} ms")
    return rows


def linear_aten_ops():
    """The aten ops a 3-D ``F.linear`` reaches on the card (what the remat
    "dots" policy sees), for a contiguous input and a transposed one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))
    x = torch.randn(8, 512, 1024, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(4096, 1024, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(4096, device="cuda", dtype=torch.bfloat16)
    out = {}
    for label, inp in (("contiguous", x), ("transposed", x.transpose(0, 1))):
        with Ops() as mode:
            F.linear(inp, w, b)
        out[label] = [op for op in mode.ops
                      if op.split(".")[1] in ("mm", "addmm", "bmm")]
    return out


def bertmodel_run(hvd, fa, models, remat):
    """BERTMODEL_STEPS AdamW steps of BertModel (BERT-large, flash, bf16,
    seed 0) at batch TRAIN_BATCH x 512 under ``remat``: losses, step ms,
    peak memory and each kernel's launches per step."""
    cfg = models.BertConfig(attention_impl="flash", remat=remat)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = models.BertModel(cfg, device=hvd.device(), generator=gen)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))

    def loss_fn(m, batch):
        logits = m(batch)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch.reshape(-1))
    step = hvd.make_train_step(loss_fn, opt)
    x = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_len),
                      device="cuda", generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, times, per_step = [], [], []
    for _ in range(BERTMODEL_STEPS):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        losses.append(step(model, x).item())
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: fa.LAUNCHES[n] - before.get(n, 0)
                         for n in fa.LAUNCHES
                         if fa.LAUNCHES[n] - before.get(n, 0)})
    res = {"losses": losses, "ms": _median(times[1:]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": per_step,
           "params": sum(p.numel() for p in model.parameters())}
    del model, opt, step
    torch.cuda.empty_cache()
    return res


def padded_witness(models):
    """A right-padded batch through BertModel's einsum path (learned
    positions, 2 layers at full width, bf16): the logits at the kept
    positions of the padded row against the same row cut to its length.
    Returns (max_abs_err, limit, rel_fro)."""
    cfg = models.BertConfig(attention_impl="einsum", layers=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = models.BertModel(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_len),
                           device="cuda", generator=gen)
    mask = torch.ones(2, cfg.max_len, dtype=torch.bool, device="cuda")
    mask[1, PAD_LEN:] = False
    with torch.no_grad():
        padded = model(tokens, mask)[1, :PAD_LEN]
        cut = model(tokens[1:, :PAD_LEN])[0]
    diff = (padded - cut).abs()
    err, scale = diff.max().item(), cut.abs().max().item()
    fro = (diff.norm() / cut.norm()).item()
    return err, 5e-2 * scale, fro


def bridge_padded_check(hvd_torch):
    """Repair of the bridge: a right-padded BERT-style call (the 2-layer
    stand-in at full width, HF's additive SDPA mask) through tpu_compile
    on the card takes the einsum lowering and equals the same call's CPU
    lowering (the same bf16 weights, eval mode). Returns (max_abs_err,
    limit, rel_fro)."""
    from horovod_tpu_torch.torch import compile as tcompile
    cfg = BertConfig(**dict(BERT, num_hidden_layers=2))
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = BertForMaskedLM(cfg, device="cuda", generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                        generator=gen)
    attn = torch.ones_like(ids)
    attn[1, 77:] = 0
    compiled = hvd_torch.tpu_compile(model, compute_dtype=torch.bfloat16)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        card = compiled(input_ids=ids, attention_mask=attn)["logits"]
        host = tcompile.CompiledModule(
            model, {k: v.detach().cpu() for k, v in compiled.params.items()},
            {k: v.cpu() for k, v in compiled.buffers.items()},
            torch.device("cpu"), compute_dtype=torch.bfloat16)(
                input_ids=ids.cpu(), attention_mask=attn.cpu())["logits"]
    notes = {str(w.message) for w in caught}
    if not any("not statically all-keep" in n for n in notes):
        fail(f"[bertmodel] the padded bridge call did not take the einsum "
             f"lowering: {notes}")
    diff = (card.float().cpu() - host.float()).abs()
    err, scale = diff.max().item(), host.float().abs().max().item()
    fro = (diff.norm() / host.float().norm()).item()
    return err, 5e-2 * scale, fro


def bertmodel_verdict(runs, layers):
    """The checks of ``[bertmodel]``'s three runs: the failures."""
    bad = []
    base = runs[False]["losses"]
    for remat, r in runs.items():
        ls = r["losses"]
        if not all(math.isfinite(v) for v in ls) or not ls[-1] < ls[0]:
            bad.append(f"remat={remat!r}: losses {ls} do not descend")
        worst = max(abs(a - b) / abs(b) for a, b in zip(ls, base))
        if worst > BERTMODEL_LOSS_RTOL:
            bad.append(f"remat={remat!r} moved the losses by {worst:.2e} "
                       f"relative (limit {BERTMODEL_LOSS_RTOL:g})")
        fwd = 2 * layers if remat else layers
        want = {"fwd": fwd, "bwd_dkv": layers, "bwd_dq": layers}
        if any(per != want for per in r["launches"]):
            bad.append(f"remat={remat!r}: launches per step "
                       f"{r['launches']}, expected {want}")
    peaks = [runs[m]["peak_gib"] for m in BERTMODEL_REMAT]
    if not peaks[0] > peaks[1] > peaks[2]:
        bad.append(f"peak memory not ordered False > dots > True: {peaks}")
    return bad


def bertmodel_phase(hvd, hvd_torch, fa, models, flush_buf):
    """Drive ``models.BertModel`` on the card: the non-causal no-dropout
    kernels at its shape, BERT-large through DistributedOptimizer under
    each remat, the padding witness and the bridge's padded call. Returns
    the kernel rows and the launches of the remat runs."""
    rows = noncausal_kernel_rows(fa, flush_buf)
    ops = linear_aten_ops()
    log(f"[bertmodel] aten ops of a 3-D F.linear on the card (remat "
        f"'dots' keeps mm/addmm, recomputes bmm): contiguous input "
        f"{ops['contiguous']}, transposed input {ops['transposed']}")
    runs = {}
    for remat in BERTMODEL_REMAT:
        r = runs[remat] = bertmodel_run(hvd, fa, models, remat)
        log(f"[bertmodel] remat={remat!r}: BertModel {r['params'] / 1e6:.1f}M"
            f" params, batch {TRAIN_BATCH} x 512, bf16, flash, "
            f"{BERTMODEL_STEPS} AdamW steps: losses "
            f"{[round(v, 6) for v in r['losses']]}; step ms (median of "
            f"steps 2-{BERTMODEL_STEPS}) {r['ms']:.1f}; peak "
            f"{r['peak_gib']:.2f} GiB; launches per step {r['launches'][0]}")
    layers = models.BertConfig().layers
    base = runs[False]["losses"]
    for remat in BERTMODEL_REMAT[1:]:
        worst = max(abs(a - b) / abs(b)
                    for a, b in zip(runs[remat]["losses"], base))
        log(f"[bertmodel] remat={remat!r} against remat=False: largest loss "
            f"difference {worst:.3e} relative (limit "
            f"{BERTMODEL_LOSS_RTOL:g})")
    err, limit, fro = padded_witness(models)
    log(f"[bertmodel] padded row (length {PAD_LEN} of 512, einsum, 2 layers) "
        f"against the row cut to its length: max_abs_err {err:.3e} (limit "
        f"{limit:.3e}), rel_fro {fro:.2e} (limit 2e-2)")
    if not (math.isfinite(err) and err <= limit and fro <= 2e-2):
        fail("[bertmodel] the padding mask changed a kept position's logits")
    err, limit, fro = bridge_padded_check(hvd_torch)
    log(f"[bertmodel] bridge: right-padded BERT call (2 layers, 2 x 128) on "
        f"the card against its CPU lowering: max_abs_err {err:.3e} (limit "
        f"{limit:.3e}), rel_fro {fro:.2e} (limit 2e-2)")
    if not (math.isfinite(err) and err <= limit and fro <= 2e-2):
        fail("[bertmodel] the bridge's padded call on the card disagrees "
             "with its CPU lowering")
    bad = bertmodel_verdict(runs, layers)
    if bad:
        fail("[bertmodel] " + "; ".join(bad))
    launches = {}
    for r in runs.values():
        for per in r["launches"]:
            for n, c in per.items():
                launches[n] = launches.get(n, 0) + c
    return rows, launches


# ---------------------------------------------------------------------------
# [trace]: the telemetry and trace planes in a one-rank launcher job
# ---------------------------------------------------------------------------

TRACE_STEPS = 5
TRACE_COST_STEPS = 6
# The knob settings timed against each other: (HVDTPU_TRACE,
# HVDTPU_FLIGHT_RECORDER).
TRACE_VARIANTS = (("0", "0"), ("0", "1"), ("1", "0"), ("1", "1"))


def time_nccl_responses(backend):
    """Wrap the NCCL plane's allreduce execution with CUDA events on the
    backend's stream: ``[([(entry name, occurrence)], start, end)]``.
    Only for the span check; ``del backend._delegated_allreduce`` undoes
    it."""
    timed = []
    run = backend._delegated_allreduce

    def wrapped(d, group, ranks, dtype, local):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(backend._stream)
        nbytes = run(d, group, ranks, dtype, local)
        end.record(backend._stream)
        timed.append(([(item[0].name, item[0].corr) for item in local
                       if item is not None], start, end))
        return nbytes

    backend._delegated_allreduce = wrapped
    return timed


def span_check(spans, responses):
    """Each traced allreduce's sub→fin span (s) against the NCCL device
    time of its response (ms): (entries checked, those shorter, median
    span ms, median device ms)."""
    checked, short, span_ms, dev_ms = 0, [], [], []
    for keys, ms in responses:
        for name, occ in keys:
            sp = spans.get((name, occ))
            if sp is None or sp["sub"] is None or sp["fin"] is None:
                short.append((name, occ, None, ms))
                continue
            checked += 1
            span_ms.append((sp["fin"] - sp["sub"]) * 1e3)
            dev_ms.append(ms)
            if span_ms[-1] < ms:
                short.append((name, occ, span_ms[-1], ms))
    return (checked, short, _median(span_ms) if span_ms else None,
            _median(dev_ms) if dev_ms else None)


def trace_child(out_path):
    """The child of ``trace_phase`` (``chip_smoke.py --trace-child OUT``):
    rank 0 of a one-rank job on the NCCL-delegated plane that found its
    peers through the parent's KV store, with ``HVDTPU_TRACE=1`` and
    ``HOROVOD_TPU_METRICS=1``. The full-width TransformerLM trains
    TRACE_STEPS steps through DistributedOptimizer; then each knob setting
    of TRACE_VARIANTS gets the tracer ``tracing.make_tracer`` builds for
    it, in turn, for TRACE_COST_STEPS steps (twice, in opposite orders)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, models, tracing
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    rt = basics.runtime()
    coord = rt.coordinator
    if rt.mode != basics.MODE_SPMD or rt.backend.name != "nccl-global":
        fail(f"[trace] expected a launcher job on the NCCL-delegated plane, "
             f"got {rt.mode}, {rt.backend.name}")
    if coord._tracer is None or coord._tracer._writer is None:
        fail("[trace] HVDTPU_TRACE=1 built no shard writer")
    cfg, model, step, x, y = transformer_setup(hvd, models)
    res = {"losses": [], "ms": [], "launches": []}
    fa.reset_launches()
    timed = time_nccl_responses(rt.backend)
    for _ in range(TRACE_STEPS):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        res["losses"].append(step(model, (x, y)).item())
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["launches"].append({n: fa.LAUNCHES[n] - before.get(n, 0)
                                for n in fa.LAUNCHES
                                if fa.LAUNCHES[n] - before.get(n, 0)})
    del rt.backend._delegated_allreduce
    torch.cuda.synchronize()
    res["responses"] = [[keys, start.elapsed_time(end)]
                        for keys, start, end in timed]
    traced = coord._tracer
    trace_dir = os.environ["HVDTPU_TRACE_DIR"]
    cost = {f"TRACE={t} FLIGHT_RECORDER={f}": [] for t, f in TRACE_VARIANTS}
    order = list(TRACE_VARIANTS) + list(reversed(TRACE_VARIANTS))
    for i, (t, f) in enumerate(order):
        os.environ.update(HVDTPU_TRACE=t, HVDTPU_FLIGHT_RECORDER=f,
                          HVDTPU_TRACE_DIR=os.path.join(trace_dir,
                                                        f"cost{i}"))
        tracer = tracing.make_tracer(rt)
        coord._tracer = rt.tracer = tracer
        times = []
        for _ in range(TRACE_COST_STEPS):
            t0 = time.perf_counter()
            step(model, (x, y)).item()
            times.append((time.perf_counter() - t0) * 1e3)
        if tracer is not None:
            tracer.close()
        cost[f"TRACE={t} FLIGHT_RECORDER={f}"] += times[1:]
    os.environ.update(HVDTPU_TRACE="1", HVDTPU_FLIGHT_RECORDER="1",
                      HVDTPU_TRACE_DIR=trace_dir)
    coord._tracer = rt.tracer = traced
    tracing._set_active(traced)
    res["cost_ms"] = {k: _median(v) for k, v in cost.items()}
    from horovod_tpu_torch import telemetry
    snap = hvd.metrics_snapshot()
    telemetry.archive_snapshot(snap)   # to HVDTPU_METRICS_SNAPSHOT
    fams = snap["families"]
    res["families"] = sorted(fams)
    res["samples"] = {n: len(f["samples"]) for n, f in fams.items()}
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(res, f)


def trace_verdict(res, shards, trace, report, metrics_text):
    """The checks of ``[trace]``: the failures."""
    from horovod_tpu_torch.tracing import merge
    bad = []
    if len(shards) != 1 or shards[0]["meta"].get("rank") != 0:
        bad.append(f"expected one shard of rank 0, got "
                   f"{[s['meta'] for s in shards]}")
    else:
        spans = merge.collective_spans(shards[0])
        subs = [r for r in shards[0]["events"] if r.get("e") == "sub"]
        if len(spans) != len(subs) or not subs:
            bad.append(f"{len(subs)} submissions for {len(spans)} spans")
        unpaired = [k for k, sp in spans.items()
                    if sp["sub"] is None or sp["fin"] is None]
        errs = [k for k, sp in spans.items() if sp["err"]]
        if unpaired or errs:
            bad.append(f"spans without sub/fin {unpaired[:5]}, failed "
                       f"{errs[:5]}")
        # A CUDA fin is stamped when the card finished the collective.
        checked, short, _, _ = span_check(spans, res["responses"])
        if not checked or short:
            bad.append(f"{len(short)} of {checked} gradient allreduce spans "
                       f"shorter than their NCCL device time: {short[:5]}")
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M"}
    if "rank 0" not in tracks:
        bad.append(f"the merged trace has no track for rank 0: {tracks}")
    steps = [s for s in report["steps"] if s["critical_path"]]
    if len(steps) < TRACE_STEPS:
        bad.append(f"critical paths for {len(steps)} steps, expected "
                   f">= {TRACE_STEPS}")
    # The launcher's registry is empty (metrics are off in its process):
    # what it serves is the rank's pushed snapshot, rolled up as
    # <family>_cluster gauges, one per family, with samples or not.
    served = {line.split()[2] for line in metrics_text.splitlines()
              if line.startswith("# TYPE ")}
    coord = [n for n in res["families"] if n.startswith("hvd_coordinator_")
             or n in ("hvd_collective_abort_total", "hvd_overlap_fraction")]
    if len(coord) < 10:
        bad.append(f"metrics_snapshot() names the coordinator families "
                   f"{coord}")
    missing = [n for n in res["families"] if n + "_cluster" not in served]
    if missing:
        bad.append(f"the launcher's /metrics lacks {missing}")
    sampled = [n for n, k in res["samples"].items() if k]
    if not {"hvd_coordinator_ops_total", "hvd_coordinator_cycle_seconds",
            "hvd_backend_collective_seconds"} <= set(sampled):
        bad.append(f"families with samples: {sampled}")
    want = dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), PAR_LM["layers"])
    if any(per != want for per in res["launches"]):
        bad.append(f"launches per step {res['launches']}, expected {want}")
    if not all(math.isfinite(v) for v in res["losses"]) or \
            not res["losses"][-1] < res["losses"][0]:
        bad.append(f"losses {res['losses']} do not descend")
    return bad


def trace_phase():
    """Drive ``telemetry/`` and ``tracing/``: a KV store as the launcher
    runs it, and a one-rank job (``--trace-child``) that finds its peers
    through it. After the job: the launcher's ``/metrics``, the shard
    collected from the store, merged and analysed. Returns the kernels'
    launches in the traced steps."""
    import tempfile
    import urllib.request
    from horovod_tpu_torch.runner import http_server
    from horovod_tpu_torch.tracing import analyze, merge
    token = http_server.new_job_token()
    store = http_server.KVStoreServer(job_token=token, addr="127.0.0.1")
    store.start()
    try:
        with tempfile.TemporaryDirectory(prefix="hvd-trace-") as tmp:
            out = os.path.join(tmp, "trace.json")
            env = _one_rank_env(
                HVDTPU_TRACE="1", HOROVOD_TPU_METRICS="1",
                HVDTPU_METRICS_PUSH_INTERVAL="1",
                HVDTPU_TRACE_DIR=os.path.join(tmp, "traces"),
                HVDTPU_METRICS_SNAPSHOT=os.path.join(tmp, "metrics.json"),
                HVDTPU_RENDEZVOUS_ADDR="127.0.0.1",
                HVDTPU_RENDEZVOUS_PORT=str(store.port),
                HVDTPU_JOB_TOKEN=token)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--trace-child",
                 out], env=env, timeout=600)
            if proc.returncode != 0:
                fail(f"[trace] the one-rank job exited {proc.returncode}")
            with open(out) as f:
                res = json.load(f)
            with open(os.path.join(tmp, "metrics.json")) as f:
                archived = sorted(json.load(f)["families"])
            if archived != res["families"]:
                fail(f"[trace] the archived snapshot names {archived}, "
                     f"metrics_snapshot() {res['families']}")
            req = urllib.request.Request(
                f"http://127.0.0.1:{store.port}/metrics")
            req.add_header(http_server.AUTH_HEADER, token)
            with urllib.request.urlopen(req, timeout=30) as resp:
                metrics_text = resp.read().decode()
            paths = merge.collect_shards("127.0.0.1", store.port, token, 0,
                                         os.path.join(tmp, "collected"),
                                         max_ranks=1)
            shards = merge.load_paths(paths, kinds=(merge.SHARD_PREFIX,))
            trace = json.loads(json.dumps(merge.merge_shards(shards)))
            report = analyze.analyze(shards)
    finally:
        store.stop()
    n_sub = sum(1 for s in shards for r in s["events"] if r.get("e") == "sub")
    log(f"[trace] TransformerLM {PAR_LM['layers']} layers, batch "
        f"{TRAIN_BATCH} x 512, {TRACE_STEPS} AdamW steps under HVDTPU_TRACE=1"
        f" and HOROVOD_TPU_METRICS=1: losses "
        f"{[round(v, 6) for v in res['losses']]}; {n_sub} submissions "
        f"traced, {report['collectives']} collective spans; merged trace "
        f"{len(trace['traceEvents'])} events; {len(report['steps'])} steps "
        "analysed")
    for st in report["steps"][:TRACE_STEPS]:
        log(f"  step {st['step']}: {st['collectives']} collectives, "
            f"{(st['duration_s'] or 0) * 1e3:.2f} ms from first submit to "
            f"last completion, critical path {len(st['critical_path'])} "
            f"collectives ({st['critical_comm_s'] * 1e3:.2f} ms in flight, "
            f"{st['critical_gap_s'] * 1e3:.2f} ms between)")
    checked, short, span_ms, dev_ms = span_check(
        merge.collective_spans(shards[0]) if shards else {},
        res["responses"])
    log(f"[trace] sub→fin spans against NCCL device time: {checked} traced "
        f"allreduces in {len(res['responses'])} responses, median span "
        f"{span_ms} ms against median device time {dev_ms} ms; shorter: "
        f"{len(short)}")
    log(f"[trace] the launcher's /metrics: "
        f"{len(metrics_text.splitlines())} lines; metrics_snapshot() names "
        f"{len(res['families'])} families")
    log("[trace] cost of the plane (claims no gain; median step ms of "
        f"{2 * (TRACE_COST_STEPS - 1)} steps, two rounds in opposite "
        "orders, metrics on throughout): " + "; ".join(
            f"{k} {v:.1f}" for k, v in res["cost_ms"].items()))
    bad = trace_verdict(res, shards, trace, report, metrics_text)
    if bad:
        fail("[trace] " + "; ".join(bad))
    launches = {}
    for per in res["launches"]:
        for n, c in per.items():
            launches[n] = launches.get(n, 0) + c
    return launches


# ---------------------------------------------------------------------------
# [autotune], [chaos], [ha]: the autotuner, fault injection and control-plane
# HA on the flagship's path. Each is a launcher job of the port
# (``python -m horovod_tpu_torch.runner.launch``) whose worker is this
# script; the TransformerLM at full width runs through the native plane and
# NCCL in each, so the no-dropout kernels run on every step.
# ---------------------------------------------------------------------------
AUTOTUNE_GRID = dict(
    HVDTPU_AUTOTUNE_FUSION_CANDIDATES_MIB="0,32,128",
    HVDTPU_AUTOTUNE_CYCLE_CANDIDATES_MS="0.5,5",
    HVDTPU_AUTOTUNE_WARMUP_CYCLES="3",
    HVDTPU_AUTOTUNE_CYCLES_PER_CANDIDATE="4")
AUTOTUNE_MAX_STEPS = 60     # the sweep must converge within these
AUTOTUNE_AB_ROUNDS = 3      # winner / untuned turns, 3 steps each
CHAOS_STEPS = 8             # each run; the control, the injected, the HA
CHAOS_FAIL_STEP = 4         # the grad submission that fails (elastic run)
CHAOS_CKPT_STEPS = (2, 3)   # checkpoints; the newest is corrupted
CHAOS_RTOL = 1e-6
HA_KILL_AFTER = 3           # the primary dies after this step's commit
CARD_BACKEND = "nccl-global"   # the plane of a launcher job on the card
HA_LEASE = dict(HVDTPU_DRIVER_LEASE_INTERVAL="0.3",
                HVDTPU_DRIVER_LEASE_TIMEOUT="2",
                HVDTPU_HEARTBEAT_INTERVAL="0.25")


def _launcher_env(**extra):
    """This process's environment without any knob of the port, the
    checkout on PYTHONPATH, and ``extra``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=here, **extra)
    return env


def _child(child, out):
    """``python chip_smoke.py CHILD OUT``: a phase's worker command."""
    return [sys.executable, os.path.abspath(__file__), child, out]


def _launcher(args, child, out):
    """``python -m horovod_tpu_torch.runner.launch ARGS python
    chip_smoke.py CHILD OUT``."""
    return [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *args,
            *_child(child, out)]


def _discovery(tmp):
    script = os.path.join(tmp, "discover.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\necho localhost:1\n")
    os.chmod(script, 0o755)
    return script


def _check_launches(tag, per_step):
    """24 launches of each no-dropout kernel in every step."""
    want = dict.fromkeys(("fwd", "bwd_dkv", "bwd_dq"), 24)
    bad = [i + 1 for i, d in enumerate(per_step) if d != want]
    if bad or not per_step:
        fail(f"[{tag}] expected 24 launches of each no-dropout kernel per "
             f"step; steps {bad} differ")
    return {n: sum(d[n] for d in per_step) for n in want}


def _timed_steps(step, model, x, y, n, fa, coord=None):
    """``n`` steps: losses, host ms, launches and (with ``coord``) the
    knobs each ran under."""
    r = {"losses": [], "ms": [], "launches": [], "knobs": []}
    for _ in range(n):
        prev = dict(fa.LAUNCHES)
        if coord is not None:
            r["knobs"].append([coord.fusion_threshold,
                               coord.cycle_time_s * 1e3])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r["losses"].append(step(model, (x, y)).item())
        r["ms"].append((time.perf_counter() - t0) * 1e3)
        r["launches"].append({k: fa.LAUNCHES[k] - prev[k]
                              for k in ("fwd", "bwd_dkv", "bwd_dq")})
    return r


def autotune_phase(native_res):
    """``--autotune`` on the flagship: a one-rank launcher job sweeps
    fusion threshold x cycle time (the grid of ``AUTOTUNE_GRID``) until
    the tuner converges and writes its store; a second job against the
    same store warm-starts. Losses are held to [native]'s (the knobs do not
    change the arithmetic of a one-rank average)."""
    import tempfile
    runs = {}
    with tempfile.TemporaryDirectory(prefix="hvd-autotune-") as tmp:
        cache = os.path.join(tmp, "autotune.json")
        for tag in ("sweep", "warm"):
            out = os.path.join(tmp, f"{tag}.json")
            csv = os.path.join(tmp, f"{tag}.csv")
            # The store's key names the model explicitly: the derived key
            # hashes the names the flight ring holds when the warm-up
            # ends, which depends on how far step 1 got by then.
            env = _launcher_env(HVDTPU_AUTOTUNE_CACHE=cache,
                                HVDTPU_AUTOTUNE_SIGNATURE="transformerlm",
                                HVDTPU_LOG_LEVEL="info", **AUTOTUNE_GRID)
            t0 = time.perf_counter()
            rc, text = run_launcher(
                _launcher(["-np", "1", "--autotune", "--autotune-log-file",
                           csv], "--autotune-child", out),
                os.path.dirname(os.path.abspath(__file__)), env, 600)
            wall = time.perf_counter() - t0
            for line in text.splitlines():
                if "autotune" in line:
                    log("  | " + line[-300:])
            if rc != 0:
                log(text[-6000:])
                fail(f"[autotune] the {tag} launcher job exited {rc}")
            with open(out) as f:
                runs[tag] = json.load(f)
            runs[tag]["wall_s"] = wall
            runs[tag]["csv"] = (open(csv).read().splitlines()
                                if os.path.exists(csv) else [])
        with open(cache) as f:
            store = json.load(f)
    sweep, warm = runs["sweep"], runs["warm"]
    ref = native_res["transformer_losses"]
    bad = []
    for tag, r in runs.items():
        got = r["losses"][:len(ref)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
        log(f"[autotune] {tag}: losses of steps 1..{len(ref)} {got} against "
            f"[native]'s: max relative difference {rel:.2e} (limit "
            f"{NATIVE_TRANSFORMER_RTOL:.0e}); launcher job {r['wall_s']:.1f}"
            " s")
        if len(got) != len(ref) or rel > NATIVE_TRANSFORMER_RTOL:
            bad.append(f"{tag} losses differ from [native]'s")
    for arm, rnd, cand, score in sweep["history"]:
        log(f"[autotune] window score arm {arm} round {rnd} candidate "
            f"{cand}: {score:.6g} ({sweep['score_source']})")
    log(f"[autotune] sweep: converged after {sweep['converge_steps']} steps "
        f"({sweep['active_cycles']} active cycles); applied "
        f"{sweep['applied']}; winner {sweep['best']} (fusion threshold "
        f"bytes, cycle ms, min bucket); log file rows {sweep['csv']}")
    log(f"[autotune] store {sorted(store['entries'])}: "
        f"{[e['config'] for e in store['entries'].values()]}")
    if "winner_ms" not in sweep:
        fail("[autotune] the sweep did not converge")
    log(f"[autotune] step ms under the winner {sweep['winner_ms']:.1f} "
        f"against the untuned (128 MiB, 1 ms) {sweep['untuned_ms']:.1f} "
        f"({sweep['winner_ms'] - sweep['untuned_ms']:+.1f} ms; median of "
        f"{AUTOTUNE_AB_ROUNDS} rounds of 3 steps each, in turns)")
    log(f"[autotune] warm: applied {warm['applied']} after "
        f"{warm['converge_steps']} steps, windows scored "
        f"{len(warm['history'])}, winner {warm['best']}")
    if sweep["enabled"] or not sweep["history"]:
        bad.append("the sweep did not converge")
    if not store["entries"]:
        bad.append("the store holds no entry")
    if sweep["applied"][-1] != warm["applied"][0] or len(warm["applied"]) \
            != 1 or warm["history"] or warm["enabled"]:
        bad.append("the rerun was no warm-start hit of the sweep's winner")
    if warm["best"] != [max(sweep["best"][0], 1)] + sweep["best"][1:]:
        bad.append("the warm-started winner differs from the sweep's")
    if bad:
        fail("[autotune] " + "; ".join(bad))
    return {n: sweep["launch_sum"][n] + warm["launch_sum"][n]
            for n in sweep["launch_sum"]}


def autotune_child(out):
    """The worker of ``autotune_phase`` (``chip_smoke.py --autotune-child
    OUT``): rank 0 of a one-rank launcher job under ``--autotune``; trains
    until the tuner converged (at least 5 steps), then times the winner
    against the untuned knobs in turns."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, models
    from horovod_tpu_torch import coordinator as coord_mod
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    rt = basics.runtime()
    tuner, coord = rt.autotuner, rt.coordinator
    if tuner is None or rt.backend.name != CARD_BACKEND:
        fail(f"[autotune] expected the tuner on the NCCL-delegated plane, "
             f"got {tuner} on {rt.backend.name}")
    cfg, model, step, x, y = transformer_setup(hvd, models)
    fa.reset_launches()
    r = {"losses": [], "ms": [], "launches": [], "knobs": []}
    while len(r["losses"]) < AUTOTUNE_MAX_STEPS and (
            tuner.enabled or len(r["losses"]) < TRAIN_STEPS):
        for k, v in _timed_steps(step, model, x, y, 1, fa, coord).items():
            r[k] += v
    by_arm = {a.name: a for a in tuner._arms}
    res = {"losses": r["losses"], "converge_steps": len(r["losses"]),
           "enabled": tuner.enabled, "active_cycles": tuner._cycle,
           "applied": [list(a) for a in tuner.applied],
           "best": list(tuner.best) if tuner.best is not None else None,
           "score_source": tuner._score_label,
           "history": [[arm, rnd, by_arm[arm].fmt(by_arm[arm].candidates[i]),
                        m] for arm, rnd, i, m in tuner._history],
           "launch_sum": _check_launches("autotune", r["launches"])}
    if not tuner.enabled and tuner._history:
        # The sweep's run: the winner against the untuned knobs.
        winner = (coord.fusion_threshold, coord.cycle_time_s)
        untuned = (coord_mod.DEFAULT_FUSION_THRESHOLD,
                   coord_mod.DEFAULT_CYCLE_TIME_MS / 1e3)

        def apply(knobs):
            coord.fusion_threshold, coord.cycle_time_s = knobs
            rt.backend.core.set_fusion_threshold(knobs[0])
        times = {"winner": [], "untuned": []}
        for i in range(AUTOTUNE_AB_ROUNDS):
            order = (("winner", winner), ("untuned", untuned))
            for tag, knobs in (order if i % 2 == 0 else order[::-1]):
                apply(knobs)
                t = _timed_steps(step, model, x, y, 3, fa)
                times[tag].append(_median(t["ms"]))
        apply(winner)
        res["winner_ms"] = _median(times["winner"])
        res["untuned_ms"] = _median(times["untuned"])
    hvd.shutdown()
    with open(out, "w") as f:
        json.dump(res, f)


def chaos_phase(native_res):
    """Fault injection on the flagship under ``hvd.elastic.run``: a
    one-rank elastic launcher job (``--chaos-child``) trains an uninjected
    control, then the same steps with ``collective:fail`` on the grad
    submission of step ``CHAOS_FAIL_STEP`` (a HorovodInternalError, an
    in-process reset) and checkpoints after steps 2 and 3, the newest
    corrupted by ``checkpoint:corrupt``; it then restores the newest intact
    step and resumes. Returns the kernels' launches and the control's
    losses (the [ha] phase's uninterrupted run)."""
    import shutil
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hvd-chaos-") as tmp:
        need = 2 * 3 * 365_000_000 * 4
        free = shutil.disk_usage(tmp).free
        if free < 1.5 * need:
            fail(f"[chaos] {tmp} has {free / 1e9:.1f} GB free; the phase "
                 f"writes about {need / 1e9:.1f} GB")
        out = os.path.join(tmp, "chaos.json")
        chaos_log = os.path.join(tmp, "chaos.log")
        spec = (f"collective:fail:name=grad:"
                f"after={CHAOS_STEPS + CHAOS_FAIL_STEP - 1}:once;"
                f"checkpoint:corrupt:name=step_{CHAOS_CKPT_STEPS[-1]}")
        env = _launcher_env(HVDTPU_CHAOS=spec, HVDTPU_CHAOS_LOG=chaos_log,
                            HOROVOD_TPU_METRICS="1",
                            HVDTPU_LOG_LEVEL="info")
        t0 = time.perf_counter()
        rc, text = run_launcher(
            _launcher(["-np", "1", "--min-np", "1", "--max-np", "1",
                       "--host-discovery-script", _discovery(tmp)],
                      "--chaos-child", out),
            os.path.dirname(os.path.abspath(__file__)), env, 900)
        wall = time.perf_counter() - t0
        for line in text.splitlines():
            if "chaos" in line or "elastic" in line.lower():
                log("  | " + line[-300:])
        if rc != 0 or not os.path.exists(out):
            log(text[-6000:])
            fail(f"[chaos] the elastic launcher job exited {rc}")
        with open(out) as f:
            res = json.load(f)
        fired = open(chaos_log).read().splitlines() \
            if os.path.exists(chaos_log) else []
    ctl = res["control"]
    bad = []
    ref = native_res["transformer_losses"]
    rel_n = max(abs(a - b) / abs(b) for a, b in zip(ctl[:len(ref)], ref))
    got = [res["losses"][str(s)] for s in range(1, CHAOS_STEPS + 1)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ctl))
    res_got = res["resumed"]
    first = CHAOS_CKPT_STEPS[0] + 1
    rel_r = max(abs(a - b) / abs(b)
                for a, b in zip(res_got, ctl[first - 1:]))
    log(f"[chaos] control (uninjected) losses {ctl}; steps 1..{len(ref)} "
        f"against [native]'s: max relative difference {rel_n:.2e}")
    log(f"[chaos] HVDTPU_CHAOS={res['spec']!r}: firings "
        f"{[ln.split(' ', 1)[1] for ln in fired]}; "
        f"hvd_chaos_injections_total {res['injections']}")
    log(f"[chaos] collective fail at step {CHAOS_FAIL_STEP}: "
        f"{res['caught']}; elastic versions joined {res['versions']}; "
        f"losses {got} against the control's: max relative difference "
        f"{rel:.2e} (limit {CHAOS_RTOL:.0e}), bit-equal {got == ctl}")
    log(f"[chaos] reset s {res['reset_ms'] / 1e3:.3f} (shutdown "
        f"{res['reset_parts']['shutdown'] / 1e3:.3f}, init "
        f"{res['reset_parts']['init'] / 1e3:.3f}); restore of the last "
        f"commit {res['restore_commit_ms']:.1f} ms")
    log(f"[chaos] checkpoints {res['kept']}: step_{CHAOS_CKPT_STEPS[-1]} "
        f"verified {res['verified']} ({res['verify_reason']}); "
        f"restore_latest took step {res['restored_step']} in "
        f"{res['restore_s']:.2f} s (save {res['save_s']}); resumed steps "
        f"{first}..{CHAOS_STEPS} {res_got} against the control's: max "
        f"relative difference {rel_r:.2e} (limit {CHAOS_RTOL:.0e}); "
        f"launcher job {wall:.1f} s")
    if rel > CHAOS_RTOL:
        bad.append("the injected run's losses differ from the control's")
    if rel_r > CHAOS_RTOL:
        bad.append("the resumed losses differ from the control's")
    if rel_n > NATIVE_TRANSFORMER_RTOL:
        bad.append("the control differs from [native]")
    if res["versions"] != [0, 1] or res["caught"] != 1:
        bad.append("expected one HorovodInternalError and one in-process "
                   "reset (elastic versions 0 then 1)")
    if res["restored_step"] != CHAOS_CKPT_STEPS[0] or res["verified"]:
        bad.append("the corrupted checkpoint was not passed over")
    kinds = sorted(" ".join(ln.split()[1:3]) for ln in fired)
    if kinds != ["checkpoint corrupt", "collective fail"]:
        bad.append(f"HVDTPU_CHAOS_LOG names {kinds}")
    if res["injections"] != {"checkpoint/corrupt": 1, "collective/fail": 1}:
        bad.append(f"hvd_chaos_injections_total {res['injections']}")
    if bad:
        fail("[chaos] " + "; ".join(bad))
    return res["launch_sum"], ctl


def chaos_child(out):
    """The worker of ``chaos_phase`` (``chip_smoke.py --chaos-child OUT``):
    an elastic worker of a one-rank launcher job on the card."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import basics, checkpoint, models, telemetry
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    rt = basics.runtime()
    if rt.backend.name != CARD_BACKEND:
        fail(f"[chaos] expected the NCCL-delegated plane, got "
             f"{rt.backend.name}")
    tmp = os.path.dirname(out)
    ckpt_dir = os.path.join(tmp, "ckpt")
    fa.reset_launches()
    launches = []
    cfg, model, step, x, y = transformer_setup(hvd, models)
    c = _timed_steps(step, model, x, y, CHAOS_STEPS, fa)
    launches += c["launches"]
    res = {"control": c["losses"], "spec": os.environ["HVDTPU_CHAOS"],
           "versions": [int(os.environ["HVDTPU_ELASTIC_VERSION"])],
           "losses": {}, "caught": 0, "save_s": []}
    del model, step
    torch.cuda.empty_cache()
    cfg, model, step, x, y = transformer_setup(hvd, models)
    opt = step.optimizer

    class TimedState(hvd_torch.elastic.TorchState):
        def restore(self):
            res["caught"] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().restore()
            torch.cuda.synchronize()
            res["restore_commit_ms"] = (time.perf_counter() - t0) * 1e3

    def after_reset():
        res["versions"].append(int(os.environ["HVDTPU_ELASTIC_VERSION"]))
        down, up = (basics.LAST_TIMES["shutdown"], basics.LAST_TIMES["init"])
        res["reset_ms"] = down["total"] + up["total"]
        res["reset_parts"] = {"shutdown": down["total"],
                              "init": up["total"]}

    state = TimedState(model, opt, step=0)
    state.register_reset_callbacks([after_reset])

    @hvd_torch.elastic.run
    def train_loop(state):
        while state.step < CHAOS_STEPS:
            s = state.step + 1
            r = _timed_steps(step, model, x, y, 1, fa)
            launches.extend(r["launches"])
            res["losses"][str(s)] = r["losses"][0]
            state.step = s
            state.commit()
            if s in CHAOS_CKPT_STEPS:
                t0 = time.perf_counter()
                checkpoint.save_step(ckpt_dir, s, {
                    "model": model.state_dict(), "opt": opt.state_dict()})
                res["save_s"].append(round(time.perf_counter() - t0, 2))
        return state.step

    train_loop(state)
    newest = os.path.join(ckpt_dir, f"step_{CHAOS_CKPT_STEPS[-1]}")
    res["verified"], res["verify_reason"] = \
        checkpoint.verify_checkpoint(newest)
    res["kept"] = sorted(checkpoint._list_steps(ckpt_dir))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_step, saved = checkpoint.restore_latest(ckpt_dir)
    model.load_state_dict(checkpoint.to_tensors(saved["model"]))
    opt.load_state_dict(checkpoint.to_tensors(saved["opt"]))
    torch.cuda.synchronize()
    res["restore_s"] = time.perf_counter() - t0
    res["restored_step"] = got_step
    del saved
    r = _timed_steps(step, model, x, y, CHAOS_STEPS - got_step, fa)
    launches += r["launches"]
    res["resumed"] = r["losses"]
    fam = telemetry.snapshot()["families"].get(
        "hvd_chaos_injections_total", {})
    res["injections"] = {
        f"{s['labels']['point']}/{s['labels']['action']}": s["value"]
        for s in fam.get("samples", ())}
    res["launch_sum"] = _check_launches("chaos", launches)
    with open(out, "w") as f:
        json.dump(res, f)
    hvd.shutdown()


def ha_phase(control_losses):
    """Control-plane HA on the flagship: a primary launcher with
    ``--journal-dir`` and ``--standby-endpoints``, a warm standby launcher
    (``--standby``), one elastic worker (``--ha-child``). The worker
    removes the marker of the primary's ``driver:kill`` rule after step
    ``HA_KILL_AFTER``, so that the kill lands mid-job; the standby promotes
    at term 2 and adopts the worker, whose KV client fails over. Losses are
    held to [chaos]'s uninterrupted control."""
    import socket
    import tempfile
    from horovod_tpu_torch.runner import http_client, http_server
    with tempfile.TemporaryDirectory(prefix="hvd-ha-") as tmp:
        ports = []
        for _ in range(2):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                ports.append(sock.getsockname()[1])
        p_port, s_port = ports
        token = http_server.new_job_token()
        marker = os.path.join(tmp, "kill.marker")
        open(marker, "w").close()
        chaos_log = os.path.join(tmp, "chaos.log")
        out = os.path.join(tmp, "ha")
        here = os.path.dirname(os.path.abspath(__file__))
        base = ["-np", "1", "--min-np", "1", "--max-np", "1",
                "--host-discovery-script", _discovery(tmp)]
        env = _launcher_env(HVDTPU_JOB_TOKEN=token, HOROVOD_TPU_METRICS="1",
                            HVDTPU_LOG_LEVEL="info", **HA_LEASE)
        s_out = open(os.path.join(tmp, "standby.txt"), "w")
        standby = subprocess.Popen(
            _launcher(base + ["--standby", f"127.0.0.1:{p_port}"],
                      "--ha-child", out), cwd=here,
            env=dict(env, HVDTPU_DRIVER_PORT=str(s_port)), stdout=s_out,
            stderr=subprocess.STDOUT)
        p_out = open(os.path.join(tmp, "primary.txt"), "w")
        primary = subprocess.Popen(
            _launcher(base + ["--journal-dir", os.path.join(tmp, "journal"),
                              "--standby-endpoints", f"127.0.0.1:{s_port}",
                              "--driver-port", str(p_port)],
                      "--ha-child", out), cwd=here,
            env=dict(env, HVDTPU_CHAOS=f"driver:kill:wid=primary:after=20:"
                                       f"marker={marker}",
                     HVDTPU_CHAOS_LOG=chaos_log, HA_KILL_MARKER=marker),
            stdout=p_out, stderr=subprocess.STDOUT)
        promoted_at = None
        try:
            p_rc = primary.wait(timeout=600)
            t_exit = time.time()
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                term = http_client.probe_term("127.0.0.1", s_port,
                                              token=token, timeout=1)
                if term is not None and term >= 2:
                    promoted_at = time.time()
                    break
                time.sleep(0.02)
            s_rc = standby.wait(timeout=600)
        finally:
            for proc in (primary, standby):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            p_out.close()
            s_out.close()
        texts = {n: open(os.path.join(tmp, f"{n}.txt")).read()
                 for n in ("primary", "standby")}
        kill_t = (os.path.getmtime(chaos_log) if os.path.exists(chaos_log)
                  else None)
        fired = open(chaos_log).read().splitlines() \
            if os.path.exists(chaos_log) else []
        worker_log = (open(out + ".log").read()
                      if os.path.exists(out + ".log") else "")
        if not os.path.exists(out + ".json"):
            log(texts["primary"][-4000:] + texts["standby"][-4000:]
                + worker_log[-4000:])
            fail("[ha] the worker reported nothing")
        with open(out + ".json") as f:
            res = json.load(f)
    for line in texts["standby"].splitlines():
        if "standby" in line or "PRIMARY" in line:
            log("  | " + line[-300:])
    got = res["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, control_losses))
    gaps = [b - a for a, b in zip(res["step_t"], res["step_t"][1:])]
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    bad = []
    log(f"[ha] primary exit {p_rc} (SIGKILL by driver:kill, firings "
        f"{fired}), standby exit {s_rc}; kill to promotion "
        f"{promoted_at - kill_t:.2f} s (lease timeout "
        f"{HA_LEASE['HVDTPU_DRIVER_LEASE_TIMEOUT']} s, interval "
        f"{HA_LEASE['HVDTPU_DRIVER_LEASE_INTERVAL']} s; primary exit "
        f"observed {t_exit - kill_t:.2f} s after the kill)"
        if promoted_at and kill_t else
        f"[ha] primary exit {p_rc}, standby exit {s_rc}, no promotion seen")
    log(f"[ha] worker pid {res['pids']}, elastic versions {res['versions']},"
        f" resets {res['resets']}, KV term {res['term']}; "
        f"hvd_kv_endpoint_failover_total {res['kv_failovers']}, the "
        f"promoted standby's hvd_driver_failover_total "
        f"{res['driver_failovers']}; longest step gap {gaps[worst]:.2f} s "
        f"(after step {worst + 1}; the median gap "
        f"{_median(gaps):.3f} s)")
    log(f"[ha] losses {got} against the uninterrupted control's: max "
        f"relative difference {rel:.2e} (limit {CHAOS_RTOL:.0e}), bit-equal "
        f"{got == control_losses}")
    if p_rc != -9 or not fired:
        bad.append(f"the primary was not killed by driver:kill (exit {p_rc})")
    if s_rc != 0:
        bad.append(f"the standby launcher exited {s_rc}")
    if promoted_at is None or res["term"] < 2:
        bad.append("the standby never promoted at term 2")
    if "1 workers adopted" not in texts["standby"]:
        bad.append("the standby adopted no worker")
    if len(set(res["pids"])) != 1 or res["versions"] != [0, 0] \
            or res["resets"]:
        bad.append("the worker was respawned or reset")
    if res["kv_failovers"] < 1 or res["driver_failovers"] != 1:
        bad.append("the failover counters are wrong")
    if len(got) != CHAOS_STEPS or rel > CHAOS_RTOL:
        bad.append("losses differ from the uninterrupted run's")
    if bad:
        log(worker_log[-3000:])
        fail("[ha] " + "; ".join(bad))
    return res["launch_sum"]


def ha_child(out):
    """The worker of ``ha_phase`` (``chip_smoke.py --ha-child OUT``): an
    elastic worker whose launcher dies mid-job. Its output goes to
    ``OUT.log`` (the dead primary's pipe would fail every write)."""
    fd = os.open(out + ".log", os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import urllib.request
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import basics, models, telemetry
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.runner import http_client, http_server
    from horovod_tpu_torch.runner import rendezvous as rdv
    marker = os.environ["HA_KILL_MARKER"]
    hvd.init()
    rt = basics.runtime()
    backend = rt.backend
    res = {"pids": [os.getpid()], "losses": [], "step_t": [], "resets": 0,
           "versions": [int(os.environ["HVDTPU_ELASTIC_VERSION"])]}
    launches = []
    cfg, model, step, x, y = transformer_setup(hvd, models)
    state = hvd_torch.elastic.TorchState(model, step.optimizer, step=0)
    state.register_reset_callbacks(
        [lambda: res.__setitem__("resets", res["resets"] + 1)])

    @hvd_torch.elastic.run
    def train_loop(state):
        while state.step < CHAOS_STEPS:
            s = state.step + 1
            r = _timed_steps(step, model, x, y, 1, fa)
            launches.extend(r["launches"])
            res["losses"].append(r["losses"][0])
            state.step = s
            state.commit()
            res["step_t"].append(time.time())
            if s == HA_KILL_AFTER:
                os.remove(marker)   # the primary's driver:kill fires now
        # Before returning: elastic.run then leaves the exit marker the
        # promoted standby reaps.
        addr, port, token = rdv.rendezvous_config()
        req = urllib.request.Request(f"http://{addr}:{port}/metrics")
        req.add_header(http_server.AUTH_HEADER, token)
        with urllib.request.urlopen(req, timeout=30) as resp:
            text = resp.read().decode()
        found = re.findall(r"^hvd_driver_failover_total(?:\{[^}]*\})? "
                           r"(\S+)$", text, re.M)
        res["driver_failovers"] = float(found[0]) if found else 0
        fam = telemetry.snapshot()["families"].get(
            "hvd_kv_endpoint_failover_total", {})
        res["kv_failovers"] = sum(s["value"] for s in fam.get("samples", ()))
        res["term"] = http_client.known_term()
        res["pids"].append(os.getpid())
        res["versions"].append(int(os.environ["HVDTPU_ELASTIC_VERSION"]))
        res["same_backend"] = basics.runtime().backend is backend
        res["launch_sum"] = _check_launches("ha", launches)
        with open(out + ".json", "w") as f:
            json.dump(res, f)
        return state.step

    train_loop(state)
    hvd.shutdown()


SERVING_REQUESTS = 32
SERVING_PROMPT = (8, 512)        # prompt tokens, drawn per request
SERVING_NEW = (16, 256)          # max_new_tokens, drawn per request
# The knob default of 256 would refuse (413) every prompt over 256 tokens;
# the budget here takes the longest prompt the draw can give.
SERVING_BATCH_TOKENS = 512
SERVING_DRAIN_REQUESTS = 8
SERVING_DRAIN_NEW = 256
SERVING_SHARDS = 4               # plan_zero(n=4): the train cohort
SERVING_ROWS = 4                 # serving world of the rows layout


def serving_state_check(models):
    """Train -> serve state at full width: the flagship's parameters (on
    the card) packed into ``plan_zero(n=4)`` flat bucket shards, as ZeRO-1
    lays them out, then assembled back by ``load_from_shards`` replicated
    at serving world 1 and in rows on each host of serving world 4, and
    ``load_for_inference`` of the live ``state_dict()``. Every leaf must
    be bit-equal to the parameter it came from."""
    from horovod_tpu_torch.ops.zero import plan_zero
    from horovod_tpu_torch.serving import state
    from horovod_tpu_torch.utils import tree
    cfg = models.TransformerConfig(
        vocab_size=30522, hidden=1024, layers=24, heads=16, max_len=512,
        causal=True, use_rope=True, attention_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = models.TransformerLM(cfg, device="cuda", generator=gen)
    names = [n for n, _ in model.named_parameters()]
    leaves = [p.detach() for p in model.parameters()]
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    plan = plan_zero(leaves, SERVING_SHARDS)
    shards = {r: [] for r in range(SERVING_SHARDS)}
    for b, s in zip(plan.buckets, plan.shards):
        buf = torch.zeros(s.padded, dtype=b.dtype, device="cuda")
        off = 0
        for i in b.indices:
            n = leaves[i].numel()
            buf[off:off + n] = leaves[i].reshape(-1)
            off += n
        for r in range(SERVING_SHARDS):
            shards[r].append(buf[r * s.shard_len:(r + 1) * s.shard_len])
    torch.cuda.synchronize()
    out = {"params": sum(x.numel() for x in leaves), "leaves": len(leaves),
           "bytes": nbytes, "buckets": len(plan.buckets)}

    def load(world, host, layout):
        t0 = time.perf_counter()
        got, report = state.load_from_shards(shards, plan, world, host,
                                             layout)
        torch.cuda.synchronize()
        return got, report, time.perf_counter() - t0

    got, report, secs = load(1, 0, state.REPLICATED)
    ranges, _ = state.plan_inference_ranges(plan, 1, state.REPLICATED)
    if not all(torch.equal(g, x) for g, x in zip(got, leaves)):
        fail("[serving] load_from_shards (replicated) is not bit-equal to "
             "the parameters")
    out["replicated"] = {"ranges": sum(len(r) for r in ranges[0]),
                         "gather_free": report["gather_free_leaves"],
                         "ms": secs * 1e3, "gbps": nbytes / secs / 1e9}
    del got
    ranges, _ = state.plan_inference_ranges(plan, SERVING_ROWS, state.ROWS)
    rows = []
    for host in range(SERVING_ROWS):
        got, report, secs = load(SERVING_ROWS, host, state.ROWS)
        want = []
        for x in leaves:
            lo, hi = state.row_slice(x.shape[0], SERVING_ROWS, host)
            want.append(x[lo:hi])
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            fail(f"[serving] load_from_shards (rows, host {host}) is not "
                 "bit-equal to the parameters' row slices")
        part = sum(g.numel() * g.element_size() for g in got)
        rows.append({"ranges": sum(len(r) for r in ranges[host]),
                     "gather_free": report["gather_free_leaves"],
                     "ms": secs * 1e3, "gbps": part / secs / 1e9})
        del got
    out["rows"] = rows
    sd = model.state_dict()
    for layout, world in ((state.REPLICATED, 1), (state.ROWS, SERVING_ROWS)):
        for host in range(world):
            live = state.load_for_inference(sd, world, host, layout)
            for name in names:
                x = sd[name]
                lo, hi = (state.row_slice(x.shape[0], world, host)
                          if layout == state.ROWS else (0, x.shape[0]))
                if not torch.equal(live[name], x[lo:hi]):
                    fail(f"[serving] load_for_inference ({layout}, host "
                         f"{host}) {name} is not bit-equal")
    out["live_leaves"] = len(tree.leaves(live))
    del model, sd, shards, leaves, live
    torch.cuda.empty_cache()
    return out


def serving_sync_count(reqs):
    """A ``Scheduler`` (ToyLM and pool on the card, the knob defaults but
    the batch budget) driven alone over ``reqs`` with the CUDA sync debug
    mode on: the host syncs of each decode step, and the streams."""
    from horovod_tpu_torch.serving import model, scheduler
    m = model.ToyLM()
    s = scheduler.Scheduler(m, max_batch_tokens=SERVING_BATCH_TOKENS)
    results = [s.submit(scheduler.Request(f"s{i}", p, n))
               for i, (p, n) in enumerate(reqs)]
    if any(r is None for r in results):
        fail("[serving] the sync-count scheduler refused a request")
    per_step = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        while not all(r.done.is_set() for r in results):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if not s.step():
                    fail("[serving] the sync-count scheduler stalled")
            per_step.append(sum("synchroniz" in str(w.message)
                                for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for r, (p, n) in zip(results, reqs):
        if r.tokens(timeout=1) != m.reference_completion(p, n):
            fail("[serving] a stream of the scheduler driven alone differs "
                 "from the oracle")
    st = s.stats()
    return {"steps": len(per_step), "min": min(per_step),
            "max": max(per_step), "mean": sum(per_step) / len(per_step),
            "preemptions": st["preemptions"],
            "admission_blocked": st["admission_blocked"]}


def _serving_post(port, path, payload, token, timeout=300):
    import urllib.error
    import urllib.request
    from horovod_tpu_torch.runner.http_server import AUTH_HEADER
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        method="POST")
    req.add_header(AUTH_HEADER, token)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else {})


def _serving_burst(port, token, reqs, prefix, queued=None):
    """``reqs`` sent to ``port``'s ``/v1/generate``, one thread each:
    ``[(status, body, seconds)]`` in request order. With ``queued`` (the
    requests the workers hold queued), each thread starts once the one
    before it is queued: the router's round robin and each worker's queue
    then take the burst in request order, so a burst queued before the
    loops start runs the same way every time."""
    import threading
    out = [None] * len(reqs)

    def send(i, prompt, n):
        t0 = time.perf_counter()
        status, body = _serving_post(port, "/v1/generate",
                                     {"id": f"{prefix}{i}", "prompt": prompt,
                                      "max_new_tokens": n}, token)
        out[i] = (status, body, time.perf_counter() - t0)

    threads = [threading.Thread(target=send, args=(i, p, n))
               for i, (p, n) in enumerate(reqs)]
    for i, t in enumerate(threads):
        deadline = time.monotonic() + 60
        while queued is not None and queued() < i:
            if time.monotonic() > deadline:
                fail(f"[serving] {prefix}: request {i - 1} was never "
                     "queued")
            time.sleep(0.001)
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(o is None for o in out):
        fail(f"[serving] {prefix}: a request did not return")
    return out


def _serving_metric(telemetry, name):
    """The sum of a family's samples in this process's registry."""
    fam = telemetry.registry().snapshot()["families"].get(name, {})
    return sum(x["value"] for x in fam.get("samples", []))


def serving_phase(models):
    """The serving plane on the card (see the module docstring)."""
    import threading
    from horovod_tpu_torch.runner.http_server import (KVStoreServer,
                                                      new_job_token)
    from horovod_tpu_torch.serving import worker as sworker
    from horovod_tpu_torch.serving.router import Router
    from horovod_tpu_torch.telemetry import core as telemetry
    t0 = time.perf_counter()
    st = serving_state_check(models)
    log(f"[serving] state: {st['params']} params in {st['leaves']} leaves "
        f"({st['bytes'] / 1e9:.3f} GB fp32), plan_zero(n={SERVING_SHARDS}) "
        f"{st['buckets']} buckets of 16 MiB; load_from_shards replicated "
        f"(world 1): {st['replicated']['ranges']} ranges, "
        f"{st['replicated']['gather_free']}/{st['leaves']} leaves "
        f"gather-free, {st['replicated']['ms']:.1f} ms, "
        f"{st['replicated']['gbps']:.1f} GB/s; rows (world {SERVING_ROWS}) "
        + "; ".join(f"host {h}: {r['ranges']} ranges, {r['gather_free']}/"
                    f"{st['leaves']} gather-free, {r['ms']:.1f} ms, "
                    f"{r['gbps']:.1f} GB/s" for h, r in enumerate(st["rows"]))
        + f"; bit-equal; load_for_inference of the state_dict bit-equal "
        f"({st['live_leaves']} leaves, views)")
    log(f"[time] serving.state {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVING_PROMPT[0], SERVING_PROMPT[1] + 1,
                        SERVING_REQUESTS)
    news = rng.integers(SERVING_NEW[0], SERVING_NEW[1] + 1,
                        SERVING_REQUESTS)
    reqs = [(rng.integers(0, 97, int(n)).tolist(), int(m))
            for n, m in zip(lens, news)]
    t1 = time.perf_counter()
    sync = serving_sync_count(reqs[:SERVING_REQUESTS // 2])
    if sync["min"] != 1 or sync["max"] != 1:
        fail(f"[serving] host syncs per decode step {sync['min']}.."
             f"{sync['max']}, expected 1")
    log(f"[serving] one scheduler alone: {sync['steps']} decode steps, "
        f"host syncs per step min {sync['min']} max {sync['max']}, "
        f"{sync['preemptions']} preemptions, {sync['admission_blocked']} "
        f"admissions blocked, streams equal to the oracle "
        f"({time.perf_counter() - t1:.1f} s)")

    old_metrics = os.environ.get("HOROVOD_TPU_METRICS")
    os.environ["HOROVOD_TPU_METRICS"] = "1"
    telemetry.reset()
    token = new_job_token()
    kv = KVStoreServer(job_token=token, addr="127.0.0.1")
    kv_port = kv.start()
    workers, ports, router = [], [], None
    loop_syncs = {}
    shown = warnings.showwarning

    def count_syncs(message, *args, **kw):
        name = threading.current_thread().name
        if "synchroniz" in str(message) and name.startswith("hvd-serving"):
            loop_syncs[name] = loop_syncs.get(name, 0) + 1
            return
        shown(message, *args, **kw)

    try:
        for wid in range(2):
            w = sworker.ServingWorker(cohort="c0", wid=wid,
                                      max_batch_tokens=SERVING_BATCH_TOKENS)
            workers.append(w)
            ports.append(w.serve_http(addr="127.0.0.1", token=token))
            w.register("127.0.0.1", kv_port, token,
                       advertise=f"127.0.0.1:{ports[-1]}")
        knobs = sworker.knob_defaults()
        router = Router(kv=("127.0.0.1", kv_port, token))
        if router.refresh_from_kv(["c0"]) != {"c0": 2}:
            fail("[serving] the router did not find both workers")
        rport = router.serve_http(addr="127.0.0.1", token=token)
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=".*synchroniz.*")
            warnings.showwarning = count_syncs
            torch.cuda.set_sync_debug_mode("warn")
            try:
                # The burst is queued in request order before the workers'
                # loops start, so it runs the same way every run and
                # presses the pool (sent all at once, the arrival order
                # decided the split, and some runs on the card never
                # preempted or migrated).
                out = {}
                sender = threading.Thread(target=lambda: out.update(
                    res=_serving_burst(rport, token, reqs, "burst",
                                       queued=lambda: sum(
                                           w.scheduler.stats()["queue_depth"]
                                           for w in workers))))
                sender.start()
                deadline = time.monotonic() + 120
                while sum(w.scheduler.stats()["queue_depth"]
                          for w in workers) < SERVING_REQUESTS:
                    if time.monotonic() > deadline:
                        fail("[serving] the burst never all queued")
                    time.sleep(0.002)
                t2 = time.perf_counter()
                for w in workers:
                    w.start()
                sender.join(timeout=600)
                wall = time.perf_counter() - t2
            finally:
                torch.cuda.set_sync_debug_mode("default")
        res = out.get("res")
        if res is None:
            fail("[serving] the burst did not return")
        bad = [i for i, (status, body, _) in enumerate(res)
               if status != 200 or body.get("tokens")
               != workers[0].model.reference_completion(*reqs[i])]
        if bad:
            fail(f"[serving] streams {bad} differ from the oracle: "
                 f"{[res[i][:2] for i in bad][:2]}")
        stats = [w.scheduler.stats() for w in workers]
        steps = sum(x["steps"] for x in stats)
        exports = sum(x["migrated_out"] + x["migrate_failed"]
                      for x in stats)
        moved = sum(x["migrated_out"] for x in stats)
        preempted = sum(x["preemptions"] for x in stats)
        blocked = sum(x["admission_blocked"] for x in stats)
        if blocked < 1 or preempted + moved < 1:
            fail(f"[serving] the burst blocked admission {blocked} times "
                 f"and preempted or migrated {preempted + moved}: the "
                 "pool was never pressed")
        lat = sorted(t for _, _, t in res)
        tokens = sum(len(b["tokens"]) for _, b, _ in res)
        per_step = (sum(loop_syncs.values()) - exports) / steps
        log(f"[serving] HTTP: router + 2 workers (pool {knobs['num_pages']} "
            f"x {knobs['page_size']} slots, queue {knobs['queue_limit']}, "
            f"batch budget {SERVING_BATCH_TOKENS}), {SERVING_REQUESTS} "
            f"requests queued, then the loops started (prompt "
            f"{int(lens.min())}-{int(lens.max())}, new "
            f"{int(news.min())}-{int(news.max())}; "
            f"{int((lens + news).sum())} slots asked of "
            f"{2 * knobs['num_pages'] * knobs['page_size']}): all streams "
            f"equal the oracle; {tokens} tokens in {wall:.2f} s = "
            f"{tokens / wall:.1f} tokens/s; latency p50 "
            f"{lat[len(lat) // 2]:.3f} s p99 "
            f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.3f} s; "
            f"{steps} decode steps; admission blocked {blocked}; "
            f"preemptions {preempted}; migrations {moved} (+"
            f"{exports - moved} refused); loop-thread host syncs "
            f"{sum(loop_syncs.values())} = {steps} steps x {per_step:.3f} "
            f"+ {exports} page exports")
        if per_step != 1.0:
            fail(f"[serving] {per_step:.3f} host syncs per decode step in "
                 "the workers' loops, expected 1")
        log(f"[time] serving.http {time.perf_counter() - t2:.1f} s")

        # Drain with live migration: 8 long streams on worker 0, drained
        # in mid-flight; a direct client follows the handoff.
        t3 = time.perf_counter()
        before = [w.scheduler.stats() for w in workers]
        pages_before = _serving_metric(
            telemetry, "hvd_serving_migrated_pages_total")
        dreqs = [(rng.integers(0, 97, int(n)).tolist(), SERVING_DRAIN_NEW)
                 for n in rng.integers(8, 129, SERVING_DRAIN_REQUESTS)]
        out = {}
        sender = threading.Thread(target=lambda: out.update(
            res=_serving_burst(ports[0], token, dreqs, "drain")))
        sender.start()
        deadline = time.monotonic() + 120
        while True:
            s0 = workers[0].scheduler.stats()
            if s0["running"] == SERVING_DRAIN_REQUESTS and \
                    s0["tokens_out"] - before[0]["tokens_out"] >= \
                    4 * SERVING_DRAIN_REQUESTS:
                break
            if time.monotonic() > deadline:
                fail(f"[serving] the drain's streams never all ran: {s0}")
            time.sleep(0.002)
        drained_at = s0["tokens_out"] - before[0]["tokens_out"]
        status, body = _serving_post(ports[0], "/v1/serving/drain", {},
                                     token)
        if status != 200 or not body.get("draining"):
            fail(f"[serving] drain answered {status} {body}")
        sender.join(timeout=600)
        res = out.get("res")
        if res is None:
            fail("[serving] the drained streams did not return")
        bad = [i for i, (status, body, _) in enumerate(res)
               if status != 200 or body.get("tokens")
               != workers[0].model.reference_completion(*dreqs[i])
               or body.get("worker") != "c0.1"]
        if bad:
            fail(f"[serving] drained streams {bad} are not worker 1's "
                 f"oracle streams: {[res[i][:2] for i in bad][:2]}")
        after = [w.scheduler.stats() for w in workers]
        d = {k: after[0][k] - before[0][k] for k in
             ("migrated_out", "migrate_failed", "preemptions")}
        d["migrated_in"] = after[1]["migrated_in"] - before[1]["migrated_in"]
        d["preemptions1"] = after[1]["preemptions"] - before[1]["preemptions"]
        pages = _serving_metric(
            telemetry, "hvd_serving_migrated_pages_total") - pages_before
        if d["migrated_out"] != SERVING_DRAIN_REQUESTS or \
                d["migrated_in"] != d["migrated_out"] or \
                d["migrate_failed"] or d["preemptions"] or \
                d["preemptions1"] or pages < 1:
            fail(f"[serving] the drain's migration counters: {d}, pages "
                 f"{pages}")
        lat = sorted(t for _, _, t in res)
        log(f"[serving] drain: {SERVING_DRAIN_REQUESTS} streams of "
            f"{SERVING_DRAIN_NEW} tokens on worker 0 drained after "
            f"{drained_at} tokens; {d['migrated_out']} migrated to worker 1 "
            f"({d['migrated_in']} imported with verified digests, "
            f"{pages:.0f} pages), 0 refused, 0 recomputed; every stream "
            f"equals the oracle, finished on c0.1; latency p50 "
            f"{lat[len(lat) // 2]:.3f} s max {lat[-1]:.3f} s")
        log(f"[time] serving.drain {time.perf_counter() - t3:.1f} s")
    finally:
        if router is not None:
            router.stop_http()
        for w in workers:
            w.stop()
        kv.stop()
        if old_metrics is None:
            os.environ.pop("HOROVOD_TPU_METRICS", None)
        else:
            os.environ["HOROVOD_TPU_METRICS"] = old_metrics
        telemetry.reset()
        torch.cuda.empty_cache()


FLEET_STEP_SLEEP = 0.5      # the child's pause after each commit
FLEET_KNOBS = dict(HVDTPU_FLEET_WINDOW="1", HVDTPU_FLEET_COOLDOWN="3",
                   HVDTPU_FLEET_EBB_IDLE_S="3",
                   HVDTPU_FLEET_MIN_TRAIN_SLOTS="0",
                   HVDTPU_FLEET_TICK_S="0.25",
                   HVDTPU_SERVING_SCALE_UP_DEPTH="8")
FLEET_START_TIMEOUT = 300   # the driver's wait below --min-np
FLEET_CALM_NEW = 64         # max_new_tokens of the calm trickle's streams


class _FleetPlane:
    """The serving half of ``[fleet]``: ``ServingWorker``s (ToyLM and page
    pool on the card) serving HTTP, registered in the training driver's KV
    store, and a ``Router`` over them; ``set_slots`` is the serving
    actuation the arbiter drives."""

    def __init__(self, driver, cohort="serve", devices=None):
        from horovod_tpu_torch.serving.router import Router
        self.driver = driver
        self.cohort = cohort
        self.devices = devices or {}   # wid -> device (default: current)
        self.workers = {}
        self.router = Router(members={cohort: []})
        self.peak = 0
        self.retired = {}   # wid -> its scheduler's stats when stopped

    def set_slots(self, n):
        from horovod_tpu_torch.serving import worker as sworker
        from horovod_tpu_torch.serving.router import WorkerClient
        token = self.driver.token
        for wid in range(n):
            if wid in self.workers:
                continue
            w = sworker.ServingWorker(cohort=self.cohort, wid=wid,
                                      max_batch_tokens=SERVING_BATCH_TOKENS,
                                      device=self.devices.get(wid))
            port = w.serve_http(addr="127.0.0.1", token=token)
            w.start().register("127.0.0.1", self.driver.port, token,
                               advertise=f"127.0.0.1:{port}")
            w.client = WorkerClient(f"http://127.0.0.1:{port}", token=token)
            w.client.wid = wid
            self.workers[wid] = w
        gone = [self.workers.pop(wid) for wid in list(self.workers)
                if wid >= n]
        self.router.members[self.cohort] = [
            w.client for w in self.workers.values()]
        self.peak = max(self.peak, len(self.workers))
        for w in gone:
            w.stop()
            self.retired[w.wid] = w.scheduler.stats()
            for key in (f"member.{self.cohort}.{w.wid}",
                        f"stats.{self.cohort}.{w.wid}"):
                self.driver.server.delete(sworker.SERVING_SCOPE, key)

    def stop(self):
        for w in self.workers.values():
            w.stop()
        self.workers.clear()


def _fleet_wave(router, reqs, model, record, prefix):
    """``reqs`` sent at once through ``router``, a thread each; appends
    ``(kind, seconds)`` per request to ``record`` (``ok``: the stream
    equals the host oracle). Returns the threads."""
    import threading

    def send(i, prompt, n):
        t0 = time.perf_counter()
        status, body = router.generate({"id": f"{prefix}{i}",
                                        "prompt": prompt,
                                        "max_new_tokens": n})
        dt = time.perf_counter() - t0
        if status == 200:
            same = body.get("tokens") == model.reference_completion(prompt,
                                                                    n)
            record.append(("ok" if same else "corrupt", dt))
        else:
            record.append(("rejected" if status in (429, 503)
                           else f"error {status}", dt))

    threads = [threading.Thread(target=send, args=(i, p, n))
               for i, (p, n) in enumerate(reqs)]
    for t in threads:
        t.start()
    return threads


def _fleet_results(out):
    """The children's reports (``OUT.<pid>.json``), in start order."""
    import glob
    res = []
    for path in glob.glob(out + ".*.json"):
        with open(path) as f:
            res.append(json.load(f))
    return sorted(res, key=lambda r: r["t_start"])


def fleet_phase(control_losses):
    """Fleet arbitration on one card: the arbiter lends the training job's
    only slot to serving under a burst and gives it back when serving is
    calm (see the module docstring). Returns the kernels' launches."""
    import shutil
    import tempfile
    import threading
    from horovod_tpu_torch.fleet import actuators as fact
    from horovod_tpu_torch.fleet import arbiter as farb
    from horovod_tpu_torch.fleet import ledger as fled
    from horovod_tpu_torch.fleet import policy as fpol
    from horovod_tpu_torch.runner import http_client, journal
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         ElasticSettings)
    from horovod_tpu_torch.runner.job import Settings
    from horovod_tpu_torch.serving import autoscale
    from horovod_tpu_torch.serving.model import ToyLM

    # [ha] left this process's KV client at term 2: its header would
    # teach this job's store (term 1) a newer term and fence the driver.
    http_client.reset_failover()

    class Actuators(fact.TargetFileActuators):
        def set_serve_slots(self, slots):
            super().set_serve_slots(slots)   # the desired-state file too
            plane.set_slots(slots)

    rng = np.random.default_rng(1)

    def requests(n, new=SERVING_NEW):
        lens = rng.integers(SERVING_PROMPT[0], SERVING_PROMPT[1] + 1, n)
        news = rng.integers(new[0], new[1] + 1, n)
        return [(rng.integers(0, 97, int(a)).tolist(), int(b))
                for a, b in zip(lens, news)]

    with tempfile.TemporaryDirectory(prefix="hvd-fleet-") as tmp:
        need = 3 * 365_000_000 * 4
        free = shutil.disk_usage(tmp).free
        if free < 2 * need:
            fail(f"[fleet] {tmp} has {free / 1e9:.1f} GB free; the phase "
                 f"writes a checkpoint of about {need / 1e9:.1f} GB")
        out = os.path.join(tmp, "fleet")
        jdir = os.path.join(tmp, "journal")
        train_target = os.path.join(tmp, "train.target")
        autoscale.write_target(train_target, ["localhost:1"])
        script = os.path.join(tmp, "discover.sh")
        with open(script, "w") as f:
            f.write("\n".join(autoscale.discovery_script_lines(train_target))
                    + "\n")
        os.chmod(script, 0o755)
        es = ElasticSettings(
            Settings(num_proc=1, start_timeout=FLEET_START_TIMEOUT,
                     output_filename=os.path.join(tmp, "logs"),
                     env=_launcher_env(HVDTPU_CHECKPOINT_KEEP="1")),
            discovery_script=script, min_np=1, max_np=1,
            discovery_interval=0.2, sigkill_deadline=300, journal_dir=jdir)
        driver = ElasticDriver(es, _child("--fleet-child", out))
        plane = _FleetPlane(driver)
        saved_env = {k: os.environ.get(k) for k in FLEET_KNOBS}
        os.environ.update(FLEET_KNOBS)
        try:
            knobs = fpol.fleet_knobs()
            ledger = fled.LeaseLedger(fled.HttpBackend(
                "127.0.0.1", driver.port, token=driver.token))
            act = Actuators(train_target, os.path.join(tmp, "serve.target"),
                            kv_put=lambda s, k, v: driver.server.put(
                                s, k, v, term=driver._wt()))
            arbiter = farb.FleetArbiter(ledger, act,
                                        fact.DriverProbes(driver),
                                        train_slots=1, serve_slots=1)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        oracle = ToyLM(device="cpu")
        box, seen, waves = {}, [], {"burst": [], "after": [], "calm": []}
        stop_calm = threading.Event()
        t0 = time.perf_counter()

        def run_driver():
            try:
                box["rc"] = driver.run()
            except Exception as e:  # noqa: BLE001 — reported below
                box["error"] = repr(e)

        def tick_until(pred, deadline_s):
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline and thread.is_alive():
                lease = arbiter.tick()
                if lease is not None and (lease["id"], lease["state"]) \
                        not in [(i, s) for i, s, _ in seen]:
                    seen.append((lease["id"], lease["state"],
                                 time.perf_counter() - t0))
                if pred(lease):
                    return lease
                time.sleep(knobs["tick_s"])
            return None

        def calm():
            while not stop_calm.is_set():
                for t in _fleet_wave(plane.router,
                                     requests(2, (FLEET_CALM_NEW,) * 2),
                                     oracle, waves["calm"], "calm"):
                    t.join(timeout=300)

        thread = threading.Thread(target=run_driver, daemon=True)
        try:
            plane.set_slots(1)
            thread.start()
            deadline = time.monotonic() + 300
            while not any(r["losses"] for r in _fleet_results(out)):
                if time.monotonic() > deadline or not thread.is_alive():
                    fail(f"[fleet] the training child never stepped: {box}")
                time.sleep(0.05)
            t_burst = time.perf_counter()
            burst = _fleet_wave(plane.router, requests(SERVING_REQUESTS),
                                oracle, waves["burst"], "burst")
            surge = tick_until(lambda l: l is not None
                               and l["state"] == "complete", 300)
            t_surge = time.perf_counter()
            during = {"train": len(driver.workers),
                      "serve": len(plane.workers)}
            for t in burst:
                t.join(timeout=300)
            for t in _fleet_wave(plane.router, requests(SERVING_REQUESTS),
                                 oracle, waves["after"], "after"):
                t.join(timeout=300)
            t_calm = time.perf_counter()
            trickle = threading.Thread(target=calm, daemon=True)
            trickle.start()
            ebb = tick_until(lambda l: l is not None
                             and l["direction"] == "serve_to_train"
                             and l["state"] == "complete", 120) \
                if surge is not None else None
            t_ebb = time.perf_counter()
            split, active = ledger.split(), ledger.active()
            stop_calm.set()
            trickle.join(timeout=300)
            thread.join(timeout=600)
        finally:
            stop_calm.set()
            plane.stop()
            if thread.is_alive():   # a failed check: end the job now
                for w in list(driver.workers.values()) + [
                        w for w, _ in driver.stopping]:
                    w.proc.kill()
                driver.server.stop()
                thread.join(timeout=60)
            driver.server.stop()
        state, _, _ = journal.read_dir(jdir)
        durable = {k: json.loads(v) for k, v in state["kv"].get(
            "fleet", {}).items() if k == "split"}
        children = _fleet_results(out)
        logs = ""
        for name in ("stdout", "stderr"):
            path = os.path.join(tmp, "logs", "rank.localhost_0", name)
            if os.path.exists(path):
                logs += open(path).read()[-3000:]
    bad = []
    if "error" in box or box.get("rc") != 0:
        bad.append(f"the training job ended {box}")
    if surge is None or ebb is None:
        log(logs)
        fail(f"[fleet] leases did not complete (train_to_serve "
             f"{'ok' if surge else 'no'}, serve_to_train "
             f"{'ok' if ebb else 'no'}); states {seen}; {box}")
    by_lease = {}
    for lid, st, t in seen:
        by_lease.setdefault(lid, []).append(f"{st} {t - (t_burst - t0):.2f}")
    for lid, states in by_lease.items():
        log(f"[fleet] lease {lid}: " + ", ".join(states)
            + " (s after the burst)")
    want_states = [("train_to_serve", ["preempting", "resharding",
                                       "activating", "complete"]),
                   ("serve_to_train", ["draining", "returning",
                                       "complete"])]
    got_states = [(lid.rsplit("-", 2)[0], [s.split()[0] for s in sts])
                  for lid, sts in by_lease.items()]
    if got_states != want_states:
        bad.append(f"lease states {got_states}")
    if surge["wids"] != ["localhost:0"] or ebb["wids"] != ["localhost:1"]:
        bad.append(f"victims {surge['wids']} / {ebb['wids']}")
    if during != {"train": 0, "serve": 2} or plane.peak != 2:
        bad.append(f"the split during the lease {during}")
    if split != {"train": 1, "serve": 1, "leased": 0} or active is not None \
            or durable.get("split") != split:
        bad.append(f"the ledger after the ebb: split {split}, journaled "
                   f"{durable}, active {active}")
    causes = dict(driver.preempt_causes)
    if causes != {"preempt": 0, "arbiter_transfer": 1} \
            or driver.fail_counts or driver.blacklist:
        bad.append(f"preempt_causes {causes}, fail_counts "
                   f"{driver.fail_counts}, blacklist {driver.blacklist}")

    def p99(record):
        lat = sorted(t for kind, t in record if kind == "ok")
        return lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat \
            else float("nan")

    drained = plane.retired.get(1, {})
    if not drained.get("draining"):
        bad.append(f"serving worker 1 was stopped undrained: {drained}")
    for name, record in waves.items():
        kinds = sorted({k for k, _ in record})
        if not record or [k for k in kinds if k not in ("ok", "rejected")]:
            bad.append(f"the {name} wave's outcomes {kinds}")
    log(f"[fleet] burst to complete: train_to_serve "
        f"{t_surge - t_burst:.2f} s, serve_to_train "
        f"{t_ebb - t_calm:.2f} s after the calm began (ebb idle "
        f"{knobs['ebb_idle_s']} s, cooldown {knobs['cooldown_s']} s, "
        f"window {knobs['window']}); p99 of the burst wave "
        f"({len(waves['burst'])} requests, 1 worker until the lease) "
        f"{p99(waves['burst']):.3f} s, of the wave after the lease "
        f"({len(waves['after'])}, 2 workers) {p99(waves['after']):.3f} s; "
        f"calm trickle {len(waves['calm'])} requests; the drained worker "
        f"migrated {drained.get('migrated_out')} streams out "
        f"({drained.get('migrate_failed')} refused) and served "
        f"{drained.get('completed')} in all; every accepted "
        f"stream equals the oracle "
        f"({sum(k == 'ok' for w in waves.values() for k, _ in w)} ok, "
        f"{sum(k == 'rejected' for w in waves.values() for k, _ in w)} "
        f"rejected)")
    if len(children) != 2:
        log(logs)
        fail(f"[fleet] expected two training processes, got "
             f"{len(children)}")
    first, second = children
    losses = {}
    for c in children:
        for s, v in c["losses"].items():
            if s in losses:
                bad.append(f"step {s} ran twice")
            losses[s] = v
    got = [losses.get(str(s)) for s in range(1, CHAOS_STEPS + 1)]
    if None in got:
        log(logs)
        fail(f"[fleet] steps missing: {sorted(losses, key=int)}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, control_losses))
    handed = first.get("saved")
    log(f"[fleet] training: pid {first['pid']} ({first['device']}, "
        f"{first['backend']}) stepped {sorted(first['losses'], key=int)}, "
        f"handed off at the commit of step {handed} (checkpoint "
        f"{first.get('save_s', float('nan')):.2f} s) with exit 83 "
        f"(preempt_causes {causes}); pid {second['pid']} "
        f"({second['device']}) resumed step {second.get('resumed')} in "
        f"{second.get('restore_s', float('nan')):.2f} s and stepped "
        f"{sorted(second['losses'], key=int)}; losses {got} against "
        f"[chaos]'s uninterrupted control: max relative difference "
        f"{rel:.2e} (limit {CHAOS_RTOL:.0e}), bit-equal "
        f"{got == list(control_losses)}")
    if rel > CHAOS_RTOL:
        bad.append("losses differ from the uninterrupted control's")
    if handed is None or second.get("resumed") != handed \
            or first["pid"] == second["pid"] or not second.get("done") \
            or max(map(int, first["losses"])) != handed:
        bad.append("the second process did not resume from the first's "
                   "hand-off commit")
    for c in children:
        if c["backend"] != CARD_BACKEND or not c["device"].startswith(
                "cuda"):
            bad.append(f"a training process ran on {c['device']}, "
                       f"{c['backend']}")
    if bad:
        log(logs)
        fail("[fleet] " + "; ".join(bad))
    return {n: first["launch_sum"][n] + second["launch_sum"][n]
            for n in first["launch_sum"]}


def fleet_child(out):
    """The worker of ``fleet_phase`` (``chip_smoke.py --fleet-child OUT``):
    the flagship under ``hvd.elastic.run``, a commit after every step. On
    a SIGTERM it hands off at its next commit with exit 83, and the job's
    last rank first saves a checkpoint of that commit; a fresh process
    resumes from the newest checkpoint. Reports to ``OUT.<pid>.json``
    after every step."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import basics, checkpoint, elastic, models
    from horovod_tpu_torch.ops import flash_attention as fa
    res = {"pid": os.getpid(), "t_start": time.time(), "losses": {},
           "sizes": {}, "done": False}
    path = f"{out}.{os.getpid()}.json"

    def report():
        with open(path + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(path + ".tmp", path)

    hvd.init()
    res["backend"] = basics.runtime().backend.name
    ckpt_dir = os.path.join(os.path.dirname(out), "ckpt")
    cfg, model, step, x, y = transformer_setup(hvd, models)
    opt = step.optimizer
    res["device"] = str(next(model.parameters()).device)
    start = 0
    if os.path.isdir(ckpt_dir):
        t0 = time.perf_counter()
        start, saved = checkpoint.restore_latest(ckpt_dir)
        model.load_state_dict(checkpoint.to_tensors(saved["model"]))
        opt.load_state_dict(checkpoint.to_tensors(saved["opt"]))
        del saved
        torch.cuda.synchronize()
        res["resumed"], res["restore_s"] = start, time.perf_counter() - t0
    launches = []
    fa.reset_launches()

    class HandoffState(hvd_torch.elastic.TorchState):
        def check_host_updates(self):
            if elastic.preempt_requested():
                if hvd.size() == 1:
                    # The job's last rank leaves: its state goes with it,
                    # so it checkpoints the commit it hands off at (in a
                    # larger cohort the survivors keep the state).
                    t0 = time.perf_counter()
                    checkpoint.save_step(ckpt_dir, self.step, {
                        "model": model.state_dict(),
                        "opt": opt.state_dict()})
                    res["saved"] = self.step
                    res["save_s"] = time.perf_counter() - t0
                res["launch_sum"] = _check_launches("fleet", launches)
                report()
            super().check_host_updates()

    state = HandoffState(model, opt, step=start)

    @hvd_torch.elastic.run
    def train_loop(state):
        while state.step < CHAOS_STEPS:
            s = state.step + 1
            r = _timed_steps(step, model, x, y, 1, fa)
            launches.extend(r["launches"])
            res["losses"][str(s)] = r["losses"][0]
            res["sizes"][str(s)] = hvd.size()
            state.step = s
            report()
            state.commit()
            time.sleep(FLEET_STEP_SLEEP)
        return state.step

    train_loop(state)
    res["launch_sum"] = _check_launches("fleet", launches)
    res["done"] = True
    report()
    hvd.shutdown()


def phase_done(name, t):
    """Prints ``[time] <name> <s>``: the wall seconds since ``t``; returns
    the time now."""
    now = time.perf_counter()
    log(f"[time] {name} {now - t:.1f} s")
    return now


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import _build, models, train
    from horovod_tpu_torch.ops import flash_attention as fa
    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith(("jax.", "horovod_tpu.")) \
                or mod == "horovod_tpu":
            fail(f"the port imported {mod}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    import threading
    t0 = time.perf_counter()
    core = {}   # the native core builds (g++) while nvcc runs
    core_thread = threading.Thread(target=lambda: core.update(
        path=_build.build_core(), s=time.perf_counter() - t0))
    core_thread.start()
    build_log = _build.build(["flash_attention"])
    log(f"[build] {', '.join(p.name for p in _build.sources('flash_attention'))}"
        f" -> {_build.library_path('flash_attention').name} in "
        f"{time.perf_counter() - t0:.1f} s")
    core_thread.join()
    if "path" not in core:
        fail("[build] the native core did not build")
    log(f"[build] csrc/core/*.cc -> {core['path'].name} in {core['s']:.1f} s")
    for unit, text in build_log.items():
        if text.strip():
            log(f"[build] {unit}:\n{text.strip()[-4000:]}")

    t = phase_done("build", t0)
    attributes_phase(fa)
    t = phase_done("attrs", t)
    results = kernel_phase(fa)
    t = phase_done("kernels", t)
    hvd.init()
    model_check(hvd, models, torch)
    t = phase_done("model-check", t)
    launches, train_losses, train_ms, train_host = train_phase(
        hvd, fa, models, torch)
    launches = {n: c for n, c in launches.items()
                if n in ("fwd", "bwd_dkv", "bwd_dq")}
    torch.cuda.empty_cache()
    t = phase_done("train", t)
    bert_check(hvd_torch, fa)
    bert_launches = bert_phase(hvd_torch, fa)
    launches.update({n: c for n, c in bert_launches.items()
                     if n.endswith(("_mask", "_philox"))})
    torch.cuda.empty_cache()
    t = phase_done("bert", t)
    api_phase(hvd_torch)
    resnet_check(models)
    resnet_losses, resnet_ms, resnet_host = resnet_phase(hvd_torch, models,
                                                         train)
    torch.cuda.empty_cache()
    t = phase_done("resnet", t)
    native_launches, native_ms, native_res = native_phase(
        train_losses, (train_ms, train_host), resnet_losses,
        (resnet_ms, resnet_host))
    log("[launches] [native] " + ", ".join(
        f"{n}={c}" for n, c in native_launches.items()))
    t = phase_done("native", t)
    sanitize_launches = sanitize_phase(native_res)
    log("[launches] [sanitize] " + ", ".join(
        f"{n}={c}" for n, c in sanitize_launches.items()))
    t = phase_done("sanitize", t)
    elastic_launches = elastic_phase(train_losses, train_ms, native_ms)
    log("[launches] [elastic] " + ", ".join(
        f"{n}={c}" for n, c in elastic_launches.items()))
    t = phase_done("elastic", t)
    compress_launches = compress_phase(native_res, resnet_losses)
    log("[launches] [compress] " + ", ".join(
        f"{n}={c}" for n, c in compress_launches.items()))
    t = phase_done("compress", t)
    zero_launches, zero_res = zero_phase(native_res)
    log("[launches] [zero] " + ", ".join(
        f"{n}={c}" for n, c in zero_launches.items()))
    t = phase_done("zero", t)
    ckpt_launches = ckpt_phase(zero_res)
    log("[launches] [ckpt] " + ", ".join(
        f"{n}={c}" for n, c in ckpt_launches.items()))
    t = phase_done("ckpt", t)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    par_launches, par_rows = parallel_phase(fa, flush_buf)
    log("[launches] [parallel] " + ", ".join(
        f"{n}={c}" for n, c in par_launches.items()))
    launches.update(par_launches)
    results.update(par_rows)
    t = phase_done("parallel", t)
    shard_launches, shard_rows = sharded_phase(fa, flush_buf)
    log("[launches] [sharded] " + ", ".join(
        f"{n}={c}" for n, c in shard_launches.items()))
    for name, by_tp in shard_rows.items():
        results[name].update(by_tp)
    torch.cuda.empty_cache()
    t = phase_done("sharded", t)
    bert_rows, bertmodel_launches = bertmodel_phase(hvd, hvd_torch, fa,
                                                    models, flush_buf)
    del flush_buf
    log("[launches] [bertmodel] " + ", ".join(
        f"{n}={c}" for n, c in bertmodel_launches.items()))
    for name, row in bert_rows.items():
        results[name].update(row)
    torch.cuda.empty_cache()
    t = phase_done("bertmodel", t)
    trace_launches = trace_phase()
    log("[launches] [trace] " + ", ".join(
        f"{n}={c}" for n, c in trace_launches.items()))
    t = phase_done("trace", t)
    at_launches = autotune_phase(native_res)
    log("[launches] [autotune] " + ", ".join(
        f"{n}={c}" for n, c in at_launches.items()))
    t = phase_done("autotune", t)
    chaos_launches, control_losses = chaos_phase(native_res)
    log("[launches] [chaos] " + ", ".join(
        f"{n}={c}" for n, c in chaos_launches.items()))
    t = phase_done("chaos", t)
    ha_launches = ha_phase(control_losses)
    log("[launches] [ha] " + ", ".join(
        f"{n}={c}" for n, c in ha_launches.items()))
    t = phase_done("ha", t)
    serving_phase(models)
    t = phase_done("serving", t)
    fleet_launches = fleet_phase(control_losses)
    log("[launches] [fleet] " + ", ".join(
        f"{n}={c}" for n, c in fleet_launches.items()))
    t = phase_done("fleet", t)
    phase_done("total", t0)
    log("[launches] " + ", ".join(f"{n}={c}" for n, c in launches.items()))
    if set(launches) != set(KERNELS) or not all(launches.values()):
        fail(f"a kernel was not launched on its path: {launches}")

    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": KERNELS[name][2],
         "replaces": KERNELS[name][0], "launches": launches[name],
         "library_call": KERNELS[name][1], **results[name]}
        for name in KERNELS]}
    print(json.dumps(line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    hvd.shutdown()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--native-child"]:
        native_child(sys.argv[2], bare=sys.argv[3:4] == ["bare"])
    elif sys.argv[1:2] == ["--sanitize-child"]:
        sanitize_child(sys.argv[2])
    elif sys.argv[1:2] == ["--elastic-child"]:
        elastic_child(sys.argv[2])
    elif sys.argv[1:2] == ["--compress-child"]:
        compress_child(sys.argv[2])
    elif sys.argv[1:2] == ["--zero-child"]:
        zero_child(sys.argv[2])
    elif sys.argv[1:2] == ["--ckpt-child"]:
        ckpt_child(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--parallel-child"]:
        parallel_child(sys.argv[2])
    elif sys.argv[1:2] == ["--sharded-child"]:
        sharded_child(sys.argv[2])
    elif sys.argv[1:2] == ["--trace-child"]:
        trace_child(sys.argv[2])
    elif sys.argv[1:2] == ["--autotune-child"]:
        autotune_child(sys.argv[2])
    elif sys.argv[1:2] == ["--chaos-child"]:
        chaos_child(sys.argv[2])
    elif sys.argv[1:2] == ["--ha-child"]:
        ha_child(sys.argv[2])
    elif sys.argv[1:2] == ["--fleet-child"]:
        fleet_child(sys.argv[2])
    else:
        main()

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

    def forward(self, x):
        b, s, _ = x.shape

        def split(t):
            return t.view(b, s, self.heads, self.head_dim).transpose(1, 2)
        ctx = F.scaled_dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)),
            attn_mask=None,
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

    def forward(self, x):
        return self.output(self.self(x), x)


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

    def forward(self, x):
        x = self.attention(x)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c, **dev)
                                   for _ in range(c.num_hidden_layers))

    def forward(self, x):
        for layer in self.layer:
            x = layer(x)
        return x


class BertModel(nn.Module):
    def __init__(self, c, **dev):
        super().__init__()
        self.embeddings = BertEmbeddings(c, **dev)
        self.encoder = BertEncoder(c, **dev)

    def forward(self, input_ids):
        return self.encoder(self.embeddings(input_ids))


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

    def forward(self, input_ids, labels=None):
        logits = self.cls(self.bert(input_ids))
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


def time_ms(fn, reps, flush_buf):
    """Mean device ms of ``fn`` over ``reps`` runs, from CUDA events around
    each run, with the L2 cache flushed before each. Every run is queued
    behind a device-side sleep before the host waits, so the events time
    the device's work and not the host's launch overhead."""
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
    train step and one batch."""
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

    attributes_phase(fa)
    results = kernel_phase(fa)
    hvd.init()
    model_check(hvd, models, torch)
    launches, train_losses, train_ms, train_host = train_phase(
        hvd, fa, models, torch)
    launches = {n: c for n, c in launches.items()
                if n in ("fwd", "bwd_dkv", "bwd_dq")}
    torch.cuda.empty_cache()
    bert_check(hvd_torch, fa)
    bert_launches = bert_phase(hvd_torch, fa)
    launches.update({n: c for n, c in bert_launches.items()
                     if n.endswith(("_mask", "_philox"))})
    torch.cuda.empty_cache()
    api_phase(hvd_torch)
    resnet_check(models)
    resnet_losses, resnet_ms, resnet_host = resnet_phase(hvd_torch, models,
                                                         train)
    torch.cuda.empty_cache()
    native_launches, native_ms, native_res = native_phase(
        train_losses, (train_ms, train_host), resnet_losses,
        (resnet_ms, resnet_host))
    log("[launches] [native] " + ", ".join(
        f"{n}={c}" for n, c in native_launches.items()))
    elastic_launches = elastic_phase(train_losses, train_ms, native_ms)
    log("[launches] [elastic] " + ", ".join(
        f"{n}={c}" for n, c in elastic_launches.items()))
    compress_launches = compress_phase(native_res, resnet_losses)
    log("[launches] [compress] " + ", ".join(
        f"{n}={c}" for n, c in compress_launches.items()))
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
    elif sys.argv[1:2] == ["--elastic-child"]:
        elastic_child(sys.argv[2])
    elif sys.argv[1:2] == ["--compress-child"]:
        compress_child(sys.argv[2])
    else:
        main()

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


def train_phase(hvd, fa, models, torch):
    cfg = models.TransformerConfig(
        vocab_size=30522, hidden=1024, layers=24, heads=16, max_len=512,
        causal=True, use_rope=True, attention_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = models.TransformerLM(cfg, device=hvd.device(), generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))

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
    return launches


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


def profile_step(run, step_ms, label="step"):
    """Device time of one more train step by kernel family (after the
    counted steps), and the device's idle share of the unprofiled median
    step time ``step_ms`` of the host phase (the profiler itself slows the
    host)."""
    kernels = device_kernels(run)
    busy = sum(ms for _, ms, _ in kernels)
    if busy == 0:
        log("[profile] the profiler saw no device time: not measured")
        return
    families = {"flash attention kernels": ("flash_",),
                "matmul (cuBLAS/CUTLASS)": ("gemm", "cutlass", "xmma",
                                            "sm90_", "nvjet")}
    split = dict.fromkeys(list(families) + ["other"], 0.0)
    for name, ms, _ in kernels:
        fam = next((f for f, keys in families.items()
                    if any(k in name for k in keys)), "other")
        split[fam] += ms
    log(f"[profile] one {label}: device busy {busy:.2f} ms of the "
        f"{step_ms:.1f} ms median step: idle share "
        f"{max(0.0, 1 - busy / step_ms):.3f}")
    for fam, ms in split.items():
        log(f"  {fam:<26} {ms:8.2f} ms  {ms / busy:.3f} of device time")
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:10]:
        log(f"  {ms:8.2f} ms  x{count:<4} {name[:90]}")


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA device")
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch import _build, models
    from horovod_tpu_torch.ops import flash_attention as fa
    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith(("jax.", "horovod_tpu.")) \
                or mod == "horovod_tpu":
            fail(f"the port imported {mod}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build_log = _build.build(["flash_attention"])
    log(f"[build] {', '.join(p.name for p in _build.sources('flash_attention'))}"
        f" -> {_build.library_path('flash_attention').name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for unit, text in build_log.items():
        if text.strip():
            log(f"[build] {unit}:\n{text.strip()[-4000:]}")

    attributes_phase(fa)
    results = kernel_phase(fa)
    hvd.init()
    model_check(hvd, models, torch)
    launches = {n: c for n, c in train_phase(hvd, fa, models, torch).items()
                if n in ("fwd", "bwd_dkv", "bwd_dq")}
    torch.cuda.empty_cache()
    bert_check(hvd_torch, fa)
    bert_launches = bert_phase(hvd_torch, fa)
    launches.update({n: c for n, c in bert_launches.items()
                     if n.endswith(("_mask", "_philox"))})
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
    main()

"""Transformer models: a decoder-only LM and a BERT-style encoder (port of
``horovod_tpu/models/transformer.py``).

The same blocks as the JAX models: fused QKV projection, pre-LayerNorm,
tanh-GELU MLP, RoPE or learned positions, and bf16 compute with fp32
parameters and fp32 logits. As with flax's ``dtype=bfloat16``, every dense
layer casts both its input and its weights to the compute dtype before the
product. Attention is either dense (``"einsum"``) or the flash kernels
(``"flash"``, ``ops/flash_attention.py``); the projections, MLP and heads
are plain ``F.linear`` calls, as the JAX package left them to XLA.

- :class:`TransformerLM`: causal LM, tokens to fp32 logits.
- :class:`BertModel`: the encoder with a masked-LM head (``mlm_dense``,
  tanh-GELU, ``mlm_ln``, ``mlm_head``); :func:`BertConfig` gives
  BERT-large's sizes.
- A padding ``mask`` (B, S) bool, True where a key is kept, reaches every
  block: the einsum path sets a masked key's logits to -1e30 after the
  causal mask; the flash path refuses a mask (the kernels' ``kv_len`` is
  one per call, not one per row), as the JAX model does.
- ``TransformerConfig.remat`` wraps each block (``_remat.py``): ``True``
  or ``"full"`` recomputes it in the backward, ``"dots"`` keeps the dense
  projections' outputs (JAX's ``dots_with_no_batch_dims_saveable``). The
  values do not change; the flash kernels' forward runs again in the
  backward, so a remat step launches it twice per layer.

:func:`params_from_flax` turns the flax parameter tree of
``horovod_tpu.models.TransformerLM`` or ``BertModel`` (as numpy arrays)
into this module's ``state_dict``, so that both run from the same weights.
"""

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from . import _remat

LN_EPS = 1e-6   # flax.linen.LayerNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    # False | True/"full" (recompute each block in the backward) | "dots"
    # (keep the dense projections' outputs, recompute the rest).
    remat: object = False
    causal: bool = True
    use_rope: bool = True          # decoder LM; BERT uses learned positions
    attention_impl: str = "einsum"  # 'einsum' | 'flash' (CUDA kernels)


def BertConfig(**overrides):
    """BERT-large's sizes (the reference benchmark's encoder): vocab 30522,
    hidden 1024, 24 layers, 16 heads, max_len 512, not causal, learned
    positions."""
    base = dict(vocab_size=30522, hidden=1024, layers=24, heads=16,
                mlp_ratio=4, max_len=512, causal=False, use_rope=False)
    base.update(overrides)
    return TransformerConfig(**base)


@functools.lru_cache(maxsize=16)
def _rope_tables(seq, head_dim, device):
    """(sin, cos) fp32 tables of shape (seq, head_dim // 2) on ``device``.
    Built once per shape and device: copying them from the host on every
    call would block the host until the device drains, once per layer."""
    half = head_dim // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, half) / half))
    angles = torch.as_tensor(np.einsum("s,d->sd", np.arange(seq), freqs),
                             dtype=torch.float32, device=device)
    return torch.sin(angles), torch.cos(angles)


def _rope(q, k):
    """Rotary position embeddings over the head dim of (B, H, S, D)
    tensors, computed in fp32 and cast back to the input dtype."""
    *_, seq, head_dim = q.shape
    half = head_dim // 2
    sin, cos = _rope_tables(seq, head_dim, q.device)

    def rot(x):
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)
    return rot(q), rot(k)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features, out_features, dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=...)``: statistics and affine in fp32, output
    in ``dtype``."""

    def __init__(self, features, dtype, device=None):
        super().__init__(features, eps=LN_EPS, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class Attention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.hidden // cfg.heads
        self.qkv = Dense(cfg.hidden, 3 * cfg.heads * self.head_dim, cfg.dtype,
                         device)
        self.proj = Dense(cfg.heads * self.head_dim, cfg.hidden, cfg.dtype,
                          device)

    def forward(self, x, mask=None):
        return self.proj(attend(self.cfg, self.qkv(x), self.head_dim, mask))


def attend(cfg, qkv, head_dim, mask=None):
    """Attention over the fused projection ``qkv`` (B, S, 3 * heads *
    head_dim), laid out (3, heads, head_dim), for however many heads it
    holds (all of them, or a tensor-parallel rank's): RoPE, then dense or
    flash attention. ``mask`` (B, S) bool keeps the keys where True (dense
    attention only). Returns (B, S, heads * head_dim)."""
    b, s, _ = qkv.shape
    qkv = qkv.view(b, s, 3, -1, head_dim)
    # (B, H, S, D) for both attention implementations.
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if cfg.use_rope:
        q, k = _rope(q, k)
    if cfg.attention_impl == "flash":
        if mask is not None:
            # The kernels' kv_len is one per call, not one per row.
            raise ValueError(
                "attention_impl='flash' does not support padding masks; "
                "use 'einsum'")
        out = flash_attention(q, k, v, causal=cfg.causal)
    elif cfg.attention_impl == "einsum":
        logits = torch.matmul(q, k.transpose(-1, -2)) * (
            1.0 / math.sqrt(head_dim))
        if cfg.causal:
            keep = torch.ones(s, s, dtype=torch.bool,
                              device=qkv.device).tril()
            logits = logits.masked_fill(~keep, -1e30)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
        probs = torch.softmax(logits.float(), dim=-1).to(cfg.dtype)
        out = torch.matmul(probs, v)
    else:
        raise ValueError(
            f"unknown attention_impl {cfg.attention_impl!r}")
    return out.transpose(1, 2).reshape(b, s, -1)


class Block(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln2 = LayerNorm(cfg.hidden, cfg.dtype, device)
        self.mlp_in = Dense(cfg.hidden, cfg.hidden * cfg.mlp_ratio,
                            cfg.dtype, device)
        self.mlp_out = Dense(cfg.hidden * cfg.mlp_ratio, cfg.hidden,
                             cfg.dtype, device)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask)
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class Backbone(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        _remat.check_mode(cfg.remat)
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden,
                                      device=device)
        self.pos_embed = None if cfg.use_rope else nn.Embedding(
            cfg.max_len, cfg.hidden, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.layers))
        self.ln_f = LayerNorm(cfg.hidden, cfg.dtype, device)

    def forward(self, tokens, mask=None):
        dt = self.cfg.dtype
        x = F.embedding(tokens, self.tok_embed.weight.to(dt))
        if self.pos_embed is not None:
            x = x + self.pos_embed.weight[:tokens.shape[1]].to(dt)[None]
        for block in self.blocks:
            x = _remat.call(self.cfg.remat, block, x, mask)
        return self.ln_f(x)


def _init_flax_defaults(module, generator):
    """flax's default initializers: normal(0, 1/sqrt(fan_in)) for dense and
    embedding weights, zero biases, unit LayerNorm scales."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5,
                                   generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, mod.embedding_dim ** -0.5,
                                   generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


class TransformerLM(nn.Module):
    """Decoder-only causal LM: tokens (B, S) int64 → fp32 logits
    (B, S, vocab).

    Weights are drawn from ``generator`` with flax's default initializers:
    normal(0, 1/sqrt(fan_in)) for dense and embedding weights, zero biases,
    unit LayerNorm scales.
    """

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg, device)
        self.lm_head = Dense(cfg.hidden, cfg.vocab_size, cfg.dtype, device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        _init_flax_defaults(self, generator)

    def forward(self, tokens, mask=None):
        return self.lm_head(self.backbone(tokens, mask)).float()


class BertModel(nn.Module):
    """BERT-style encoder with a masked-LM head: tokens (B, S) int64 and an
    optional padding ``mask`` (B, S) bool → fp32 logits (B, S, vocab).
    Weights as :class:`TransformerLM`'s, from ``generator``."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg, device)
        self.mlm_dense = Dense(cfg.hidden, cfg.hidden, cfg.dtype, device)
        self.mlm_ln = LayerNorm(cfg.hidden, cfg.dtype, device)
        self.mlm_head = Dense(cfg.hidden, cfg.vocab_size, cfg.dtype, device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        _init_flax_defaults(self, generator)

    def forward(self, tokens, mask=None):
        x = self.backbone(tokens, mask)
        x = self.mlm_ln(F.gelu(self.mlm_dense(x), approximate="tanh"))
        return self.mlm_head(x).float()


def params_from_flax(params, cfg):
    """State dict for :class:`TransformerLM` or :class:`BertModel` from the
    flax parameter tree of ``horovod_tpu.models.TransformerLM`` or
    ``BertModel`` (leaves as numpy arrays; the outer ``{"params": ...}``
    wrapper is optional). The tree's top-level keys tell the two apart."""
    p = params.get("params", params)
    hd = cfg.hidden // cfg.heads

    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float32))

    def dense(tree):   # flax kernel (in, out) -> Linear.weight (out, in)
        return t(tree["kernel"]).T.contiguous(), t(tree["bias"])

    def ln(tree):
        return t(tree["scale"]), t(tree["bias"])

    bb = p["backbone"]
    sd = {"backbone.tok_embed.weight": t(bb["tok_embed"]["embedding"])}
    if not cfg.use_rope:
        sd["backbone.pos_embed.weight"] = t(bb["pos_embed"]["embedding"])
    for i in range(cfg.layers):
        blk, pre = bb[f"block_{i}"], f"backbone.blocks.{i}."
        attn = blk["attn"]
        # DenseGeneral kernels: qkv (hidden, 3, heads, hd), proj
        # (heads, hd, hidden); flattened in the same (3, heads, hd) order
        # the forward views the fused projection in.
        sd[pre + "attn.qkv.weight"] = t(attn["qkv"]["kernel"]).reshape(
            cfg.hidden, 3 * cfg.heads * hd).T.contiguous()
        sd[pre + "attn.qkv.bias"] = t(attn["qkv"]["bias"]).reshape(-1)
        sd[pre + "attn.proj.weight"] = t(attn["proj"]["kernel"]).reshape(
            cfg.heads * hd, cfg.hidden).T.contiguous()
        sd[pre + "attn.proj.bias"] = t(attn["proj"]["bias"])
        for name in ("ln1", "ln2"):
            sd[pre + name + ".weight"], sd[pre + name + ".bias"] = ln(
                blk[name])
        for name in ("mlp_in", "mlp_out"):
            sd[pre + name + ".weight"], sd[pre + name + ".bias"] = dense(
                blk[name])
    sd["backbone.ln_f.weight"], sd["backbone.ln_f.bias"] = ln(bb["ln_f"])
    if "mlm_head" in p:
        for name in ("mlm_dense", "mlm_head"):
            sd[name + ".weight"], sd[name + ".bias"] = dense(p[name])
        sd["mlm_ln.weight"], sd["mlm_ln.bias"] = ln(p["mlm_ln"])
    else:
        sd["lm_head.weight"], sd["lm_head.bias"] = dense(p["lm_head"])
    return sd

"""Flash attention with log-sum-exp outputs, on hand-written Hopper kernels.

Port of ``horovod_tpu/ops/flash_attention.py``. The three Pallas TPU kernels
become three CUDA kernels under ``csrc/`` (bf16/fp16: wgmma kernels in
``flash_fwd_sm90.cu``, ``flash_dkv_sm90.cu`` and ``flash_dq_sm90.cu``;
float32: CUDA-core kernels in ``flash_attention.cu``, beside the C entry
points):

- :func:`attention_fwd`     ← ``_fwd_kernel`` (online-softmax forward, O+LSE)
- :func:`attention_bwd_dkv` ← ``_bwd_dkv_kernel`` (dK, dV per key tile)
- :func:`attention_bwd_dq`  ← ``_bwd_dq_kernel`` (dQ per query tile)

Each wrapper runs its kernel for a CUDA tensor (or raises if it cannot) and
its plain PyTorch version — the same tiled online-softmax loop with the same
tile-skip and mask rules — for a CPU tensor. ``chip_smoke.py`` holds each
kernel against its plain version on the card; the CPU tests hold the plain
versions against the JAX package. Every launch adds one to
``LAUNCHES[<kernel>]``. Under a lint trace (``analysis/fx_lint.py``) a CUDA
call records one ``hvd_lint::kernel`` graph node on fake tensors instead:
no launch, no count.

Masking is in global coordinates, as in the JAX kernels: query row ``i``
sits at ``q_offset + i``, key ``j`` at ``k_offset + j``; causal keeps
``q_offset + i >= k_offset + j``, and keys at or past ``kv_len`` are
padding. A row that sees no key gives O = 0 and LSE = -1e30.

Each kernel also has the JAX kernels' two attention-dropout modes (torch
semantics: probabilities are dropped after the softmax, the normaliser keeps
the undropped sum): an explicit 0/1 keep-mask, or a seed from which every
kernel regenerates the keep pattern with Philox4x32-10 (:func:`philox_keep_mask`
is its plain version). Launches are counted per mode: ``fwd``, ``fwd_mask``,
``fwd_philox`` and so on.
"""

import ctypes
import dataclasses
import math
import warnings

import torch
import torch.nn.functional as F

from ..analysis import fx_lint
from ..utils import envparse

NEG_INF = -1e30
# Sequence lengths are padded to this many rows; it is a multiple of every
# kernel tile (64 rows for bf16/fp16, 32 for float32).
SEQ_PAD = 64
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_KERNELS = ("fwd", "bwd_dkv", "bwd_dq")
_MODE_CODES = {"": 0, "mask": 1, "philox": 2}   # enum Mode of the .cu file

#: Kernel launches since the last :func:`reset_launches`, by kernel and
#: dropout mode (``fwd`` counts the no-dropout forward, ``fwd_mask`` the
#: explicit-mask one, ``fwd_philox`` the seeded one).
LAUNCHES = {k + (f"_{m}" if m else ""): 0 for m in _MODE_CODES
            for k in _KERNELS}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tile_rows(dtype):
    """Rows (= columns) of one attention tile: what the CUDA kernels use
    for ``dtype``, and so what the plain versions use too."""
    return 32 if dtype == torch.float32 else 64


# ---------------------------------------------------------------------------
# Bridge routing (note_flash_fallback / bridge_flash_enabled of the JAX
# package): shared by the torch bridge and any caller that routes attention.
# ---------------------------------------------------------------------------

_bridge_fallback_noted = set()


def note_flash_fallback(reason):
    """One-shot warning that a bridge attention site stayed on its einsum
    lowering."""
    if reason in _bridge_fallback_noted:
        return
    _bridge_fallback_noted.add(reason)
    warnings.warn(
        f"tpu_compile: attention falls back to the einsum lowering "
        f"({reason}); the flash path needs 4-D rank-consistent q/k/v with "
        f"equal head dims and a mask that is None or all-keep", stacklevel=3)


def bridge_flash_enabled(device):
    """Should the torch bridge route attention on ``device`` through the
    flash kernels? On CUDA tensors always: there the kernels are the only
    attention the bridge runs, and ``HVDTPU_BRIDGE_FLASH=never`` raises. On
    CPU tensors the knob chooses between the kernels' plain versions
    (``always``) and the einsum lowering (``never``, and ``auto``, the
    default: the plain versions are a Python loop over tiles, so the CPU
    tests opt in with ``always``)."""
    mode = envparse.get_str(envparse.BRIDGE_FLASH, "auto").lower()
    if torch.device(device).type == "cuda":
        if mode == "never":
            raise ValueError(
                "HVDTPU_BRIDGE_FLASH=never: CUDA tensors run the bridge's "
                "attention on the flash kernels only; the knob chooses for "
                "CPU tensors")
        return True
    return mode == "always"


# ---------------------------------------------------------------------------
# Attention dropout: the keep pattern
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def keep_threshold(rate):
    """Philox words below this are kept: keep probability 1 - rate, exact to
    2^-32. Clamped to 2^32 - 1, so that a rate whose ``1 - rate`` rounds to
    1.0 keeps (all but 2^-32 of) everything instead of overflowing."""
    return min(int((1.0 - rate) * 4294967296.0), _U32)


def _mulhilo(m, x):
    """(hi, lo) 32-bit halves of ``m * x`` for a 32-bit constant ``m`` and
    an int64 tensor ``x`` of 32-bit values, without overflowing int64."""
    p_lo = m * (x & 0xFFFF)           # < 2^48
    p_hi = m * (x >> 16)              # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Random123) on int64 tensors holding 32-bit words:
    ``counter`` four tensors, ``key`` two; broadcast together. Returns the
    four output words. The CUDA kernels' ``philox4x32_10``, in plain
    PyTorch."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_keep_mask(seed, bh, s_q, s_k, rate, device):
    """The (bh, s_q, s_k) bool keep pattern that the seeded kernels draw.

    Philox4x32-10 keyed by (seed, head index) with the counter (col // 4,
    row, 0, 0) of each group of four keys; word ``col % 4`` is kept when
    below :func:`keep_threshold`. The counter is the element's global
    position, so the pattern does not depend on the kernels' tile size. The
    JAX package's TPU kernels key the TPU's own generator per tile instead;
    its bits cannot be reproduced off the TPU, so the two packages draw
    different patterns of the same keep rate."""
    if s_k % 4:
        raise ValueError(f"philox_keep_mask: s_k {s_k} must be a multiple "
                         "of 4")
    thresh = keep_threshold(rate)
    s4 = s_k // 4
    cols = torch.arange(s4, device=device, dtype=torch.int64)[None, None, :]
    rows = torch.arange(s_q, device=device, dtype=torch.int64)[None, :, None]
    zero = torch.zeros((), device=device, dtype=torch.int64)
    out = torch.empty(bh, s_q, s_k, dtype=torch.bool, device=device)
    chunk = max(1, 2 ** 20 // (s_q * s4))   # bound the int64 temporaries
    for b0 in range(0, bh, chunk):
        heads = torch.arange(b0, min(b0 + chunk, bh), device=device,
                             dtype=torch.int64)[:, None, None]
        words = philox4x32_10(
            (cols.expand(len(heads), s_q, s4), rows, zero, zero),
            (seed & _U32, heads))
        out[b0:b0 + len(heads)] = torch.stack(
            [w < thresh for w in words], dim=-1).reshape(-1, s_q, s_k)
    return out


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Attention dropout of one call: ``rate`` and either an explicit 0/1
    keep ``mask`` (uint8, (BH, S_q, S_k) at the padded lengths) or a Philox
    ``seed`` (32 bits)."""
    rate: float
    mask: torch.Tensor = None
    seed: int = None

    @property
    def mode(self):
        return "mask" if self.mask is not None else "philox"

    @property
    def scale(self):
        return 1.0 / (1.0 - self.rate)

    def multiplier(self, bh, s_q, s_k, device):
        """keep / (1 - rate) as fp32 (BH, S_q, S_k): what each kernel
        multiplies P (and dP) by, the JAX kernels' ``_keep_scale``."""
        keep = self.mask if self.mask is not None else philox_keep_mask(
            self.seed, bh, s_q, s_k, self.rate, device)
        return keep.float() * self.scale


# ---------------------------------------------------------------------------
# Tile schedule (_block_skip / _tile_interior of the JAX kernels)
# ---------------------------------------------------------------------------

def block_skip(causal, lens, qb, kb, bm):
    """True when tile (qb, kb) contributes nothing: every key is padding,
    or (causal) the whole tile lies above the diagonal."""
    q_off, k_off, kv_len = lens
    skip = kb * bm >= kv_len
    if causal:
        skip = skip or (q_off + qb * bm + bm - 1 < k_off + kb * bm)
    return skip


def tile_interior(causal, lens, qb, kb, bm):
    """True when no element of tile (qb, kb) is masked."""
    q_off, k_off, kv_len = lens
    inside = (kb + 1) * bm <= kv_len
    if causal:
        inside = inside and (k_off + kb * bm + bm - 1 <= q_off + qb * bm)
    return inside


def k_tiles(causal, lens, qb, n_k, bm):
    """``(kb, interior)`` for every k tile that query tile ``qb`` visits."""
    return [(kb, tile_interior(causal, lens, qb, kb, bm))
            for kb in range(n_k) if not block_skip(causal, lens, qb, kb, bm)]


def q_tiles(causal, lens, kb, n_q, bm):
    """``(qb, interior)`` for every q tile that key tile ``kb`` visits."""
    return [(qb, tile_interior(causal, lens, qb, kb, bm))
            for qb in range(n_q) if not block_skip(causal, lens, qb, kb, bm)]


def _tile_mask(causal, lens, qb, kb, bm, device):
    q_off, k_off, kv_len = lens
    rows = qb * bm + torch.arange(bm, device=device)[:, None]
    cols = kb * bm + torch.arange(bm, device=device)[None, :]
    mask = cols < kv_len
    if causal:
        mask = mask & (q_off + rows >= k_off + cols)
    return mask


# ---------------------------------------------------------------------------
# Plain PyTorch versions (what each kernel computes, tile by tile; batched
# over BH). Products take fp32 copies of the operands, which is exact for
# bf16/fp16 inputs, so they match tensor-core products with fp32 sums.
# ---------------------------------------------------------------------------

def attention_fwd_plain(q, k, v, lens, sm_scale, causal, keep=None):
    """``keep``: None, or the fp32 (BH, S_q, S_k) dropout multiplier
    (:meth:`Dropout.multiplier`), applied per tile to P in the P.V product
    after the normaliser is updated."""
    bh, s_q, d = q.shape
    bm = tile_rows(q.dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty_like(q)
    lse = torch.empty(bh, s_q, dtype=torch.float32, device=q.device)
    for qb in range(s_q // bm):
        rows = slice(qb * bm, (qb + 1) * bm)
        m = torch.full((bh, bm, 1), NEG_INF, device=q.device)
        l = torch.zeros((bh, bm, 1), device=q.device)
        acc = torch.zeros((bh, bm, d), device=q.device)
        for kb, interior in k_tiles(causal, lens, qb, k.shape[1] // bm, bm):
            cols = slice(kb * bm, (kb + 1) * bm)
            s = torch.matmul(qf[:, rows], kf[:, cols].transpose(1, 2)) \
                * sm_scale
            mask = None
            if not interior:
                mask = _tile_mask(causal, lens, qb, kb, bm, q.device)
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            l = alpha * l + p.sum(-1, keepdim=True)
            pv = p if keep is None else p * keep[:, rows, cols]
            acc = acc * alpha + torch.matmul(pv.to(v.dtype).float(),
                                             vf[:, cols])
            m = m_new
        safe_l = torch.where(l == 0.0, 1.0, l)
        o[:, rows] = (acc / safe_l).to(q.dtype)
        lse[:, rows] = torch.where(l == 0.0, NEG_INF, m + torch.log(safe_l))[
            ..., 0]
    return o, lse


def _probs_and_ds(qf, kf, vf, dof, lse, delta, rows, cols, lens, qb, kb, bm,
                  interior, sm_scale, causal, keep):
    """Recomputed P (from LSE), dropped by ``keep`` (the P that reached the
    P.V product), and dS = P * (dP * keep - delta) * scale of tile (qb, kb),
    all fp32."""
    s = torch.matmul(qf[:, rows], kf[:, cols].transpose(1, 2)) * sm_scale
    p = torch.exp(s - lse[:, rows, None])
    if not interior:
        p = torch.where(_tile_mask(causal, lens, qb, kb, bm, qf.device),
                        p, 0.0)
    dp = torch.matmul(dof[:, rows], vf[:, cols].transpose(1, 2))
    pv = p
    if keep is not None:
        tile_keep = keep[:, rows, cols]
        pv = p * tile_keep
        dp = dp * tile_keep
    ds = p * (dp - delta[:, rows, None]) * sm_scale
    return pv, ds


def attention_bwd_dkv_plain(q, k, v, do, lse, delta, lens, sm_scale, causal,
                            keep=None):
    bm = tile_rows(q.dtype)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for kb in range(k.shape[1] // bm):
        cols = slice(kb * bm, (kb + 1) * bm)
        dk_acc = torch.zeros((k.shape[0], bm, k.shape[2]), device=k.device)
        dv_acc = torch.zeros_like(dk_acc)
        for qb, interior in q_tiles(causal, lens, kb, q.shape[1] // bm, bm):
            rows = slice(qb * bm, (qb + 1) * bm)
            pv, ds = _probs_and_ds(qf, kf, vf, dof, lse, delta, rows, cols,
                                   lens, qb, kb, bm, interior, sm_scale,
                                   causal, keep)
            dv_acc += torch.matmul(pv.to(do.dtype).float().transpose(1, 2),
                                   dof[:, rows])
            dk_acc += torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                                   qf[:, rows])
        dk[:, cols] = dk_acc.to(k.dtype)
        dv[:, cols] = dv_acc.to(v.dtype)
    return dk, dv


def attention_bwd_dq_plain(q, k, v, do, lse, delta, lens, sm_scale, causal,
                           keep=None):
    bm = tile_rows(q.dtype)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dq = torch.empty_like(q)
    for qb in range(q.shape[1] // bm):
        rows = slice(qb * bm, (qb + 1) * bm)
        dq_acc = torch.zeros((q.shape[0], bm, q.shape[2]), device=q.device)
        for kb, interior in k_tiles(causal, lens, qb, k.shape[1] // bm, bm):
            cols = slice(kb * bm, (kb + 1) * bm)
            _, ds = _probs_and_ds(qf, kf, vf, dof, lse, delta, rows, cols,
                                  lens, qb, kb, bm, interior, sm_scale,
                                  causal, keep)
            dq_acc += torch.matmul(ds.to(k.dtype).float(), kf[:, cols])
        dq[:, rows] = dq_acc.to(q.dtype)
    return dq


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# (dtype, head_dim, mode), tensors, mask, (bh, s_q, s_k, q_off, k_off,
# kv_len, causal), scale, keep_scale, threshold, seed, stream
_TAIL = [_P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _U, _U, _P]
_SIGNATURES = {
    "hvd_flash_fwd": [_I, _I, _I] + [_P] * 5 + _TAIL,
    "hvd_flash_bwd_dkv": [_I, _I, _I] + [_P] * 8 + _TAIL,
    "hvd_flash_bwd_dq": [_I, _I, _I] + [_P] * 7 + _TAIL,
    "hvd_flash_kernel_attrs": [_I, _I, _I, _I, _P],
}


def _library():
    from .. import _build
    lib = _build.load("flash_attention")
    if not getattr(lib, "_hvd_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hvd_flash_error_string.argtypes = [ctypes.c_int]
        lib.hvd_flash_error_string.restype = ctypes.c_char_p
        lib._hvd_typed = True
    return lib


def kernel_attributes(kernel, dtype, head_dim, mode=""):
    """What the CUDA kernel instance that a call of ``kernel`` ("fwd",
    "bwd_dkv", "bwd_dq") with this dtype, head dim and dropout mode ("",
    "mask", "philox") launches uses on the current device: registers per
    thread, static and dynamic shared memory bytes, and local (spill) bytes
    per thread (``cudaFuncGetAttributes``)."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    rc = lib.hvd_flash_kernel_attrs(_KERNELS.index(kernel),
                                    _DTYPE_CODES[dtype], head_dim,
                                    _MODE_CODES[mode], out)
    if rc != 0:
        raise RuntimeError(f"flash {kernel} attributes: "
                           f"{lib.hvd_flash_error_string(rc).decode()}")
    return dict(zip(("regs", "static_smem", "dynamic_smem", "local_bytes"),
                    out))


def _check_kernel_inputs(kind, tensors, rows, lens):
    """What the CUDA kernels take: CUDA tensors on one device, one of
    bf16/fp16/fp32 (row vectors fp32), contiguous, (BH, S, D) with S a
    multiple of SEQ_PAD and D 64 or 128."""
    q = tensors[0]
    for t in tensors + rows:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash {kind}: every operand must be a CUDA "
                             f"tensor on {q.device}; got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash {kind}: operands must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash {kind}: unsupported dtype {q.dtype} "
                        "(bf16, fp16 or fp32)")
    for t in tensors:
        if t.dtype != q.dtype or t.dim() != 3 or t.shape[0] != q.shape[0] \
                or t.shape[2] != q.shape[2]:
            raise ValueError(f"flash {kind}: q/k/v/do must share dtype, "
                             "batch*heads and head_dim, as (BH, S, D)")
    for t in rows:
        if t.dtype != torch.float32:
            raise TypeError(f"flash {kind}: lse/delta must be float32")
    bh, s_q, d = q.shape
    s_k = tensors[1].shape[1]
    if d not in (64, 128):
        raise ValueError(f"flash {kind}: head_dim {d} after padding; the "
                         "kernels take 64 or 128")
    if s_q % SEQ_PAD or s_k % SEQ_PAD:
        raise ValueError(f"flash {kind}: sequence lengths ({s_q}, {s_k}) "
                         f"must be multiples of {SEQ_PAD}")
    q_off, k_off, kv_len = (int(x) for x in lens)
    return (_DTYPE_CODES[q.dtype], d, bh, s_q, s_k, q_off, k_off, kv_len)


def _check_dropout(kind, dropout, q, s_q, s_k):
    """What the dropout modes take: a rate in (0, 1) and either a uint8
    keep-mask (BH, S_q, S_k) on q's device, contiguous, or a seed."""
    if dropout is None:
        return
    if not 0.0 < dropout.rate < 1.0:
        raise ValueError(f"flash {kind}: dropout rate {dropout.rate} must "
                         "be in (0, 1)")
    m = dropout.mask
    if m is None:
        if dropout.seed is None:
            raise ValueError(f"flash {kind}: dropout needs a mask or a seed")
        return
    if m.device != q.device or m.dtype != torch.uint8 \
            or not m.is_contiguous() \
            or tuple(m.shape) != (q.shape[0], s_q, s_k):
        raise ValueError(
            f"flash {kind}: the keep-mask must be a contiguous uint8 "
            f"tensor of shape {(q.shape[0], s_q, s_k)} on {q.device}; got "
            f"{m.dtype} {tuple(m.shape)} on {m.device}")


def _launch(fn_name, kernel, dtype_dim, tensors, dims, causal, sm_scale,
            dropout, n_out):
    """Launch ``kernel`` on ``tensors``, whose last ``n_out`` it writes."""
    mode = "" if dropout is None else dropout.mode
    if fx_lint.tracing():
        fx_lint.kernel(kernel + (f"_{mode}" if mode else ""),
                       tensors[:-n_out], tensors[-n_out:])
        return
    lib = _library()
    device = tensors[0].device
    if dropout is None:
        drop_args = (None, 0.0, 0, 0)
    else:
        drop_args = (None if dropout.mask is None else dropout.mask.data_ptr(),
                     dropout.scale, keep_threshold(dropout.rate),
                     (dropout.seed or 0) & _U32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            dtype_dim[0], dtype_dim[1], _MODE_CODES[mode],
            *[t.data_ptr() for t in tensors], drop_args[0], *dims,
            int(bool(causal)), float(sm_scale), *drop_args[1:], stream)
    if rc != 0:
        raise RuntimeError(f"flash {kernel} kernel launch failed: "
                           f"{lib.hvd_flash_error_string(rc).decode()}")
    LAUNCHES[kernel + (f"_{mode}" if mode else "")] += 1


def _multiplier(dropout, q, k):
    if dropout is None:
        return None
    return dropout.multiplier(q.shape[0], q.shape[1], k.shape[1], q.device)


def attention_fwd(q, k, v, lens, sm_scale, causal, dropout=None):
    """(O, LSE) of tiled attention over (BH, S, D) operands.

    ``lens = (q_offset, k_offset, kv_len)``; ``dropout`` None or a
    :class:`Dropout`. CPU tensors take the plain version; CUDA tensors the
    kernel (or a raise)."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, lens, sm_scale, causal,
                                   _multiplier(dropout, q, k))
    dtype, d, bh, s_q, s_k, q_off, k_off, kv_len = _check_kernel_inputs(
        "fwd", [q, k, v], [], lens)
    _check_dropout("fwd", dropout, q, s_q, s_k)
    o = torch.empty_like(q)
    lse = torch.empty(bh, s_q, dtype=torch.float32, device=q.device)
    _launch("hvd_flash_fwd", "fwd", (dtype, d), (q, k, v, o, lse),
            (bh, s_q, s_k, q_off, k_off, kv_len), causal, sm_scale, dropout,
            2)
    return o, lse


def attention_bwd_dkv(q, k, v, do, lse, delta, lens, sm_scale, causal,
                      dropout=None):
    """(dK, dV) given the forward's LSE and delta = rowsum(dO * O) - g_lse."""
    if q.device.type == "cpu":
        return attention_bwd_dkv_plain(q, k, v, do, lse, delta, lens,
                                       sm_scale, causal,
                                       _multiplier(dropout, q, k))
    dtype, d, bh, s_q, s_k, q_off, k_off, kv_len = _check_kernel_inputs(
        "bwd_dkv", [q, k, v, do], [lse, delta], lens)
    _check_dropout("bwd_dkv", dropout, q, s_q, s_k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("hvd_flash_bwd_dkv", "bwd_dkv", (dtype, d),
            (q, k, v, do, lse, delta, dk, dv),
            (bh, s_q, s_k, q_off, k_off, kv_len), causal, sm_scale, dropout,
            2)
    return dk, dv


def attention_bwd_dq(q, k, v, do, lse, delta, lens, sm_scale, causal,
                     dropout=None):
    """dQ given the forward's LSE and delta = rowsum(dO * O) - g_lse."""
    if q.device.type == "cpu":
        return attention_bwd_dq_plain(q, k, v, do, lse, delta, lens,
                                      sm_scale, causal,
                                      _multiplier(dropout, q, k))
    dtype, d, bh, s_q, s_k, q_off, k_off, kv_len = _check_kernel_inputs(
        "bwd_dq", [q, k, v, do], [lse, delta], lens)
    _check_dropout("bwd_dq", dropout, q, s_q, s_k)
    dq = torch.empty_like(q)
    _launch("hvd_flash_bwd_dq", "bwd_dq", (dtype, d),
            (q, k, v, do, lse, delta, dq),
            (bh, s_q, s_k, q_off, k_off, kv_len), causal, sm_scale, dropout,
            1)
    return dq


# ---------------------------------------------------------------------------
# Differentiable entry point
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Replaces the JAX custom VJPs ``_flash``, ``_flash_with_lse``,
    ``_flash_dropout`` and ``_flash_seeded``: one function whose LSE output
    is differentiable too. The LSE cotangent enters the backward through
    delta (d lse_i / d s_ij = p_ij). With dropout, the explicit mask is
    saved for the backward (the JAX residual ``dm``); the seeded mode saves
    only its seed. delta needs no dropout term: O already carries it."""

    @staticmethod
    def forward(ctx, q, k, v, lens, sm_scale, causal, dropout):
        o, lse = attention_fwd(q, k, v, lens, sm_scale, causal, dropout)
        mask = () if dropout is None or dropout.mask is None \
            else (dropout.mask,)
        ctx.save_for_backward(q, k, v, o, lse, *mask)
        ctx.lens, ctx.sm_scale, ctx.causal = lens, sm_scale, causal
        ctx.dropout = None if dropout is None \
            else dataclasses.replace(dropout, mask=None)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse, *mask = ctx.saved_tensors
        dropout = ctx.dropout
        if mask:
            dropout = dataclasses.replace(dropout, mask=mask[0])
        g_o = torch.zeros_like(o) if g_o is None else g_o.contiguous()
        delta = (g_o.float() * o.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        args = (q, k, v, g_o, lse, delta, ctx.lens, ctx.sm_scale, ctx.causal,
                dropout)
        dk, dv = attention_bwd_dkv(*args)
        dq = attention_bwd_dq(*args)
        return dq, dk, dv, None, None, None, None


def _pad_to(x, multiple, dim):
    pad = (-x.shape[dim]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - dim)
    widths[-1] = pad   # F.pad lists the last dim first
    return F.pad(x, widths)


def _prepare(q, k, v):
    """(B, H, S, D) → contiguous (B·H, S, D), D padded to 64 (D ≤ 64) or a
    multiple of 128, S padded to SEQ_PAD."""
    b, h, sq, d = q.shape
    d_pad = 64 if d <= 64 else 128

    def flat(x, rows):
        x = x.reshape((b * h,) + x.shape[2:])
        return _pad_to(_pad_to(x, d_pad, 2), rows, 1).contiguous()

    return flat(q, SEQ_PAD), flat(k, SEQ_PAD), flat(v, SEQ_PAD)


def flash_attention(q, k, v, *, causal=False, sm_scale=None, q_offset=0,
                    k_offset=0, kv_len=None, with_lse=False,
                    dropout_mask=None, dropout_rate=0.0, dropout_seed=None):
    """Flash attention over (batch, heads, seq, head_dim) tensors.

    Args:
      causal: causal mask in global coordinates, position(q) = q_offset +
        row and position(k) = k_offset + col.
      kv_len: number of valid keys in ``k`` (default: all); later keys are
        masked as padding.
      with_lse: also return the per-query log-sum-exp (fp32, (B, H, Sq)),
        differentiable.
      dropout_mask: optional (B, H, Sq, Sk) 0/1 keep-mask applied to the
        softmax probabilities (torch attention-dropout semantics: dropped
        after normalisation, the kept ones rescaled by 1/(1-dropout_rate)).
        Exactly reproducible against ``reference_attention``.
      dropout_rate: the rate the mask was drawn with, or the seeded mode's.
      dropout_seed: instead of a mask, a 32-bit seed from which the forward
        and both backward kernels regenerate the keep pattern
        (:func:`philox_keep_mask`); no mask is ever stored. On the CPU the
        plain versions draw the same pattern.
    """
    if dropout_seed is not None and dropout_mask is not None:
        raise ValueError(
            "flash_attention: pass dropout_mask OR dropout_seed, not both")
    has_dropout = (dropout_mask is not None or dropout_seed is not None) \
        and dropout_rate > 0.0
    if has_dropout and with_lse:
        raise NotImplementedError(
            "flash_attention: dropout with with_lse is unsupported "
            "(ring/merged attention never uses attention dropout)")
    b, h, sq, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = k.shape[2]
    qp, kp, vp = _prepare(q, k, v)
    lens = (int(q_offset), int(k_offset), int(kv_len))
    dropout = None
    if has_dropout and dropout_seed is not None:
        dropout = Dropout(float(dropout_rate), seed=int(dropout_seed) & _U32)
    elif has_dropout:
        dm = dropout_mask.reshape(b * h, sq, -1)
        dm = dm.view(torch.uint8) if dm.dtype == torch.bool \
            else (dm != 0).to(torch.uint8)
        dm = _pad_to(_pad_to(dm, SEQ_PAD, 2), SEQ_PAD, 1).contiguous()
        dropout = Dropout(float(dropout_rate), mask=dm)
    o, lse = _FlashAttention.apply(qp, kp, vp, lens, float(sm_scale),
                                   bool(causal), dropout)
    o = o[:, :sq, :d].reshape(b, h, sq, d)
    if with_lse:
        return o, lse[:, :sq].reshape(b, h, sq)
    return o


def reference_attention(q, k, v, *, causal=False, sm_scale=None, q_offset=0,
                        k_offset=0, kv_len=None, with_lse=False,
                        dropout_mask=None, dropout_rate=0.0):
    """Dense attention with the same masking semantics, in fp32: the
    correctness oracle of the kernels' tests. ``dropout_mask`` (B, H, Sq,
    Sk) drops probabilities after the softmax; the normaliser keeps the
    undropped sum."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = sk
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    cols = torch.arange(sk, device=q.device)
    mask = (cols < kv_len)[None, :]
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)
        mask = mask & (rows[:, None] >= k_offset + cols[None, :])
    mask = mask.expand(sq, sk)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    pv = p
    if dropout_mask is not None and dropout_rate > 0.0:
        pv = p * (dropout_mask.float() / (1.0 - dropout_rate))
    o = (torch.einsum("bhqk,bhkd->bhqd", pv, v.float()) / safe_l).to(q.dtype)
    if not with_lse:
        return o
    lse = torch.where(mask.any(-1), (m + torch.log(safe_l))[..., 0], NEG_INF)
    return o, lse

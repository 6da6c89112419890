"""Codec layer: one interface over wire quantization and dtype casts (port
of ``horovod_tpu/compression/codecs.py``; EQuARX, arXiv:2506.17615).

Block-wise quantization pays for itself when it runs inside the collective:
quantize -> reduce-scatter the narrow blocks -> dequantize and accumulate in
float32 -> requantize -> allgather -> dequantize. Accumulation never happens
in the narrow dtype, so the error stays bounded by the per-block
quantization step instead of growing with the number of ranks.

Two codec families behind one :class:`Codec` interface:

- **Block codecs** (``int8``, ``fp8``): ``encode`` splits the last dim into
  fixed-size blocks and returns a narrow payload plus one float32 scale per
  block (scale = max|block| / qmax). These are *wire* codecs: a plain sum
  of payloads would be garbage, so the data planes run the quantized
  pipeline instead of a plain allreduce.
- **Cast codecs** (``none``, ``fp16``, ``bf16``): ``encode`` is a cast,
  there are no scales, and a plain allreduce carries the narrow payload
  (the reference's ``horovod/torch/compression.py`` semantics).

Every function here is a torch op on the tensor's own device: on CUDA
tensors the passes run on the card, on CPU tensors on the host.
"""

import torch

DEFAULT_BLOCK = 256

_INT8_QMAX = 127.0


class Codec:
    """One compression scheme for collective payloads. ``wire=True`` marks
    block codecs whose payload cannot ride a plain reduction."""

    name = "abstract"
    wire = False
    lossy = False

    def encode(self, x, block):
        """(payload, scales); scales is None for cast codecs."""
        raise NotImplementedError

    def decode(self, payload, scales, block, dtype=torch.float32):
        raise NotImplementedError

    def wire_bytes(self, nelems, block, orig_itemsize):
        """Payload and scale bytes this codec puts on the wire for
        ``nelems`` values of an ``orig_itemsize``-wide input."""
        raise NotImplementedError


def _block_view(x, block):
    """The last dim reshaped into (nblocks, block); the caller pads to a
    multiple of ``block`` first."""
    if x.shape[-1] % block:
        raise ValueError(
            f"codec input last axis {x.shape[-1]} is not a multiple of "
            f"block size {block} (the dispatch layer pads first)")
    return x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // block, block))


class _BlockCodec(Codec):
    """Per-block scale = max|block| / qmax; all-zero blocks are safe."""

    wire = True
    lossy = True
    qmax = None
    payload_dtype = None    # the dtype the payload has on the wire
    payload_itemsize = 1

    def _to_payload(self, v):
        raise NotImplementedError

    def _from_payload(self, q):
        raise NotImplementedError

    def encode(self, x, block):
        xb = _block_view(x.to(torch.float32), block)
        maxabs = xb.abs().amax(dim=-1, keepdim=True)
        scale = maxabs / self.qmax
        # An all-zero block: scale 0 would divide to nan; its payload is
        # zeros either way, so any nonzero divisor is right.
        safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
        q = self._to_payload(xb / safe)
        return q.reshape(x.shape), scale.squeeze(-1)

    def decode(self, payload, scales, block, dtype=torch.float32):
        qb = self._from_payload(_block_view(payload, block))
        return (qb * scales.to(torch.float32).unsqueeze(-1)).reshape(
            payload.shape).to(dtype)

    def wire_bytes(self, nelems, block, orig_itemsize):
        nblocks = -(-nelems // block)
        return nelems * self.payload_itemsize + nblocks * 4


class Int8BlockCodec(_BlockCodec):
    """Symmetric per-block int8: q = round(x * 127 / max|block|), half to
    even. Round-trip error is at most scale / 2 = max|block| / 254."""

    name = "int8"
    qmax = _INT8_QMAX
    payload_dtype = torch.int8

    def _to_payload(self, v):
        return torch.round(v).clamp_(-_INT8_QMAX, _INT8_QMAX).to(torch.int8)

    def _from_payload(self, q):
        return q.to(torch.float32)


class FP8BlockCodec(_BlockCodec):
    """Per-block-scaled float8_e4m3fn: the block max maps to 448, the
    largest finite value, keeping 3 mantissa bits across the block's
    range. The payload rides collectives viewed as uint8."""

    name = "fp8"
    qmax = 448.0
    payload_dtype = torch.uint8

    def _to_payload(self, v):
        return v.to(torch.float8_e4m3fn).view(torch.uint8)

    def _from_payload(self, q):
        return q.view(torch.float8_e4m3fn).to(torch.float32)


class _CastCodec(Codec):
    """A cast on the wire: a plain allreduce carries and accumulates the
    narrow dtype."""

    lossy = True
    cast_dtype = None
    cast_itemsize = 2

    def encode(self, x, block):
        return x.to(self.cast_dtype), None

    def decode(self, payload, scales, block, dtype=torch.float32):
        return payload.to(dtype)

    def wire_bytes(self, nelems, block, orig_itemsize):
        return nelems * self.cast_itemsize


class FP16CastCodec(_CastCodec):
    name = "fp16"
    cast_dtype = torch.float16


class BF16CastCodec(_CastCodec):
    name = "bf16"
    cast_dtype = torch.bfloat16


class NoneCodec(Codec):
    name = "none"

    def encode(self, x, block):
        return x, None

    def decode(self, payload, scales, block, dtype=torch.float32):
        return payload.to(dtype)

    def wire_bytes(self, nelems, block, orig_itemsize):
        return nelems * orig_itemsize


CODECS = {c.name: c for c in (NoneCodec(), FP16CastCodec(),
                              BF16CastCodec(), Int8BlockCodec(),
                              FP8BlockCodec())}


def fp8_supported():
    """True when this torch build has ``float8_e4m3fn`` (the autotuner's
    codec-availability key; the JAX package's ``fp8_supported``)."""
    return hasattr(torch, "float8_e4m3fn")


def get_codec(name):
    codec = CODECS.get(name)
    if codec is None:
        raise ValueError(
            f"unknown compression codec {name!r}; available: "
            f"{', '.join(sorted(CODECS))}")
    return codec


def padded_len(nelems, nranks, block):
    """Smallest length >= nelems divisible by nranks * block (every rank
    owns an equal whole number of blocks after the reduce-scatter)."""
    unit = nranks * block
    return -(-nelems // unit) * unit


def quantized_allreduce_plain(stacked, codec="int8", block=DEFAULT_BLOCK,
                              average=True):
    """The quantized allreduce of ``stacked`` (rank r's tensor is
    ``stacked[r]``) with no collective: the counterpart of the JAX
    package's in-jit ``quantized_allreduce_axis``, and the plain version
    that the data planes' pipelines are held to.

    Each rank's flat float32 tensor is padded to a multiple of n * block
    and cut into n chunks; the reduce-scatter leg gives rank j every
    rank's quantized chunk j, which it dequantizes and sums in float32
    (then divides by n for ``average``), requantizes, and the allgather leg
    returns to every rank, where it is dequantized. Returns the result
    every rank holds, in the input's shape and dtype."""
    c = get_codec(codec) if isinstance(codec, str) else codec
    if not c.wire:
        raise ValueError(
            f"quantized_allreduce_plain needs a wire codec, got {c.name!r}")
    n = stacked.shape[0]
    shape, dtype = tuple(stacked.shape[1:]), stacked.dtype
    flat = stacked.reshape(n, -1).to(torch.float32)
    nelems = flat.shape[1]
    padded = padded_len(nelems, n, block)
    if padded != nelems:
        flat = torch.nn.functional.pad(flat, (0, padded - nelems))
    rows = flat.reshape(n, n, padded // n)   # [rank, chunk, elements]
    q, s = c.encode(rows, block)
    # Reduce-scatter leg: chunk j of every rank, summed in float32 in rank
    # order.
    red = c.decode(q, s, block).sum(dim=0)   # [chunk, elements]
    if average:
        red = red / n
    q2, s2 = c.encode(red, block)
    out = c.decode(q2, s2, block).reshape(-1)[:nelems]
    return out.reshape(shape).to(dtype)

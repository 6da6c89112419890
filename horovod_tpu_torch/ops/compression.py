"""Gradient compression: the user-facing ``Compression`` surface (port of
``horovod_tpu/ops/compression.py``; reference: horovod/torch/compression.py).

- **Cast compressors** (``fp16``, ``bf16``): ``compress``/``decompress``
  are dtype casts around the collective, the reference's semantics.
- **Wire compressors** (``int8``, ``fp8``): block-wise quantization that
  must run inside the collective (a sum of raw int8 payloads would be
  garbage), so ``compress`` is the identity and ``wire_codec`` routes the
  allreduce through the data plane's quantized pipeline
  (``horovod_tpu_torch/compression/``). Block size, error feedback and the
  name policy come from the ``HVDTPU_COMPRESSION*`` knobs.
"""

import torch


class Compressor:
    """Interface: ``compress(tensor) -> (tensor, ctx)`` and
    ``decompress(tensor, ctx) -> tensor``."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Sends tensors as they are."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Cast floating tensors to ``dtype`` before the collective and back
    after it; other tensors pass as they are."""

    dtype = None

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.dtype:
            return tensor.to(cls.dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """fp16 on the wire (reference: horovod/torch/compression.py)."""

    dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 on the wire: fp32's range, half its bytes."""

    dtype = torch.bfloat16


class _WireCompressor(Compressor):
    """Quantized codecs executed inside the collective: compress and
    decompress are identities, ``wire_codec`` names the pipeline."""

    wire_codec = None

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class Int8Compressor(_WireCompressor):
    """Block-wise int8 quantized allreduce (per-block float32 scales,
    error-feedback residuals where the plane keeps them)."""

    wire_codec = "int8"


class FP8Compressor(_WireCompressor):
    """Block-wise-scaled float8_e4m3fn quantized allreduce."""

    wire_codec = "fp8"


class Compression:
    """Optional gradient compression used during allreduce."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor

"""Gradient compression namespace (port of ``horovod_tpu/ops/compression.py``;
reference: horovod/torch/compression.py).

Only ``Compression.none`` is ported. The casts and wire codecs keep their
names so that scripts naming them fail with the ROADMAP item that ports
them, not with an AttributeError.
"""


class Compressor:
    """Interface: ``compress(tensor) -> (tensor, ctx)`` and
    ``decompress(tensor, ctx) -> tensor``."""


class NoneCompressor(Compressor):
    """Sends tensors as they are."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _NotPorted(Compressor):
    @classmethod
    def compress(cls, tensor):
        raise not_ported(cls)

    @classmethod
    def decompress(cls, tensor, ctx):
        raise not_ported(cls)


class FP16Compressor(_NotPorted):
    pass


class BF16Compressor(_NotPorted):
    pass


class Int8Compressor(_NotPorted):
    pass


class FP8Compressor(_NotPorted):
    pass


class Compression:
    """Optional gradient compression used during allreduce."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    fp8 = FP8Compressor


def not_ported(compression):
    return NotImplementedError(
        f"compression {getattr(compression, '__name__', compression)} is not "
        "ported yet (ROADMAP queue A, item 9)")


def check(compression):
    """Raise unless ``compression`` sends tensors as they are."""
    if compression not in (None, Compression.none):
        raise not_ported(compression)

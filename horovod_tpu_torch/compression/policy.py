"""Per-tensor compression policy (port of
``horovod_tpu/compression/policy.py``).

``HVDTPU_COMPRESSION`` is a bare codec name (every eligible tensor)::

    HVDTPU_COMPRESSION=int8

or a ';'-separated, first-match-wins list of ``glob=codec`` rules over
tensor names, a bare codec acting as the ``*`` catch-all::

    HVDTPU_COMPRESSION='*bias*=none;embed*=bf16;int8'

Eligible: an allreduce of a floating tensor of at least
``HVDTPU_COMPRESSION_THRESHOLD`` elements (default 1024) under Sum or
Average. Min/Max/Product are not gradient math and stay uncompressed.

Two interactions raise instead of being skipped: Adasum (its combination
needs the exact per-rank gradients) and a process set other than the
global one (the quantized pipeline is wired for the global set only).
Malformed specs raise when the plane is built, at ``init()``.
"""

import fnmatch

from . import codecs
from ..ops import reduce_ops
from ..utils import envparse

DEFAULT_THRESHOLD = 1024


def parse_rules(spec):
    """``spec`` -> [(glob, codec_name)]; unknown codecs raise."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            glob, _, codec_name = part.partition("=")
            glob, codec_name = glob.strip(), codec_name.strip()
            if not glob or not codec_name:
                raise ValueError(
                    f"malformed HVDTPU_COMPRESSION rule {part!r}: "
                    "expected '<name-glob>=<codec>'")
        else:
            glob, codec_name = "*", part
        codecs.get_codec(codec_name)
        rules.append((glob, codec_name))
    return rules


class CompressionPolicy:
    """Evaluates the rule list for one entry's metadata."""

    def __init__(self, rules, threshold=DEFAULT_THRESHOLD):
        self.rules = list(rules)
        self.threshold = int(threshold)

    @classmethod
    def from_env(cls):
        return cls(parse_rules(envparse.get_str(envparse.COMPRESSION, "")),
                   threshold=envparse.get_int(envparse.COMPRESSION_THRESHOLD,
                                              DEFAULT_THRESHOLD))

    def codec_for_name(self, name):
        """The first matching rule's codec name, or None."""
        for glob, codec_name in self.rules:
            if fnmatch.fnmatchcase(name or "", glob):
                return codec_name
        return None

    def select(self, name, nelems, dtype, op, process_set_id):
        """Codec name for an allreduce with this metadata (``dtype`` a
        torch dtype), or None. Raises on Adasum and on a process set other
        than the global one."""
        if not self.rules:
            return None
        if dtype is None or not dtype.is_floating_point:
            return None
        if nelems < self.threshold:
            return None
        codec_name = self.codec_for_name(name)
        if codec_name is None or codec_name == "none":
            return None
        if not codecs.CODECS[codec_name].lossy:
            return None
        if op == reduce_ops.Adasum:
            raise ValueError(
                f"HVDTPU_COMPRESSION selected codec {codec_name!r} for "
                f"Adasum allreduce {name!r}: Adasum's scale-invariant "
                "combination needs exact per-rank gradients, and "
                "quantizing them would silently change the result. "
                "Exclude these tensors ('<glob>=none' rule) or use "
                "Sum/Average.")
        if op not in (reduce_ops.Sum, reduce_ops.Average):
            return None
        if process_set_id not in (0, None):
            raise ValueError(
                f"HVDTPU_COMPRESSION selected codec {codec_name!r} for "
                f"allreduce {name!r} on process set {process_set_id}: "
                "quantized collectives are only wired for the global "
                "process set. Exclude these tensors with a '<glob>=none' "
                "rule.")
        return codec_name


def simple_wire_policy():
    """(codec_name, block, threshold) for the delegated plane, which sees
    sizes and dtypes but no tensor names (fused native responses carry
    handles): only a catch-all ``*`` wire rule applies there. Returns
    (None, block, threshold) when compression is off or cast-only."""
    spec = envparse.get_str(envparse.COMPRESSION, "")
    block = envparse.get_int(envparse.COMPRESSION_BLOCK,
                             codecs.DEFAULT_BLOCK)
    threshold = envparse.get_int(envparse.COMPRESSION_THRESHOLD,
                                 DEFAULT_THRESHOLD)
    for glob, codec_name in parse_rules(spec):
        if glob == "*":
            if codecs.CODECS[codec_name].wire:
                return codec_name, block, threshold
            return None, block, threshold
    return None, block, threshold

"""Gradient compression plane (port of ``horovod_tpu/compression/``).

- :mod:`codecs`: block-wise int8/fp8 quantization (per-block scales) and
  the none/fp16/bf16 casts behind one ``Codec`` interface, plus
  :func:`codecs.quantized_allreduce_plain`, the pipeline with no
  collective.
- :mod:`residual`: the error-feedback store (tensor name, reset when the
  elastic version moves).
- :mod:`policy`: per-tensor selection: size threshold, dtype, name globs;
  Adasum and non-global process sets raise.
- :class:`CompressionPlane`: what the coordinator holds. It stamps entries
  at submit (so that the fusion grouping sees the codec), hands residuals
  to the data plane's quantized pipeline, and feeds the metrics
  (``hvd_compression_ratio``, ``_bytes_saved_total``, ``_error``).

Disabled contract: with ``HVDTPU_COMPRESSION`` unset and no explicit codec,
:func:`make_plane` returns None; the submit path pays one attribute check
and allocates nothing.
"""

from . import codecs, policy, residual  # noqa: F401  (subsystem surface)
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger


def _log_buckets(lo, hi, factor):
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * factor)
    return bounds


# Quantization-error histogram range: gradients live well under 1.0 and
# errors bottom out near float32 epsilon of the block scale.
_ERROR_BUCKETS = _log_buckets(1e-9, 1.0, 4.0)


class CompressionPlane:
    """Policy, residual store and metrics of one coordinator (rebuilt at
    every ``init()``)."""

    def __init__(self, pol, delegated=False):
        self.policy = pol
        self.block = envparse.get_int(envparse.COMPRESSION_BLOCK,
                                      codecs.DEFAULT_BLOCK)
        if self.block <= 0:
            raise ValueError(
                f"HVDTPU_COMPRESSION_BLOCK must be positive, got "
                f"{self.block}")
        self.error_feedback = envparse.get_bool(
            envparse.COMPRESSION_ERROR_FEEDBACK, True)
        self.residuals = residual.ResidualStore()
        self._delegated = delegated
        self._log = get_logger()
        self._metrics_on = telemetry.enabled()
        # The error histogram reads every residual back to the host: one
        # bucket in 16 (the first included).
        self._err_buckets = 0
        self._m_ratio = telemetry.gauge(
            "hvd_compression_ratio",
            "Wire bytes / original payload bytes of the last compressed "
            "bucket", labelnames=("codec",))
        self._m_saved = telemetry.counter(
            "hvd_compression_bytes_saved_total",
            "Payload bytes kept off the wire by compression",
            labelnames=("codec",))
        self._m_err = telemetry.histogram(
            "hvd_compression_error",
            "Per-tensor max-abs quantization error (the error-feedback "
            "residual's magnitude)", labelnames=("codec",),
            buckets=_ERROR_BUCKETS)

    # -- submit side (the submitting thread) -------------------------------
    def stamp(self, entry):
        """Resolve ``entry.codec`` from the explicit request (a codec name
        set by ``Compression.int8``-style markers) or the env policy into
        the ``(name, block)`` pair the fusion plane groups by. Raises the
        Adasum and process-set rejects, on the submitting thread."""
        explicit = entry.codec
        entry.codec = None
        if self._delegated and explicit is None:
            # The delegated plane applies the env policy's catch-all to
            # unstamped responses when it executes them
            # (policy.simple_wire_policy): fused native responses carry
            # handles, not names.
            return
        nelems = sum(t.numel() for t in entry.tensors)
        dtype = entry.tensors[0].dtype if entry.tensors else None
        if explicit is not None:
            codec = codecs.get_codec(explicit)
            if not codec.wire:
                # Cast compressors run at the user layer: nothing to stamp.
                return
            self._validate_wire(explicit, entry)
            entry.codec = (explicit, self.block)
            return
        name = self.policy.select(entry.name, nelems, dtype, entry.op,
                                  entry.process_set.process_set_id)
        if name is None:
            return
        entry.codec = (name, self.block if codecs.CODECS[name].wire else 0)

    def _validate_wire(self, codec_name, entry):
        from ..ops import reduce_ops
        if entry.op not in (None, reduce_ops.Sum, reduce_ops.Average,
                            reduce_ops.Adasum):
            raise ValueError(
                f"compression={codec_name!r} with "
                f"op={reduce_ops.op_name(entry.op)}: quantized collectives "
                "support Sum/Average only (dequantize-then-accumulate is "
                "an identity of linear reductions)")
        if entry.op == reduce_ops.Adasum:
            raise ValueError(
                f"compression={codec_name!r} with op=Adasum: Adasum needs "
                "exact per-rank gradients (quantizing them silently "
                "changes the scale-invariant combination). Drop the "
                "compressor or use Sum/Average.")
        if entry.process_set.process_set_id != 0:
            raise ValueError(
                f"compression={codec_name!r} on process set "
                f"{entry.process_set.process_set_id}: quantized "
                "collectives are only wired for the global process set.")

    # -- dispatch side (the cycle thread) ----------------------------------
    def residuals_in(self, bucket):
        """Flat float32 residual list aligned with the bucket's flat tensor
        list (zeros where none is stored or a shape moved), or None when
        error feedback is off."""
        if not self.error_feedback:
            return None
        import torch
        out = []
        for e in bucket:
            stored = self.residuals.get(e.name) if e.name else None
            if (stored is None or len(stored) != len(e.tensors)
                    or any(r.shape != t.shape or r.device != t.device
                           for r, t in zip(stored, e.tensors))):
                stored = [torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device) for t in e.tensors]
            out.extend(stored)
        return out

    def store_residuals(self, bucket, flat_residuals):
        i = 0
        for e in bucket:
            k = len(e.tensors)
            if e.name:
                self.residuals.put(e.name, flat_residuals[i:i + k])
            i += k

    def record(self, codec_name, bucket, flat_tensors, flat_residuals):
        """Metrics of one executed bucket: the ratio gauge, the bytes-saved
        counter and, where residuals exist, the per-tensor max-abs error
        histogram. No-op with metrics off."""
        if not self._metrics_on:
            return
        codec = codecs.CODECS[codec_name]
        orig = wire = 0
        for t in flat_tensors:
            n = t.numel()
            orig += n * t.element_size()
            wire += codec.wire_bytes(n, self.block, t.element_size())
        if orig:
            self._m_ratio.labels(codec=codec_name).set(wire / orig)
            self._m_saved.labels(codec=codec_name).inc(max(0, orig - wire))
        if flat_residuals is not None:
            self._err_buckets += 1
            if (self._err_buckets - 1) % 16:
                return
            i = 0
            for e in bucket:
                k = len(e.tensors)
                err = max(float(r.abs().max()) if r.numel() else 0.0
                          for r in flat_residuals[i:i + k])
                self._m_err.labels(codec=codec_name).observe(err)
                i += k


def make_plane(runtime=None, force=False):
    """A CompressionPlane when ``HVDTPU_COMPRESSION`` is set (or ``force``,
    for an explicit per-call codec with the env unset); None otherwise."""
    spec = envparse.get_str(envparse.COMPRESSION, "")
    if not spec and not force:
        return None
    delegated = bool(runtime is not None
                     and getattr(getattr(runtime, "backend", None),
                                 "delegate_data_ops", False))
    return CompressionPlane(policy.CompressionPolicy.from_env(),
                            delegated=delegated)

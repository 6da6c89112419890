"""Environment-variable driven configuration.

The reference framework is configured exclusively through environment
variables (reference: horovod/common/common.h:107-141, utils/env_parser.cc).
We keep the same model: every runtime knob has an ``HVDTPU_*`` name and, for
drop-in compatibility with scripts written for the reference, the matching
``HOROVOD_*`` name is accepted as a fallback.

This is the port's own copy of ``horovod_tpu/utils/envparse.py``, with the
same prefixes and knob names, so that the environment a launcher sets
reaches both packages alike. It declares only the knobs the port reads;
each further knob comes with the module that reads it.
"""

import os

# HOROVOD_TPU_ sits between the native spelling and the reference
# fallback: it is the documented prefix for the TPU-only correctness
# knobs (HOROVOD_TPU_ORDER_CHECK, HOROVOD_TPU_STALL_CHECK_TIME) that
# have no reference analog.
_PREFIXES = ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_")


def get_env(name, default=None):
    """Look up knob ``name`` (without prefix) under HVDTPU_ then HOROVOD_."""
    for prefix in _PREFIXES:
        val = os.environ.get(prefix + name)
        if val is not None:
            return val
    return default


def _warn_malformed(name, val, default):
    import warnings
    warnings.warn(
        f"Environment knob {name}={val!r} is not a valid number; using "
        f"default {default!r}", stacklevel=3)


def get_int(name, default=0):
    val = get_env(name)
    if val is None or val == "":
        return default
    try:
        return int(val)
    except ValueError:
        _warn_malformed(name, val, default)
        return default


def get_bool(name, default=False):
    val = get_env(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def get_str(name, default=""):
    val = get_env(name)
    return default if val is None else val


# --------------------------------------------------------------------------
# Knob registry: every user-facing knob the port reads is declared through
# register(), under the JAX package's name and default.
# --------------------------------------------------------------------------

#: name (without prefix) -> {"default": str, "doc": str}
KNOBS = {}


def register(name, default, doc):
    """Declare a user-facing knob; returns ``name`` so declarations
    double as the module-level constants call sites import."""
    KNOBS[name] = {"default": default, "doc": doc}
    return name


LOG_LEVEL = register(
    "LOG_LEVEL", "warning", "trace/debug/info/warning/error")
BUCKET_BYTES = register(
    "BUCKET_BYTES", "16 MiB",
    "Payload bytes per gradient bucket of DistributedOptimizer's "
    "reduction")
ZERO = register(
    "ZERO", "0",
    "ZeRO-1 cross-replica sharded weight update (not ported yet: "
    "DistributedOptimizer raises when it is on)")

# -- kernels ----------------------------------------------------------------
BRIDGE_FLASH = register(
    "BRIDGE_FLASH", "auto",
    "Route torch-bridge attention on CPU tensors through the flash "
    "kernels' plain versions: auto (no: the einsum lowering) | always | "
    "never. CUDA tensors always take the kernels; never raises there")
FLASH_DROPOUT = register(
    "FLASH_DROPOUT", "auto",
    "Flash-attention dropout strategy: auto (the seeded, Philox, kernels "
    "on CUDA tensors; an explicit keep-mask on the CPU) | mask | prng")

# --------------------------------------------------------------------------
# Launcher-set variables (analog of HOROVOD_RANK/SIZE/...; reference:
# horovod/runner/gloo_run.py:65-77). NOT registered: they are outputs
# the launcher exports for its workers, not knobs a user tunes — the
# registry/docs cross-check covers knobs only.
# --------------------------------------------------------------------------
RANK = "RANK"
SIZE = "SIZE"
LOCAL_RANK = "LOCAL_RANK"
LOCAL_SIZE = "LOCAL_SIZE"
CROSS_RANK = "CROSS_RANK"
CROSS_SIZE = "CROSS_SIZE"

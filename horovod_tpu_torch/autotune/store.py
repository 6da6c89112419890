"""Persistent warm-start store for converged autotune winners (port of
``horovod_tpu/autotune/store.py``; the same file format, so either
package reads the other's file).

One JSON file (``HVDTPU_AUTOTUNE_CACHE``) maps a workload key —
``(model-signature, world-size, codec-availability)`` — to the
converged knob config, its score, the elastic version it was validated
under, and the sweep history that produced it. A repeat run loads the
file at init and applies the stored winner before the first scored
window (core.ParameterManager warm-start); ``hvd-autotune`` renders,
diffs and clears it.

The model signature is trace-driven: the sorted set of collective
tensor names observed during the warmup window (the flight-recorder
ring — on by default — already holds them), hashed. Tensor names are
identical on every rank of a correct program (the same invariant the
tracer's correlation keys and the guardian's sampled slots rely on),
so every rank derives the same key without a collective.
``HVDTPU_AUTOTUNE_SIGNATURE`` overrides it for jobs that disable the
flight recorder or want explicit cache identities.

Failure contract: a corrupt or schema-stale file NEVER breaks init —
:func:`load` raises :class:`StoreError`, the tuner logs it loudly,
counts it (``hvd_autotune_warm_start_total{outcome=corrupt}``) and
runs a fresh sweep; the next converged save atomically replaces the
bad file.
"""

import hashlib
import json
import os
import time

#: Schema version of the cache file; entries written under a different
#: format are stale and trigger a fresh sweep (loudly).
FORMAT = 1

#: Config keys a valid entry must carry (None allowed per plane).
CONFIG_KEYS = ("fusion_threshold", "cycle_time_ms", "min_bucket",
               "bucket_bytes", "compression", "compression_threshold",
               "zero_bucket_bytes")


class StoreError(Exception):
    """Cache file unreadable / corrupt / schema-stale."""


def model_signature(names):
    """Hash of the sorted collective-name set observed during warmup
    (``hvdlint.*`` guard-internal ops excluded — they submit on a
    timer, not per step)."""
    keep = sorted({n for n in names
                   if n and not n.startswith("hvdlint.")})
    if not keep:
        return "default"
    digest = hashlib.sha1(",".join(keep).encode()).hexdigest()[:12]
    return f"m{digest}"


def codec_signature(runtime):
    """Availability half of the key: which wire codecs this build
    carries and whether the backend has the quantized pipeline — a
    cache entry tuned with fp8 must not warm-start a build without
    it."""
    from ..compression import codecs
    avail = ["int8"] + (["fp8"] if codecs.fp8_supported() else [])
    backend = getattr(runtime, "backend", None)
    if backend is not None and hasattr(backend, "allreduce_quantized"):
        avail.append("q")
    return "+".join(avail)


def make_key(signature, world, codec_sig):
    return f"{signature}|w{world}|{codec_sig}"


def load(path):
    """Entries dict of a cache file. Missing file -> ``{}`` (a first
    run is not an error); anything unreadable/invalid ->
    :class:`StoreError` naming the problem."""
    if not os.path.exists(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as exc:
        raise StoreError(f"cannot parse autotune cache {path}: {exc}")
    if not isinstance(data, dict) or "entries" not in data:
        raise StoreError(
            f"autotune cache {path} has no 'entries' table")
    if data.get("format") != FORMAT:
        raise StoreError(
            f"autotune cache {path} is format {data.get('format')!r}, "
            f"this build writes format {FORMAT}")
    entries = data["entries"]
    if not isinstance(entries, dict):
        raise StoreError(f"autotune cache {path}: 'entries' is not a "
                         "table")
    return entries


def validate_entry(entry):
    """None when ``entry`` is usable, else a short reason string (the
    tuner treats a bad entry as stale: loud warning + fresh sweep)."""
    if not isinstance(entry, dict):
        return "entry is not an object"
    cfg = entry.get("config")
    if not isinstance(cfg, dict):
        return "no config object"
    missing = [k for k in CONFIG_KEYS if k not in cfg]
    if missing:
        return f"config missing {missing}"
    for k in ("fusion_threshold", "cycle_time_ms"):
        if not isinstance(cfg[k], (int, float)):
            return f"config.{k} is not numeric"
    return None


def _write(path, entries):
    """Atomic whole-file write (tmp + rename) of an entries table."""
    payload = {"format": FORMAT, "entries": entries}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def save_entry(path, key, entry):
    """Read-modify-write the cache with one entry upserted, atomically.
    An existing corrupt file is replaced rather than crashed on — the
    save IS the repair. Raises OSError on unwritable paths (the caller
    logs; tuning results must never kill a job)."""
    try:
        entries = load(path)
    except StoreError:
        entries = {}
    entries[key] = entry
    _write(path, entries)


def clear(path, key=None):
    """Remove one entry (or the whole file). Returns the number of
    entries removed."""
    if key is None:
        if os.path.exists(path):
            try:
                n = len(load(path))
            except StoreError:
                n = 0
            os.remove(path)
            return n
        return 0
    entries = load(path)
    if key not in entries:
        return 0
    del entries[key]
    _write(path, entries)
    return 1


def make_entry(config, score, source, signature, world, codec_sig,
               elastic_version, history, predicted=None):
    """The JSON shape one converged sweep persists. ``predicted``
    (optional) carries the α–β cost model's per-arm predicted cost of
    the winner when the sweep ran with ``HVDTPU_COSTMODEL`` priors —
    audit data for prediction-vs-measured drift, ignored by
    validate_entry so old readers and old entries interoperate."""
    entry = {
        "config": dict(config),
        "score": float(score),
        "score_source": source,
        "signature": signature,
        "world": int(world),
        "codecs": codec_sig,
        "elastic_version": str(elastic_version),
        "updated_unix": time.time(),
        "history": [[arm, int(rnd), cand, float(mean)]
                    for arm, rnd, cand, mean in history],
    }
    if predicted is not None:
        entry["predicted"] = predicted
    return entry

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


def get_float(name, default=0.0):
    val = get_env(name)
    if val is None or val == "":
        return default
    try:
        return float(val)
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

# -- ZeRO-1 sharded weight update (ops/zero.py) -------------------------------
ZERO = register(
    "ZERO", "0",
    "ZeRO-1 cross-replica sharded weight update: gradients "
    "reduce-scatter per bucket, each replica steps 1/n of a sharded "
    "optimizer state, updated shards allgather back (ops/zero.py)")
ZERO_BUCKET_BYTES = register(
    "ZERO_BUCKET_BYTES", "16 MiB",
    "Payload bytes per ZeRO fusion bucket (reduce-scatter/allgather "
    "legs); defaults to the overlap plane's bucket budget")

# -- redistribution planner (resharding/) -------------------------------------
RESHARD_BUCKET_BYTES = register(
    "RESHARD_BUCKET_BYTES", "4 MiB",
    "Window budget of redistribution-planner collective steps "
    "(horovod_tpu_torch/resharding/): no step stages more than this many "
    "bytes per rank, so an elastic reshard or train->serve transform "
    "never materializes a fully-replicated leaf")

# -- control plane (coordinator, native core) --------------------------------
CYCLE_TIME = register(
    "CYCLE_TIME", "1.0 ms",
    "Background cycle period in ms (reference: HOROVOD_CYCLE_TIME)")
FUSION_THRESHOLD = register(
    "FUSION_THRESHOLD", "128 MiB",
    "Fusion buffer cap in bytes (reference: HOROVOD_FUSION_THRESHOLD)")
CACHE_CAPACITY = register(
    "CACHE_CAPACITY", "1024",
    "Response cache entries (reference: HOROVOD_CACHE_CAPACITY)")
HIERARCHICAL_THRESHOLD = register(
    "HIERARCHICAL_THRESHOLD", "1 MiB",
    "Minimum bytes for the two-level (intra-host / cross-host) allreduce "
    "and allgather on the TCP plane; 0 disables")
CPU_OPERATIONS = register(
    "CPU_OPERATIONS", "tcp",
    "Data plane of CPU tensors in a launcher job: tcp (default: the native "
    "ring) or nccl/xla/xla-global (the delegated plane, over gloo)")
TIMELINE = register(
    "TIMELINE", "", "Path of the Chrome-trace timeline written at init")
TIMELINE_MARK_CYCLES = register(
    "TIMELINE_MARK_CYCLES", "off", "Mark each cycle in the timeline")
STALL_CHECK_DISABLE = register(
    "STALL_CHECK_DISABLE", "0", "Disable the stall warning")
STALL_CHECK_TIME = register(
    "STALL_CHECK_TIME", "60",
    "Seconds before an in-flight tensor is reported as stalled "
    "(HOROVOD_TPU_STALL_CHECK_TIME; 0 disables)")
STALL_CHECK_TIME_SECONDS = register(
    "STALL_CHECK_TIME_SECONDS", "60",
    "Reference spelling of STALL_CHECK_TIME; also the native core's "
    "stall-warning time")
STALL_SHUTDOWN_TIME_SECONDS = register(
    "STALL_SHUTDOWN_TIME_SECONDS", "0",
    "Fail a tensor stalled this long (0 = never)")
METRICS = register(
    "METRICS", "0",
    "Collect the coordinator's and the backends' metrics (HOROVOD_TPU_"
    "METRICS); off, every metric is a shared no-op")
METRICS_PUSH_INTERVAL = register(
    "METRICS_PUSH_INTERVAL", "5",
    "Seconds between per-rank snapshot pushes to the launcher's KV store")
METRICS_SNAPSHOT = register(
    "METRICS_SNAPSHOT", "BENCH_metrics.json",
    "Path where a benchmark run archives its telemetry snapshot "
    "(telemetry.archive_snapshot)")
METRICS_DUMP = register(
    "METRICS_DUMP", "", "Final JSON snapshot path written at shutdown")

# -- cross-rank tracing (tracing/) --------------------------------------------
TRACE = register(
    "TRACE", "0",
    "Cross-rank trace plane: write a per-rank JSONL trace shard with "
    "correlated collective spans (name x occurrence x elastic version) "
    "and push it to the launcher's KV store for the tracing CLI's "
    "merge/report")
TRACE_DIR = register(
    "TRACE_DIR", "hvd_traces",
    "Directory for trace shards and flight-recorder postmortem dumps")
FLIGHT_RECORDER = register(
    "FLIGHT_RECORDER", "1",
    "Always-on bounded ring of recent collective and negotiation events; "
    "dumped to a postmortem shard on a collective abort or mismatch "
    "(0 disables)")
FLIGHT_RECORDER_EVENTS = register(
    "FLIGHT_RECORDER_EVENTS", "4096",
    "Flight-recorder ring capacity, events per rank")
LEGACY_AUTO_NAMES = register(
    "LEGACY_AUTO_NAMES", "0",
    "Name unnamed collectives by a process-global counter instead of by "
    "call site")

# -- elastic training and the launcher (runner/, elastic.py) -----------------
ELASTIC = register(
    "ELASTIC", "0",
    "Elastic worker mode: ranks come from the driver's rendezvous "
    "store, not launcher env (set by the launcher's --min-np/--max-np)")
ELASTIC_CHECK_INTERVAL = register(
    "ELASTIC_CHECK_INTERVAL", "0.2",
    "Seconds between elastic host-update checks at commit boundaries")
START_TIMEOUT = register(
    "START_TIMEOUT", "120",
    "Seconds workers wait at rendezvous for the full cohort "
    "(launcher --start-timeout)")
KV_RETRIES = register(
    "KV_RETRIES", "8", "KV client: max retries per call")
KV_BACKOFF = register(
    "KV_BACKOFF", "0.05", "KV client: initial backoff seconds")
KV_DEADLINE = register(
    "KV_DEADLINE", "30", "KV client: overall per-call deadline seconds")
HEARTBEAT_INTERVAL = register(
    "HEARTBEAT_INTERVAL", "2",
    "Worker: seconds between heartbeat lease renewals")
HEARTBEAT_TIMEOUT = register(
    "HEARTBEAT_TIMEOUT", "30",
    "Driver: fail a worker whose lease stops changing for this long")
SIGKILL_DEADLINE = register(
    "SIGKILL_DEADLINE", "10",
    "Driver: seconds between SIGTERM and SIGKILL on worker stop")

# -- fault tolerance (guardian.py, checkpoint.py) ------------------------------
CONSISTENCY_CHECK = register(
    "CONSISTENCY_CHECK", "0",
    "Data-plane guardian: cross-rank metadata digest check "
    "(0 off, 1 every named collective, N>1 sampled)")
CONSISTENCY_TIMEOUT = register(
    "CONSISTENCY_TIMEOUT", "10",
    "Seconds the pre-dispatch check waits for peer digests")
COLLECTIVE_TIMEOUT = register(
    "COLLECTIVE_TIMEOUT", "0",
    "Stuck-collective watchdog: coordinated abort past this age; 0 off")
CHECKPOINT_KEEP = register(
    "CHECKPOINT_KEEP", "0",
    "Keep only the newest N step_<N> checkpoints; 0 keeps everything")

# -- autotuner (autotune/) ----------------------------------------------------
AUTOTUNE = register(
    "AUTOTUNE", "0", "Enable the successive-halving parameter sweep")
AUTOTUNE_LOG = register(
    "AUTOTUNE_LOG", "", "CSV of per-round candidate scores")
AUTOTUNE_FUSION_CANDIDATES_MIB = register(
    "AUTOTUNE_FUSION_CANDIDATES_MIB", "0..128", "Fusion-threshold grid")
AUTOTUNE_CYCLE_CANDIDATES_MS = register(
    "AUTOTUNE_CYCLE_CANDIDATES_MS", "0.1..10", "Cycle-time grid")
AUTOTUNE_BUCKET_CANDIDATES = register(
    "AUTOTUNE_BUCKET_CANDIDATES", "256,4096,65536",
    "Delegated-plane bucket floors")
AUTOTUNE_WARMUP_CYCLES = register(
    "AUTOTUNE_WARMUP_CYCLES", "10", "Active cycles before scoring")
AUTOTUNE_CYCLES_PER_CANDIDATE = register(
    "AUTOTUNE_CYCLES_PER_CANDIDATE", "20",
    "Scoring budget of the final halving round")
AUTOTUNE_CACHE = register(
    "AUTOTUNE_CACHE", "",
    "Persistent warm-start store (JSON): converged winners per "
    "(model-signature, world-size, codec-availability) key, applied "
    "before the first scored window on repeat runs; inspect with "
    "hvd-autotune")
AUTOTUNE_SIGNATURE = register(
    "AUTOTUNE_SIGNATURE", "",
    "Explicit model-signature half of the warm-start key (default: "
    "hash of the collective names observed during warmup)")
AUTOTUNE_SCORE = register(
    "AUTOTUNE_SCORE", "auto",
    "Candidate score source: auto (trace-derived steps/sec when the "
    "flight ring shows step structure, bytes/sec otherwise), steps, "
    "or bytes")
AUTOTUNE_CONFIRM_CYCLES = register(
    "AUTOTUNE_CONFIRM_CYCLES", "10",
    "Scoring window of the warm-start re-validation after an "
    "elastic-version bump (baseline window + warm window)")
AUTOTUNE_BUCKET_BYTES_CANDIDATES_MIB = register(
    "AUTOTUNE_BUCKET_BYTES_CANDIDATES_MIB", "1,4,16,64",
    "Overlap-plane bucket-bytes grid (the overlap arm; only when "
    "HVDTPU_OVERLAP is on)")
AUTOTUNE_COMPRESSION_CANDIDATES = register(
    "AUTOTUNE_COMPRESSION_CANDIDATES", "",
    "Compression-codec grid for the compression arm (default: the "
    "current catch-all codec, none, int8, bf16 — availability-"
    "filtered; only when a pure catch-all policy is active)")
AUTOTUNE_COMPRESSION_THRESHOLD_CANDIDATES = register(
    "AUTOTUNE_COMPRESSION_THRESHOLD_CANDIDATES", "",
    "Compression element-threshold grid for the compression arm "
    "(default: the current threshold only)")
AUTOTUNE_ZERO_BUCKET_CANDIDATES_MIB = register(
    "AUTOTUNE_ZERO_BUCKET_CANDIDATES_MIB", "4,16,64",
    "ZeRO-leg bucket-bytes grid (the zero arm; single-controller "
    "mode with HVDTPU_ZERO on)")
# The autotuner's prior (analysis/costmodel.py).
COSTMODEL = register(
    "COSTMODEL", "0",
    "Calibrated α–β cost model as an autotuner warm-start prior: the "
    "sweep probes candidates in the model's predicted order (pure "
    "prior — measured scores still decide; analysis/costmodel.py)")
COSTMODEL_TABLE = register(
    "COSTMODEL_TABLE", "",
    "Path to a calibrated cost-model table JSON (hvd-lint perf "
    "--calibrate --write-table); unset falls back to the built-in "
    "default table")

# -- fault injection (chaos/) --------------------------------------------------
CHAOS = register(
    "CHAOS", "",
    "Fault-injection spec (point:action[:param]*; validate: hvd-chaos)")
CHAOS_LOG = register(
    "CHAOS_LOG", "", "Append one line per chaos firing to this file")

# -- control-plane HA (runner/journal.py, runner/standby.py) -------------------
DRIVER_JOURNAL = register(
    "DRIVER_JOURNAL", "",
    "Directory for the driver's append-only fsync'd control-plane "
    "journal (membership, blacklist, durable KV scopes) + periodic "
    "snapshot; enables the /journal standby-sync route. Unset: no "
    "journal I/O at all")
DRIVER_JOURNAL_SNAPSHOT_EVERY = register(
    "DRIVER_JOURNAL_SNAPSHOT_EVERY", "256",
    "Journal entries between full-state snapshots (journal rotation)")
DRIVER_STANDBY_ADDRS = register(
    "DRIVER_STANDBY_ADDRS", "",
    "Primary driver: comma-separated host:port standby endpoints, "
    "exported to workers as HVDTPU_RENDEZVOUS_ADDRS (primary first) "
    "so their KV client can fail over")
DRIVER_LEASE_INTERVAL = register(
    "DRIVER_LEASE_INTERVAL", "1",
    "Standby: seconds between /journal polls against the primary "
    "(each successful poll renews the primary's lease)")
DRIVER_LEASE_TIMEOUT = register(
    "DRIVER_LEASE_TIMEOUT", "10",
    "Standby: promote to primary after the primary has been "
    "unreachable this long (term bump + takeover)")
DRIVER_PORT = register(
    "DRIVER_PORT", "0",
    "Fixed KV-store listen port for the driver/standby (0 = "
    "ephemeral; standbys need a port workers can be told in advance)")

# -- gradient compression (compression/) -------------------------------------
COMPRESSION = register(
    "COMPRESSION", "",
    "Gradient-compression policy: a codec (none/fp16/bf16/int8/fp8) or "
    "';'-separated '<name-glob>=<codec>' rules, first match wins")
COMPRESSION_THRESHOLD = register(
    "COMPRESSION_THRESHOLD", "1024",
    "Min elements before the compression policy applies to a tensor")
COMPRESSION_BLOCK = register(
    "COMPRESSION_BLOCK", "256",
    "Quantization block size: one f32 scale per this many values")
COMPRESSION_ERROR_FEEDBACK = register(
    "COMPRESSION_ERROR_FEEDBACK", "1",
    "Carry per-tensor quantization error into the next step's "
    "gradient (every plane; per tensor name and elastic version)")

# -- sparse/embedding gradients (ops/sparse.py) --------------------------------
SPARSE = register(
    "SPARSE", "",
    "Sparse-gradient path policy: auto/gather/dense or ';'-separated "
    "'<name-glob>=<mode>' rules, first match wins; auto picks "
    "allgather-of-slices vs densify-then-allreduce per tensor from the "
    "EMA-smoothed measured row density against a world-scaled "
    "crossover. Unset: every sparse gradient densifies")
SPARSE_THRESHOLD = register(
    "SPARSE_THRESHOLD", "1.0",
    "Scales the auto-mode crossover density "
    "(theta * 2*row_bytes / ((n-1)*(row_bytes+index_bytes)))")
SPARSE_EMA = register(
    "SPARSE_EMA", "0.8",
    "History weight of the per-name density EMA the auto policy "
    "smooths path decisions with (0 = instantaneous)")

# -- serving plane (serving/) ---------------------------------------------
SERVING_MAX_BATCH_TOKENS = register(
    "SERVING_MAX_BATCH_TOKENS", "256",
    "Per-step scheduler budget: prefill tokens admitted plus one slot "
    "per running sequence may not exceed this")
SERVING_KV_PAGE_SIZE = register(
    "SERVING_KV_PAGE_SIZE", "16",
    "Token slots per KV-cache page")
SERVING_KV_PAGES = register(
    "SERVING_KV_PAGES", "256",
    "KV-cache pages in the per-host pool; admission keeps 1/16 of "
    "them free (the watermark reserve)")
SERVING_QUEUE_LIMIT = register(
    "SERVING_QUEUE_LIMIT", "64",
    "Bound of the per-host admission queue; past it submissions are "
    "rejected 429 + Retry-After (backpressure, never buffering)")
SERVING_SCALE_UP_DEPTH = register(
    "SERVING_SCALE_UP_DEPTH", "32",
    "Autoscaler: total cohort pressure (queued + running) that, "
    "sustained, triggers a serving scale-up")
SERVING_DRAIN_TIMEOUT = register(
    "SERVING_DRAIN_TIMEOUT", "30",
    "Seconds a draining cohort may take to finish in-flight "
    "sequences before scale-down proceeds anyway")
SERVING_SLO_P99 = register(
    "SERVING_SLO_P99", "0",
    "Serving p99 end-to-end latency SLO in seconds; a window-smoothed "
    "breach counts as scale-up pressure even with a shallow queue "
    "(0 = latency trigger off, depth-only autoscaling)")
SERVING_MIGRATE_RETRIES = register(
    "SERVING_MIGRATE_RETRIES", "3",
    "Retry attempts per KV-cache migration chunk POST before the "
    "transfer falls back to recompute")
SERVING_MIGRATE_DEADLINE = register(
    "SERVING_MIGRATE_DEADLINE", "5",
    "Seconds each migration chunk may spend retrying before the "
    "transfer falls back to recompute")
SERVING_MIGRATE_MAX_BYTES = register(
    "SERVING_MIGRATE_MAX_BYTES", "4194304",
    "Upper bound on one migrate_in POST body; a sequence's pages are "
    "chunked to stay under it (bounds target staging memory too)")

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
PEERS = "PEERS"                          # "host:port,..." one per rank
RENDEZVOUS_ADDR = "RENDEZVOUS_ADDR"      # the launcher's KV store
RENDEZVOUS_PORT = "RENDEZVOUS_PORT"
WORKER_ID = "WORKER_ID"                  # elastic slot identity
ELASTIC_VERSION = "ELASTIC_VERSION"      # membership version joined
JOB_TOKEN = "JOB_TOKEN"                  # KV-store auth token
RENDEZVOUS_ADDRS = "RENDEZVOUS_ADDRS"    # ordered host:port failover list (HA)

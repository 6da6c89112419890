"""Autotuning parameter manager (trace-driven, warm-started; port of
``horovod_tpu/autotune/core.py``).

The reference tunes fusion-threshold / cycle-time / cache knobs with
Gaussian-process Bayesian optimization (reference:
horovod/common/parameter_manager.cc, optim/bayesian_optimization.cc),
scoring each candidate by observed bytes/sec and broadcasting winners
(reference: controller.cc:39-53 SynchronizeParameters).

The JAX package's design (docs/autotune.md):

**Search structure — per-plane arms.** The perf stack is wider than
the host pair now: overlap bucket bytes (PR 7), compression codec and
threshold (PR 6), ZeRO leg buckets (PR 9). A joint grid over all of
them explodes combinatorially, so the space is factored into *arms* —
one small grid per perf plane, tuned in sequence (coordinate descent):

- ``host`` — fusion threshold x cycle time x delegated-plane min
  bucket (the original joint grid; the knobs interact, so they stay
  joint);
- ``overlap`` — ``HVDTPU_BUCKET_BYTES`` (eager overlap plane, and the
  overlay consumed by optimizer construction);
- ``compression`` — codec x threshold applied as the live plane's
  catch-all policy (only when the user already opted into a pure
  catch-all policy — per-glob rules are never overwritten);
- ``zero`` — ``HVDTPU_ZERO_BUCKET_BYTES`` through the overlay; the
  ZeRO step wrapper re-plans + reshards at the next step boundary
  (single-controller mode only, where that re-plan is deterministic
  by construction).

Within an arm, **successive halving** (itself the classic fixed-budget
bandit): every candidate gets a short scoring window, the top half
survives into a longer round, repeat until one remains; the final
head-to-head runs at the full configured window.

**Score source.** Candidates are judged by what actually bounds the
step: steps/sec derived from the flight-recorder ring's correlated
submit/finish spans (score.TraceScore), falling back to the legacy
cycle-thread bytes/sec when no step structure is visible
(``HVDTPU_AUTOTUNE_SCORE``).

**Warm start.** Converged winners persist per (model-signature,
world-size, codec-availability) key in ``HVDTPU_AUTOTUNE_CACHE``
(store.py). A repeat run applies the stored winner before the first
scored window and skips the sweep; an elastic-version bump instead
triggers deterministic re-validation — one short baseline window, one
short warm window, full re-sweep only on regression.

Determinism (unchanged contract): candidate changes are driven by the
ACTIVE-cycle counter, identical on every rank in SPMD mode, so all
ranks apply the same candidate at the same cycle. Scores are
timing-noisy and rank-local, so every decision that depends on them —
round survivors, the warm-start verdict, the re-validation verdict —
broadcasts rank 0's choice over the data plane (the
SynchronizeParameters analog).

In the port the broadcasts are ``backend.broadcast`` calls made on the
cycle thread, which drive the negotiation rounds themselves (the cycle
thread cannot wait for a cycle it runs). An active cycle is one in which
the native core's byte count moved; on the NCCL-delegated plane a
response adds its bytes when the cycle thread hands it to NCCL
(``delegated_complete`` inside ``run_cycle``), in the same negotiation
round on every rank. A fusion-threshold candidate reaches the native
controller between two cycles (``set_fusion_threshold`` from the cycle
thread).
"""

import math
import time

import numpy as np

from . import overlay, score as score_mod, store
from ..telemetry import core as telemetry
from ..utils import envparse
from ..utils.logging_util import get_logger

# Discrete candidate grids (reference sweeps similar ranges).
FUSION_CANDIDATES_MIB = [0, 1, 2, 4, 8, 16, 32, 64, 128]
CYCLE_CANDIDATES_MS = [0.1, 0.5, 1.0, 2.5, 5.0, 10.0]
BUCKET_CANDIDATES = [256, 4096, 65536]
BUCKET_BYTES_CANDIDATES_MIB = [1, 4, 16, 64]
ZERO_BUCKET_CANDIDATES_MIB = [4, 16, 64]
WARMUP_CYCLES = 10
CYCLES_PER_CANDIDATE = 20   # budget of the FINAL round; early rounds
                            # screen at budget >> 2^(rounds remaining)
CONFIRM_CYCLES = 10         # warm-start re-validation window

#: Re-validation tolerance: the warm config keeps its crown unless it
#: scores more than this fraction BELOW the baseline window (scores
#: are noisy; ties and noise must not trigger a full re-sweep).
REGRESSION_TOLERANCE = 0.1

#: Fixed codec table for the SPMD warm-config broadcast encoding.
CODEC_ORDER = ("none", "fp16", "bf16", "int8", "fp8")

# Warm decisions (index 0 of the broadcast vector).
_SWEEP, _HIT, _REVALIDATE = 0, 1, 2


def _broadcast(runtime, vec):
    """Rank 0's ``vec`` on every rank: one synchronous broadcast through
    the backend on the runtime's device (the cycle thread's call)."""
    import torch

    from ..process_sets import global_process_set
    t = torch.from_numpy(np.ascontiguousarray(vec)).to(runtime.device)
    out = runtime.backend.broadcast([t], 0, global_process_set)[0]
    return out.cpu().numpy()


def _env_list(name, default, conv):
    raw = envparse.get_str(name, "")
    if not raw:
        return default
    return [conv(x.strip()) for x in raw.split(",") if x.strip()]


class Arm:
    """One perf plane's candidate grid + apply function."""

    __slots__ = ("name", "candidates", "_apply_fn", "fmt")

    def __init__(self, name, candidates, apply_fn, fmt=str):
        self.name = name
        self.candidates = list(candidates)
        self._apply_fn = apply_fn
        self.fmt = fmt

    def apply(self, value):
        self._apply_fn(value)


class ParameterManager:
    """Cycle-driven per-arm successive-halving sweep with trace-driven
    scoring and a persistent warm start; see module docstring."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.enabled = True
        self._log = get_logger()
        self._log_path = envparse.get_str(envparse.AUTOTUNE_LOG, "")
        self._warmup = envparse.get_int(envparse.AUTOTUNE_WARMUP_CYCLES,
                                        WARMUP_CYCLES)
        self._final_budget = envparse.get_int(
            envparse.AUTOTUNE_CYCLES_PER_CANDIDATE, CYCLES_PER_CANDIDATE)
        self._confirm_budget = max(2, envparse.get_int(
            envparse.AUTOTUNE_CONFIRM_CYCLES, CONFIRM_CYCLES))
        self._world = int(runtime.topology.size or 1)
        rank = getattr(getattr(runtime, "topology", None), "rank", 0)
        self._rank = int(rank or 0)
        self._source = score_mod.make_source(
            runtime, envparse.get_str(envparse.AUTOTUNE_SCORE, "auto"),
            rank=self._rank)
        self._score_label = self._source.name

        # -- current config + arms ------------------------------------
        self._current = {k: None for k in store.CONFIG_KEYS}
        self._arms = []
        self._build_arms()
        #: Legacy surface: the host arm's joint grid.
        self._grid = self._arms[0].candidates

        # -- sweep state ----------------------------------------------
        self._arm_idx = 0
        self._active = list(range(len(self._grid)))
        # Cost-model warm-start prior (HVDTPU_COSTMODEL): probe the
        # host grid in the model's predicted order. Pure prior —
        # measured scores still decide, and the order is a pure
        # function of (table, world, grid), so every rank derives the
        # same sequence and the broadcast determinism pin holds.
        self._prior_table = None
        order = self._costmodel_priors(self._arms[0])
        if order is not None:
            self._active = order
        self._budget = self._round_budget(len(self._active))
        self._pos = -1               # index into _active; -1 = no cand
        self._cycle = 0
        self._window = 0
        self._cycle_rates = []
        self._round_scores = {}      # cand idx -> [window scores]
        self._history = []           # (arm, round, cand_idx, mean)
        self._round = 0
        self._winners = {}           # arm name -> winning value
        self._winner_idx = {}        # arm name -> winning cand idx
        self._last_score = 0.0
        self._last_bytes = 0
        self._last_time = time.monotonic()
        self._phase = "warmup"
        self.best = None             # host tuple, set at convergence
        self.best_config = None      # full config dict at convergence
        #: Applied-knob sequence [(plane, value-str)] — the cross-rank
        #: determinism pin (tests assert every rank logs the same one).
        self.applied = []

        # -- warm-start store -----------------------------------------
        self._store_path = envparse.get_str(envparse.AUTOTUNE_CACHE, "")
        self._store_entries = None
        self._store_corrupt = False
        self._store_key = None
        self._signature = None
        self._warm_cfg = None
        self._base_score = None

        # -- observability (NULL no-ops when metrics off) --------------
        # The knob gauges track the APPLIED values and are seeded from
        # the coordinator's / backend's / planes' CURRENT config, so a
        # scrape before the first candidate shows reality (the
        # min-bucket gauge included — it previously read 0 until the
        # first bucket candidate applied).
        self._m_fusion = telemetry.gauge(
            "hvd_autotune_fusion_threshold_bytes",
            "Fusion threshold currently applied")
        self._m_cycle = telemetry.gauge(
            "hvd_autotune_cycle_time_ms",
            "Coordinator cycle time currently applied")
        self._m_bucket = telemetry.gauge(
            "hvd_autotune_min_bucket",
            "Delegated-plane min bucket currently applied")
        self._m_bucket_bytes = telemetry.gauge(
            "hvd_autotune_bucket_bytes",
            "Overlap-plane bucket bytes currently applied")
        self._m_zero_bucket = telemetry.gauge(
            "hvd_autotune_zero_bucket_bytes",
            "ZeRO-leg bucket bytes currently applied (overlay)")
        self._m_codec = telemetry.gauge(
            "hvd_autotune_compression_codec",
            "1 on the label of the catch-all codec currently applied",
            labelnames=("codec",))
        self._m_comp_threshold = telemetry.gauge(
            "hvd_autotune_compression_threshold",
            "Compression element threshold currently applied")
        self._m_score = telemetry.gauge(
            "hvd_autotune_score",
            "Score of the last closed autotune window")
        self._m_switches = telemetry.counter(
            "hvd_autotune_candidate_switches_total",
            "Candidate knob applications")
        self._m_rounds = telemetry.counter(
            "hvd_autotune_rounds_total", "Completed halving rounds")
        self._m_converged = telemetry.gauge(
            "hvd_autotune_converged", "1 once the sweep has converged")
        self._m_warm = telemetry.counter(
            "hvd_autotune_warm_start_total",
            "Warm-start cache consultations by outcome",
            labelnames=("outcome",))
        self._codec_label = None
        self._seed_gauges()
        self._m_converged.set(0)

        if self._store_path:
            try:
                self._store_entries = store.load(self._store_path)
            except store.StoreError as exc:
                self._store_corrupt = True
                self._m_warm.labels(outcome="corrupt").inc()
                self._log.warning(
                    "autotune: warm-start cache unusable (%s) — "
                    "running a fresh sweep; convergence rewrites the "
                    "file", exc)

    # -- arm construction --------------------------------------------------
    def _build_arms(self):
        runtime = self.runtime
        coord = runtime.coordinator
        backend = runtime.backend
        cfg = self._current
        if coord is not None:
            cfg["fusion_threshold"] = coord.fusion_threshold
            cfg["cycle_time_ms"] = coord.cycle_time_s * 1000.0

        # host: the original joint fusion x cycle x min-bucket grid.
        fusion = _env_list(envparse.AUTOTUNE_FUSION_CANDIDATES_MIB,
                           FUSION_CANDIDATES_MIB, float)
        cycle = _env_list(envparse.AUTOTUNE_CYCLE_CANDIDATES_MS,
                          CYCLE_CANDIDATES_MS, float)
        # The bucket knob only exists on delegated (XLA data plane)
        # backends; tuning it elsewhere would burn windows on a no-op.
        if hasattr(backend, "set_min_bucket"):
            bucket = _env_list(envparse.AUTOTUNE_BUCKET_CANDIDATES,
                               BUCKET_CANDIDATES, int)
            cfg["min_bucket"] = getattr(backend, "min_bucket", None)
        else:
            bucket = [None]
        grid = [(int(f * 1024 * 1024), c, b)
                for f in fusion for c in cycle for b in bucket]
        self._arms.append(Arm("host", grid, self._apply_host,
                              fmt=lambda v: f"{v[0]}/{v[1]}/{v[2]}"))

        # overlap: eager-plane bucket bytes (+ construction overlay).
        if coord is not None and getattr(coord, "_overlap", False):
            cands = [int(m * 1024 * 1024) for m in _env_list(
                envparse.AUTOTUNE_BUCKET_BYTES_CANDIDATES_MIB,
                BUCKET_BYTES_CANDIDATES_MIB, float)]
            cur = int(getattr(coord, "_bucket_bytes", 0) or 0)
            if cur and cur not in cands:
                cands.append(cur)
            cfg["bucket_bytes"] = cur or None
            if len(cands) > 1:
                self._arms.append(Arm("overlap", cands,
                                      self._apply_bucket_bytes))

        # compression: codec x threshold as the plane's catch-all.
        plane = getattr(coord, "_compression", None)
        cur_codec = self._catchall_codec(plane)
        if cur_codec is not None:
            cfg["compression"] = cur_codec
            cfg["compression_threshold"] = plane.policy.threshold
            codecs = _env_list(envparse.AUTOTUNE_COMPRESSION_CANDIDATES,
                               None, str)
            if codecs is None:
                codecs = self._default_codec_candidates(cur_codec)
            else:
                for name in codecs:
                    self._check_codec(name)
            thresholds = _env_list(
                envparse.AUTOTUNE_COMPRESSION_THRESHOLD_CANDIDATES,
                [plane.policy.threshold], int)
            # 'none' ignores the threshold (rules=[]): crossing it with
            # every threshold would burn a full scoring window per
            # behaviorally-identical duplicate.
            cands = []
            for c in codecs:
                for t in (thresholds if c != "none" else thresholds[:1]):
                    if (c, t) not in cands:
                        cands.append((c, t))
            if len(cands) > 1:
                self._arms.append(Arm(
                    "compression", cands, self._apply_compression,
                    fmt=lambda v: f"{v[0]}@{v[1]}"))

        # zero: leg bucket bytes through the overlay; the step wrapper
        # re-plans at the next boundary. Single-controller only — in
        # SPMD the per-process step loops would observe the overlay at
        # different step indices and compute divergent shard plans.
        from .. import basics
        if (coord is not None and envparse.get_bool(envparse.ZERO)):
            from ..ops.bucketing import DEFAULT_BUCKET_BYTES
            cur = overlay.resolve_int(envparse.ZERO_BUCKET_BYTES,
                                      DEFAULT_BUCKET_BYTES)
            cfg["zero_bucket_bytes"] = cur
            if getattr(runtime, "mode", None) == basics.MODE_SINGLE:
                cands = [int(m * 1024 * 1024) for m in _env_list(
                    envparse.AUTOTUNE_ZERO_BUCKET_CANDIDATES_MIB,
                    ZERO_BUCKET_CANDIDATES_MIB, float)]
                if cur not in cands:
                    cands.append(cur)
                if len(cands) > 1:
                    self._arms.append(Arm("zero", cands,
                                          self._apply_zero_bucket))

    @staticmethod
    def _catchall_codec(plane):
        """The plane's pure catch-all codec name ('none' for an empty
        rule list), or None when there is no plane — or when the policy
        carries per-glob rules the tuner must not overwrite."""
        if plane is None or getattr(plane, "_delegated", False):
            return None
        rules = plane.policy.rules
        if not rules:
            return "none"
        if len(rules) == 1 and rules[0][0] == "*":
            return rules[0][1]
        return None

    def _check_codec(self, name):
        from ..compression import codecs
        if name != "none":
            codecs.get_codec(name)  # loud on unknown/unsupported

    def _default_codec_candidates(self, current):
        from ..compression import codecs
        out = []
        for name in (current, "none", "int8", "bf16"):
            if name == "fp8" and not codecs.fp8_supported():
                continue
            if name not in out:
                out.append(name)
        return out

    # -- gauge seeding (a scrape before the first candidate shows the
    # -- coordinator's reality, not zeros) ---------------------------------
    def _seed_gauges(self):
        cfg = self._current
        if cfg["fusion_threshold"] is not None:
            self._m_fusion.set(cfg["fusion_threshold"])
        if cfg["cycle_time_ms"] is not None:
            self._m_cycle.set(cfg["cycle_time_ms"])
        if cfg["min_bucket"] is not None:
            self._m_bucket.set(cfg["min_bucket"])
        if cfg["bucket_bytes"] is not None:
            self._m_bucket_bytes.set(cfg["bucket_bytes"])
        if cfg["zero_bucket_bytes"] is not None:
            self._m_zero_bucket.set(cfg["zero_bucket_bytes"])
        if cfg["compression"] is not None:
            self._set_codec_gauge(cfg["compression"])
        if cfg["compression_threshold"] is not None:
            self._m_comp_threshold.set(cfg["compression_threshold"])

    def _set_codec_gauge(self, name):
        if self._codec_label is not None and self._codec_label != name:
            self._m_codec.labels(codec=self._codec_label).set(0)
        self._m_codec.labels(codec=name).set(1)
        self._codec_label = name

    # -- called once per coordinator cycle --------------------------------
    def record_cycle(self):
        if not self.enabled:
            return
        coord = self.runtime.coordinator
        now = time.monotonic()
        bytes_now = coord.bytes_processed
        if bytes_now == self._last_bytes:
            # Idle cycle: don't advance the sweep (the reference scores
            # traffic, not wall time). Per-cycle executed-byte totals are
            # the negotiated response sizes — identical on every rank and
            # recorded on the cycle thread (delegated completions too:
            # _drain_delegated runs inside the same run_cycle) — so
            # "active cycle" counting keeps the cross-rank determinism.
            self._last_time = now
            return
        self._cycle += 1
        elapsed = now - self._last_time
        rate = (bytes_now - self._last_bytes) / max(elapsed, 1e-9)
        self._last_bytes = bytes_now
        self._last_time = now

        if self._phase == "warmup":
            # Warming up (warmup=0 => the decision runs on the first
            # active cycle; scoring starts the cycle after it).
            if self._cycle >= self._warmup:
                self._end_warmup()
            return
        self._cycle_rates.append(rate)
        self._window += 1
        if self._window < self._budget:
            return
        window = self._source.close_window(self._cycle_rates)
        self._score_label = ("steps" if window["steps"] is not None
                             else "bytes")
        self._m_score.set(window["steps"]
                          if window["steps"] is not None
                          else window["bytes"])
        if self._phase == "confirm_base":
            self._base_score = window
            self._apply_config(self._warm_cfg)
            self._phase = "confirm_warm"
            self._open_window(self._confirm_budget)
        elif self._phase == "confirm_warm":
            self._finish_confirm(window)
        else:
            cand = self._active[self._pos]
            self._round_scores.setdefault(cand, []).append(window)
            if self._pos + 1 < len(self._active):
                self._set_position(self._pos + 1)
            else:
                self._halve()

    # -- warm start --------------------------------------------------------
    def _end_warmup(self):
        decision, cfg, local_reason = self._warm_decision()
        decision, cfg = self._sync_warm(decision, cfg)
        # Outcomes are counted/logged from the FINAL (broadcast)
        # decision, not the rank-local one: a rank whose own cache file
        # missed but which warm-starts on rank 0's broadcast config DID
        # warm-start — counting its local miss would make the one
        # warm-start health signal wrong exactly when the cross-host
        # cache drift it exists to surface occurs.
        if decision == _HIT:
            self._m_warm.labels(outcome="hit").inc()
            self._log.info(
                "autotune: warm start — cache %s key %s applies before "
                "the first scored window", self._store_path,
                self._store_key)
            self._finish_warm(cfg)
            return
        if decision == _REVALIDATE:
            self._m_warm.labels(outcome="revalidate").inc()
            self._log.info(
                "autotune: elastic version moved since key %s was "
                "cached — re-validating the stored winner (%d-cycle "
                "baseline window, then %d-cycle warm window)",
                self._store_key, self._confirm_budget,
                self._confirm_budget)
            self._warm_cfg = cfg
            self._baseline_cfg = dict(self._current)
            self._phase = "confirm_base"
            self._open_window(self._confirm_budget)
            return
        if local_reason == "miss":
            self._m_warm.labels(outcome="miss").inc()
            self._log.info(
                "autotune: no cache entry for key %s — full sweep",
                self._store_key)
        elif local_reason == "stale":
            self._m_warm.labels(outcome="stale").inc()
            self._log.warning(
                "autotune: cache entry %s is stale — full sweep "
                "rewrites it at convergence", self._store_key)
        self._phase = "sweep"
        self._set_position(0)

    def _warm_decision(self):
        """Rank-local cache consultation -> (decision, config|None,
        reason). The caller counts/logs outcomes AFTER the cross-rank
        sync; ``reason`` names why THIS rank voted sweep."""
        if (not self._store_path or self._store_corrupt
                or self._store_entries is None):
            return _SWEEP, None, None
        sig = envparse.get_str(envparse.AUTOTUNE_SIGNATURE, "")
        if not sig:
            sig = store.model_signature(self._ring_names())
        self._signature = sig
        self._store_key = store.make_key(
            sig, self._world, store.codec_signature(self.runtime))
        entry = self._store_entries.get(self._store_key)
        if entry is None:
            return _SWEEP, None, "miss"
        reason = store.validate_entry(entry)
        if reason is not None:
            return _SWEEP, None, "stale"
        cfg = {k: entry["config"].get(k) for k in store.CONFIG_KEYS}
        cur = envparse.get_str(envparse.ELASTIC_VERSION, "0")
        if str(entry.get("elastic_version")) != cur:
            return _REVALIDATE, cfg, None
        return _HIT, cfg, None

    def _ring_names(self):
        tracer = getattr(self.runtime, "tracer", None)
        flight = getattr(tracer, "_flight", None)
        if flight is None:
            return ()
        return [ev.get("n") for ev in flight.snapshot()
                if ev.get("e") == "sub"]

    def _sync_warm(self, decision, cfg):
        """SPMD: rank 0's warm decision + config wins — cache files can
        diverge across hosts, and a divergent decision here would put
        ranks into different phases (different collective schedules).
        Encoded as a fixed-length float64 vector so no shape
        negotiation is needed; no-op without a store or off SPMD."""
        if not self._store_path:
            return decision, cfg
        rt = self.runtime
        from .. import basics
        if rt.mode != basics.MODE_SPMD or rt.topology.size <= 1:
            return decision, cfg
        vec = np.full(8, -1.0, np.float64)
        vec[0] = decision
        if cfg is not None:
            for slot, key in ((1, "fusion_threshold"),
                              (2, "cycle_time_ms"), (3, "min_bucket"),
                              (4, "bucket_bytes"),
                              (6, "compression_threshold"),
                              (7, "zero_bucket_bytes")):
                if cfg.get(key) is not None:
                    vec[slot] = float(cfg[key])
            if cfg.get("compression") in CODEC_ORDER:
                vec[5] = CODEC_ORDER.index(cfg["compression"])
        out = _broadcast(rt, vec)
        decision = int(out[0])
        if decision == _SWEEP:
            return _SWEEP, None

        def num(slot, conv):
            return None if out[slot] < 0 else conv(out[slot])

        cfg = {
            "fusion_threshold": num(1, int),
            "cycle_time_ms": num(2, float),
            "min_bucket": num(3, int),
            "bucket_bytes": num(4, int),
            "compression": (CODEC_ORDER[int(out[5])]
                            if out[5] >= 0 else None),
            "compression_threshold": num(6, int),
            "zero_bucket_bytes": num(7, int),
        }
        return decision, cfg

    def _sync_verdict(self, flag):
        """Broadcast rank 0's boolean re-validation verdict (same
        rationale as _sync_warm: rank-local scores are noisy and a
        divergent verdict forks the collective schedule)."""
        rt = self.runtime
        from .. import basics
        if rt.mode != basics.MODE_SPMD or rt.topology.size <= 1:
            return flag
        vec = np.asarray([1.0 if flag else 0.0], np.float64)
        return bool(_broadcast(rt, vec)[0] > 0.5)

    def _finish_confirm(self, warm_window):
        # Same unit on both sides (see _halve): steps only when both
        # confirm windows saw step structure, else the always-present
        # bytes rate — a fallback window must not beat a steps baseline
        # on magnitude alone.
        base = self._base_score
        use_steps = (base["steps"] is not None
                     and warm_window["steps"] is not None)
        unit = "steps" if use_steps else "bytes"
        self._score_label = unit
        base_score, warm_score = base[unit], warm_window[unit]
        ok = warm_score >= base_score * (1.0 - REGRESSION_TOLERANCE)
        ok = self._sync_verdict(ok)
        if ok:
            self._m_warm.labels(outcome="revalidated").inc()
            self._last_score = warm_score
            self._log.info(
                "autotune: stored winner re-validated under the new "
                "cohort (warm %.1f vs baseline %.1f %s)", warm_score,
                base_score, unit)
            self._finish_warm(self._warm_cfg, update_store=True)
            return
        self._m_warm.labels(outcome="regressed").inc()
        self._log.warning(
            "autotune: stored winner REGRESSED under the new cohort "
            "(warm %.1f vs baseline %.1f %s) — full re-sweep",
            warm_score, base_score, unit)
        self._apply_config(self._baseline_cfg)
        self._phase = "sweep"
        self._budget = self._round_budget(len(self._active))
        self._set_position(0)

    def _finish_warm(self, cfg, update_store=False):
        self._apply_config(cfg)
        self.best = (self._current["fusion_threshold"],
                     self._current["cycle_time_ms"],
                     self._current["min_bucket"])
        self.best_config = dict(self._current)
        if update_store:
            self._save_store()
        self._m_converged.set(1)
        # Last: observers poll `enabled`, so best/knobs must be in place
        # before the flag flips (the worker thread races this method).
        self.enabled = False
        self._log.info("autotune: warm-started config active: %s",
                       self.best_config)

    # -- sweep mechanics ---------------------------------------------------
    def _costmodel_priors(self, arm):
        """Candidate probe order from the α–β cost model, or None when
        ``HVDTPU_COSTMODEL`` is off (the knob check is the ONLY thing
        that runs then — disabled mode constructs no model, guard-
        tested) or the model is unusable (grid order is always a safe
        fallback — the prior only reorders, never filters)."""
        if not envparse.get_bool(envparse.COSTMODEL):
            return None
        try:
            from ..analysis import costmodel
            if self._prior_table is None:
                self._prior_table = costmodel.resolve_table()
            order = costmodel.rank_candidates(
                arm.name, arm.candidates, self._world,
                self._prior_table)
        except Exception as exc:  # noqa: BLE001 — prior is optional
            self._log.warning(
                "autotune: cost-model prior unavailable for arm %r "
                "(%s); probing in grid order", arm.name, exc)
            return None
        if order != list(range(len(arm.candidates))):
            self._log.info(
                "autotune: arm %r probe order seeded from cost-model "
                "prior: %s", arm.name,
                [arm.fmt(arm.candidates[i]) for i in order])
        return order

    def _predicted_costs(self):
        """Per-arm predicted cost of the converged winners (the store
        entry's ``predicted`` audit field); None when the model is
        off."""
        if not envparse.get_bool(envparse.COSTMODEL):
            return None
        try:
            from ..analysis import costmodel
            table = self._prior_table or costmodel.resolve_table()
            out = {}
            for arm in self._arms:
                if arm.name in self._winners:
                    out[arm.name] = costmodel.predicted_cost(
                        arm.name, self._winners[arm.name],
                        self._world, table)
            return out or None
        except Exception:  # noqa: BLE001 — audit data only
            return None

    def _round_budget(self, n_active):
        """Scoring window for a round with n_active candidates: the LAST
        round (2 survivors) runs at exactly AUTOTUNE_CYCLES_PER_CANDIDATE;
        earlier rounds screen at that budget halved once per remaining
        halving (floor 2). keep=n//2 needs ceil(log2 n) halvings."""
        if n_active <= 1:
            return self._final_budget
        rounds_left = max(1, math.ceil(math.log2(n_active)))
        return max(2, self._final_budget >> (rounds_left - 1))

    def _open_window(self, budget=None):
        self._window = 0
        self._cycle_rates = []
        if budget is not None:
            self._budget = budget
        self._source.open_window()

    def _set_position(self, pos):
        self._pos = pos
        arm = self._arms[self._arm_idx]
        self._open_window()
        arm.apply(arm.candidates[self._active[pos]])

    def _agree(self, indices, n):
        """Rank 0's candidate-index selection broadcasts over the data
        plane (the SynchronizeParameters analog); every rank reaches this
        at the same active cycle, so the collective lines up. The vector
        is fixed-length (arm-grid-sized mask) so no shape negotiation is
        needed."""
        rt = self.runtime
        from .. import basics
        if rt.mode != basics.MODE_SPMD or rt.topology.size <= 1:
            return indices
        mask = np.zeros(n, np.int32)
        mask[np.asarray(indices, np.int32)] = 1
        got = np.flatnonzero(_broadcast(rt, mask))
        return [int(i) for i in got]

    def _halve(self):
        arm = self._arms[self._arm_idx]
        # One unit for the whole comparison set: steps only when EVERY
        # window of every candidate saw step structure — a bytes/sec
        # fallback (~1e8) compared against a steps/sec (~10) would
        # always survive regardless of actual step pacing.
        use_steps = all(w["steps"] is not None
                        for ws in self._round_scores.values()
                        for w in ws)
        unit = "steps" if use_steps else "bytes"
        self._score_label = unit
        means = {i: sum(w[unit] for w in ws) / len(ws)
                 for i, ws in self._round_scores.items()}
        for i, m in sorted(means.items()):
            self._history.append((arm.name, self._round, i, m))
        keep = max(1, len(self._active) // 2)
        # Ordered by score desc, ties broken by grid order (deterministic
        # on rank 0; everyone else takes the broadcast).
        survivors = sorted(sorted(means), key=lambda i: -means[i])[:keep]
        survivors = self._agree(sorted(survivors), len(arm.candidates))
        if len(survivors) == 1:
            self._winner_idx[arm.name] = survivors[0]
            self._arm_converged(survivors[0],
                                means.get(survivors[0], 0.0))
            return
        self._active = survivors
        self._round += 1
        self._m_rounds.inc()
        self._budget = self._round_budget(len(survivors))
        self._round_scores = {}
        self._set_position(0)

    def _arm_converged(self, winner_idx, winner_score):
        arm = self._arms[self._arm_idx]
        value = arm.candidates[winner_idx]
        self._winners[arm.name] = value
        self._last_score = winner_score
        arm.apply(value)
        if arm.name == "host":
            self.best = value
        self._log.info(
            "autotune: arm %r converged after %d halving round(s): %s",
            arm.name, self._round + 1, arm.fmt(value))
        self._arm_idx += 1
        if self._arm_idx < len(self._arms):
            nxt = self._arms[self._arm_idx]
            self._active = list(range(len(nxt.candidates)))
            order = self._costmodel_priors(nxt)
            if order is not None:
                self._active = order
            self._round = 0
            self._round_scores = {}
            self._budget = self._round_budget(len(self._active))
            self._set_position(0)
            return
        self._converge_all()

    def _converge_all(self):
        self.best_config = dict(self._current)
        if self.best is None:
            self.best = (self._current["fusion_threshold"],
                         self._current["cycle_time_ms"],
                         self._current["min_bucket"])
        self._save_store()
        self._m_converged.set(1)
        # Last: observers poll `enabled`, so best/knobs must be in place
        # before the flag flips (the worker thread races this method).
        self.enabled = False
        self._log.info(
            "autotune converged (%d arm(s), score source %s): %s",
            len(self._arms), self._score_label, self.best_config)
        self._write_log()

    def _store_history(self):
        by_name = {a.name: a for a in self._arms}
        return [(arm, rnd, by_name[arm].fmt(by_name[arm].candidates[i]),
                 mean) for arm, rnd, i, mean in self._history]

    def _save_store(self):
        """Persist the converged winner (rank 0 only — one writer per
        shared filesystem; peers warm-start from the broadcast-applied
        config next run)."""
        if not self._store_path or self._rank != 0:
            return
        if self._signature is None:
            sig = envparse.get_str(envparse.AUTOTUNE_SIGNATURE, "")
            self._signature = sig or store.model_signature(
                self._ring_names())
            self._store_key = store.make_key(
                self._signature, self._world,
                store.codec_signature(self.runtime))
        history = self._store_history()
        if not history and self._store_entries:
            # A successful re-validation ran no sweep this session;
            # keep the original converged sweep's history instead of
            # overwriting it with [] (hvd-autotune history would
            # otherwise report zero windows for a swept winner).
            prev = self._store_entries.get(self._store_key)
            if isinstance(prev, dict):
                history = prev.get("history") or []
        entry = store.make_entry(
            self.best_config if self.best_config is not None
            else self._current,
            self._last_score, self._score_label, self._signature,
            self._world, store.codec_signature(self.runtime),
            envparse.get_str(envparse.ELASTIC_VERSION, "0"),
            history, predicted=self._predicted_costs())
        try:
            store.save_entry(self._store_path, self._store_key, entry)
            self._log.info("autotune: winner cached under key %s in %s",
                           self._store_key, self._store_path)
        except OSError as exc:
            self._log.warning(
                "autotune: could not persist winner to %s: %s",
                self._store_path, exc)

    def _write_log(self):
        if not self._log_path:
            return
        by_name = {a.name: a for a in self._arms}
        with open(self._log_path, "a") as f:
            for arm_name, rnd, idx, mean in self._history:
                arm = by_name[arm_name]
                cand = arm.candidates[idx]
                marker = ("*" if self._winner_idx.get(arm_name) == idx
                          else "")
                if arm_name == "host":
                    f.write(f"r{rnd},{cand[0]},{cand[1]},{cand[2]},"
                            f"{mean:.1f}{marker}\n")
                else:
                    f.write(f"r{rnd},{arm_name}={arm.fmt(cand)},"
                            f"{mean:.1f}{marker}\n")

    # -- knob application --------------------------------------------------
    def _apply_host(self, cand):
        fusion, cycle_ms, bucket = cand
        coord = self.runtime.coordinator
        coord.fusion_threshold = max(int(fusion), 1)
        coord.cycle_time_s = cycle_ms / 1000.0
        self._current["fusion_threshold"] = coord.fusion_threshold
        self._current["cycle_time_ms"] = float(cycle_ms)
        self._m_switches.inc()
        self._m_fusion.set(coord.fusion_threshold)
        self._m_cycle.set(cycle_ms)
        self.applied.append(("host", f"{coord.fusion_threshold}"
                                     f"/{cycle_ms}/{bucket}"))
        backend = self.runtime.backend
        if hasattr(backend, "core"):
            # Push the threshold into the native controller (reference:
            # the parameter manager's winners land in the controller's
            # fusion logic). Deterministic across ranks: candidate changes
            # are cycle-count driven.
            backend.core.set_fusion_threshold(max(int(fusion), 1))
        if bucket is not None and hasattr(backend, "set_min_bucket"):
            backend.set_min_bucket(bucket)
            self._current["min_bucket"] = int(bucket)
            self._m_bucket.set(bucket)

    def _apply_bucket_bytes(self, v):
        v = int(v)
        coord = self.runtime.coordinator
        coord._bucket_bytes = v
        # Construction-time readers pick the tuned value up through the
        # overlay on their next build (the JAX package's BUCKET_BYTES
        # knob; the port has no overlap plane, so this arm never builds).
        overlay.set_int("BUCKET_BYTES", v)
        self._current["bucket_bytes"] = v
        self._m_switches.inc()
        self._m_bucket_bytes.set(v)
        self.applied.append(("overlap", str(v)))

    def _apply_compression(self, cand):
        codec, threshold = cand
        plane = self.runtime.coordinator._compression
        from ..compression.policy import CompressionPolicy, parse_rules
        rules = [] if codec == "none" else parse_rules(codec)
        plane.policy = CompressionPolicy(rules, threshold=int(threshold))
        self._current["compression"] = codec
        self._current["compression_threshold"] = int(threshold)
        self._m_switches.inc()
        self._set_codec_gauge(codec)
        self._m_comp_threshold.set(int(threshold))
        self.applied.append(("compression", f"{codec}@{threshold}"))

    def _apply_zero_bucket(self, v):
        v = int(v)
        overlay.set_int(envparse.ZERO_BUCKET_BYTES, v)
        self._current["zero_bucket_bytes"] = v
        self._m_switches.inc()
        self._m_zero_bucket.set(v)
        self.applied.append(("zero", str(v)))

    def _apply_config(self, cfg):
        """Apply a stored warm-start config across every plane it
        names (unnamed planes keep their current values)."""
        if cfg.get("fusion_threshold") is not None:
            self._apply_host((cfg["fusion_threshold"],
                              float(cfg["cycle_time_ms"]),
                              cfg.get("min_bucket")))
        coord = self.runtime.coordinator
        if (cfg.get("bucket_bytes") is not None
                and hasattr(coord, "_bucket_bytes")):
            self._apply_bucket_bytes(cfg["bucket_bytes"])
        if cfg.get("compression") is not None:
            plane = getattr(coord, "_compression", None)
            if self._catchall_codec(plane) is not None:
                threshold = cfg.get("compression_threshold")
                if threshold is None:   # 0 = compress everything, keep it
                    threshold = plane.policy.threshold
                self._apply_compression((cfg["compression"], threshold))
            else:
                self._log.warning(
                    "autotune: cached compression codec %r not applied "
                    "— the live policy is absent or carries per-glob "
                    "rules the tuner must not overwrite",
                    cfg["compression"])
        # Same mode gate as the zero arm in _build_arms: in SPMD the
        # per-process step loops would observe the overlay bump at
        # different step indices and re-plan onto divergent shard
        # geometries — a cached value must not re-introduce that.
        from .. import basics
        if (cfg.get("zero_bucket_bytes") is not None
                and envparse.get_bool(envparse.ZERO)
                and getattr(self.runtime, "mode", None)
                == basics.MODE_SINGLE):
            self._apply_zero_bucket(cfg["zero_bucket_bytes"])

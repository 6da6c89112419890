"""Structured diagnostics shared by every hvd-lint layer (port of
``horovod_tpu/analysis/diagnostics.py``: the same rule ids, severities
and titles, so a finding reads the same from either package).

A finding is a :class:`Diagnostic`: rule id + severity + message +
``file:line`` + a fix hint. The rule catalog lives here so the jaxpr
analyzer, the AST linter, the runtime guard, and the CLI agree on ids
and severities (full prose catalog: docs/lint.md).
"""

import dataclasses
import os

ERROR = "error"
WARNING = "warning"

#: rule id -> (severity, one-line title)
RULES = {
    "HVD001": (ERROR, "file does not parse"),
    # -- jaxpr layer -------------------------------------------------------
    "HVD101": (ERROR, "collective axis name is not bound by any enclosing "
                      "mesh/shard_map"),
    "HVD102": (ERROR, "collective under rank-dependent control flow "
                      "(SPMD deadlock shape)"),
    "HVD103": (ERROR, "paired collectives disagree on dtype/shape across "
                      "branches"),
    # -- AST layer ---------------------------------------------------------
    "HVD201": (ERROR, "collective call guarded by a rank condition"),
    "HVD202": (WARNING, "initial broadcast_parameters/"
                        "broadcast_optimizer_state missing after init()"),
    "HVD203": (WARNING, "auto-named collective inside rank-dependent "
                        "control flow"),
    "HVD204": (ERROR, "checkpoint save/restore call guarded by a rank "
                      "condition (they barrier/broadcast internally)"),
    "HVD205": (WARNING, "lossy compressor applied to an integer/bool "
                        "tensor or a broadcast/initial-sync collective "
                        "(compression is for gradient reduction only)"),
    "HVD206": (WARNING, "per-tensor eager allreduce inside a loop "
                        "(serializes per-collective latency; use "
                        "grouped_allreduce or DistributedOptimizer's "
                        "bucketed dispatch)"),
    "HVD207": (WARNING, "raw time.time()/perf_counter() begin/end pair "
                        "feeding a metric observe() — use the "
                        "telemetry.spans.span API (one instrument for "
                        "histogram + timeline + trace plane)"),
    "HVD208": (ERROR, "ZeRO sharded update (zero=/HVDTPU_ZERO) combined "
                      "with Adasum or a non-global process set "
                      "(per-tensor Adasum semantics don't "
                      "reduce-scatter; a sub-cohort derives a wrong "
                      "shard plan — DistributedOptimizer rejects both "
                      "at __init__)"),
    "HVD209": (WARNING, "lossy compressor applied to an index tensor "
                        "or to the indices half of a sparse gradient "
                        "(indices must be exact — a rounded row id "
                        "scatter-adds into the wrong row with no "
                        "arithmetic error to catch it)"),
    "HVD210": (WARNING, "unbounded request buffering (bare "
                        "queue.Queue()/deque()/list-append) in serving "
                        "scheduler/router/handler code — backpressure "
                        "requires bounded queues that reject when full"),
    "HVD211": (WARNING, "hand-rolled resharding: device_get of a "
                        "sharded tree flowing (through reshape/concat "
                        "hops) into device_put outside "
                        "horovod_tpu/resharding/ — materializes the "
                        "full replica on host and skips the planner's "
                        "memory bound, digest verification, and "
                        "hvd-sim proofs"),
    "HVD212": (WARNING, "direct worker spawn/terminate "
                        "(SlotProcess(...) / terminate/kill on a "
                        "worker process handle) outside the driver/"
                        "actuator modules — hand-rolled cohort "
                        "mutation bypasses the journal, the fleet "
                        "lease ledger, and blacklist accounting"),
    "HVD213": (WARNING, "silent degradation: an except clause in "
                        "serving/fleet code swallows a transport error "
                        "(OSError, ConnectionError, URLError, "
                        "HTTPException, TimeoutError, ...) without a "
                        "log, metric, or re-raise — the failure "
                        "disappears and the fallback ladder "
                        "(docs/serving.md) loses its audit trail"),
    # -- interprocedural schedule verifier (hvd-lint verify) ---------------
    "HVD401": (ERROR, "collective reachable under rank-tainted control "
                      "flow through any call depth (the whole-program "
                      "generalization of HVD102/HVD201)"),
    "HVD402": (ERROR, "loop containing a collective whose trip count is "
                      "rank-tainted or data-dependent (schedule-length "
                      "divergence: ranks submit different collective "
                      "counts and the job stalls)"),
    "HVD403": (ERROR, "early return/raise/continue under a rank-tainted "
                      "condition skips a collective other ranks "
                      "execute"),
    "HVD404": (ERROR, "collectives on distinct process sets interleaved "
                      "where relative order can differ per rank "
                      "(deadlock by cross-set wait cycle)"),
    "HVD405": (ERROR, "per-tensor-semantics reduction (Adasum) routed "
                      "through a bucketing/concatenating path (its "
                      "scale-invariant combination is defined per whole "
                      "tensor; bucketing silently changes the math)"),
    # -- symbolic schedule simulator (analysis/simulate.py) ----------------
    "HVD501": (ERROR, "proven deadlock: symbolic N-rank simulation of the "
                      "extracted schedules finds irreconcilable per-rank "
                      "collective sequences (counterexample trace "
                      "attached — one event list per symbolic rank up to "
                      "the hang point)"),
    "HVD502": (ERROR, "proven digest mismatch: a matched collective slot "
                      "diverges in statically-computable fields "
                      "(kind/op) across symbolic ranks — the guardian "
                      "abort foretold at lint time"),
    "HVD503": (WARNING, "possible hang: bounded schedule simulation "
                        "(scenario caps, loop widening, inline depth) "
                        "could neither prove nor refute divergence "
                        "under rank-tainted control flow"),
    # -- cost-model layer: static performance (hvd-lint perf) --------------
    "HVD601": (WARNING, "bucket size pessimal at target scale: a "
                        "literal bucket-bytes knob sits >=2x away "
                        "from the cost model's predicted optimum at "
                        "the largest probed cohort"),
    "HVD602": (WARNING, "serialization point on the predicted "
                        "critical path: a per-step barrier or "
                        "synchronous per-tensor submits with zero "
                        "overlap opportunity"),
    "HVD603": (WARNING, "predicted scale cliff: the modeled comm "
                        "fraction crosses 50% between two probed "
                        "cohort sizes (the step goes "
                        "communication-bound)"),
    # -- AST layer: concurrency & liveness (hvd-sanitize) ------------------
    "HVD301": (WARNING, "mutable attribute shared between a thread "
                        "target and other methods written without a "
                        "lock"),
    "HVD302": (ERROR, "lock acquired outside `with` / try-finally "
                      "(an exception leaks the lock and wedges every "
                      "later acquirer)"),
    "HVD303": (WARNING, "unbounded blocking call inside a "
                        "cycle/watchdog/heartbeat loop body"),
    "HVD304": (WARNING, "HVDTPU_*/HOROVOD_* env read bypassing "
                        "utils/envparse.py (prefix fallback + knob "
                        "registry)"),
    "HVD305": (WARNING, "thread started with neither daemon=True nor "
                        "a join path"),
    "HVD306": (ERROR, "knob registry and docs/knobs.md disagree"),
    "HVD307": (ERROR, "metric registry and docs/metrics.md disagree"),
    # HVD7xx — protocol model checking (hvd-model, docs/modelcheck.md).
    "HVD701": (ERROR, "protocol safety invariant violated (minimized "
                      "counterexample attached)"),
    "HVD702": (ERROR, "protocol liveness goal unreachable under fair "
                      "scheduling (the protocol wedges once faults "
                      "stop)"),
    "HVD703": (WARNING, "model exploration exhausted its "
                        "depth/state/wall-clock budget before "
                        "covering the bounded space"),
    "HVD704": (WARNING, "actuation issued before the durable "
                        "ledger/journal write in a protocol module "
                        "(a crash in the window strands the effect)"),
    "HVD705": (WARNING, "KV/store write without a term= fence inside "
                        "a protocol module (stale-primary mutations "
                        "slip the split-brain fence)"),
}

_SEV_ORDER = {ERROR: 0, WARNING: 1}


@dataclasses.dataclass
class Diagnostic:
    """One finding, renderable as text or JSON.

    ``trace`` is the structured per-symbolic-rank counterexample the
    schedule simulator (analysis/simulate.py) attaches to proven
    HVD501/502 findings — rendered as SARIF ``codeFlows`` and by the
    CLI text formatter; ``None`` for every other rule."""

    rule: str
    severity: str
    message: str
    file: str = "<unknown>"
    line: int = 0
    hint: str = ""
    trace: dict = None

    @classmethod
    def make(cls, rule, message, file="<unknown>", line=0, hint="",
             trace=None):
        severity = RULES.get(rule, (ERROR, ""))[0]
        return cls(rule=rule, severity=severity, message=message,
                   file=file, line=int(line or 0), hint=hint,
                   trace=trace)

    @property
    def location(self):
        return f"{self.file}:{self.line}"

    def format(self):
        out = f"{self.location}: {self.severity} {self.rule}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self):
        out = dataclasses.asdict(self)
        if out.get("trace") is None:
            del out["trace"]
        return out

    def sort_key(self):
        return (self.file, self.line, _SEV_ORDER.get(self.severity, 9),
                self.rule)


def relative_to_cwd(path, posix=False):
    """``path`` relative to cwd when it sits under it (stable across
    checkouts — what baseline keys, SARIF uris, and rendered locations
    all want to agree on), unchanged otherwise. ``posix=True`` forces
    forward slashes for serialized forms."""
    try:
        rel = os.path.relpath(path)
    except ValueError:
        rel = path
    if not rel.startswith(".."):
        path = rel
    return path.replace(os.sep, "/") if posix else path


def dedupe(diags):
    """Drop exact repeats (a fixpoint re-walk of a ``while`` body reports
    the same eqn more than once), preserving first-seen order."""
    seen, out = set(), []
    for d in diags:
        key = (d.rule, d.file, d.line, d.message)
        if key not in seen:
            seen.add(key)
            out.append(d)
    return out


def worst_severity(diags):
    if any(d.severity == ERROR for d in diags):
        return ERROR
    if diags:
        return WARNING
    return None

"""Layer 2: AST linter for user training scripts (port of
``horovod_tpu/analysis/ast_lint.py``).

The package roots it recognises are ``horovod_tpu_torch`` as well as the
JAX package's ``horovod_tpu`` and ``horovod`` (:data:`PKG_ROOTS`), so a
script written against either package lints the same.

Python-level divergence the jaxpr layer cannot see: the reference
framework's best-known user bug is the *rank-guarded collective* —

    if hvd.rank() == 0:
        hvd.allreduce(tensor)        # other ranks never arrive: hang

which the reference only diagnoses at runtime via the stall inspector
(reference: horovod/common/stall_inspector.cc warning text). Here it is
a static finding. Three rules:

- **HVD201** (error) — a collective call inside an ``if``/``while``
  whose condition depends on ``rank()`` and whose other branch performs
  no collective: only some ranks reach it.
- **HVD202** (warning) — a script that ``init()``s and builds a
  ``DistributedOptimizer`` but never broadcasts initial state (no
  ``broadcast_parameters``/``broadcast_optimizer_state``/Broadcast
  callback, and no elastic state sync): ranks train from divergent
  initializations.
- **HVD203** (warning) — collectives *without an explicit* ``name=``
  under rank-dependent control flow: auto-generated names are assigned
  in call order, so name streams diverge across ranks and the
  negotiation never matches them up.
- **HVD204** (error) — a ``horovod_tpu.checkpoint`` save/restore call
  inside a rank guard: those helpers already write on rank 0 only and
  BARRIER (or broadcast to) every rank internally, so guarding them
  with ``if hvd.rank() == 0:`` means the other ranks never reach the
  barrier — the classic non-root-only checkpointing deadlock.
- **HVD205** (warning) — a lossy compressor (``Compression.fp16/bf16/
  int8/fp8``) on a broadcast/initial-sync collective, or on a visibly
  integer/bool tensor: compression exists for gradient reduction only
  (reference semantics); state sync must be exact and counts/masks
  have no lossy representation.
- **HVD206** (warning) — a per-tensor eager ``allreduce`` whose tensor
  is the iteration variable of an enclosing ``for`` loop (one blocking
  collective per tensor): each call pays full dispatch + negotiation
  latency serially. The bucketed API reduces the whole set in fused
  buckets — ``grouped_allreduce(list)`` for explicit reductions, or
  ``DistributedOptimizer`` (whose dispatch plane buckets and, under
  ``HVDTPU_OVERLAP=1``, overlaps them with backprop) for gradients.
- **HVD207** (warning) — a raw ``t0 = time.time()/perf_counter()``
  begin read whose elapsed (``clock() - t0``) feeds a metric
  ``observe()``: the ``telemetry.spans.span`` context is the single
  instrument that feeds the histogram AND the timeline AND the trace
  plane, and its disabled mode reads no clock at all. ``monotonic`` /
  ``perf_counter_ns`` pairs and elapsed values that go to logs (not
  metrics) are not findings.
- **HVD210** (warning) — an *unbounded* request buffer in serving
  context (a file under ``serving/``, a class named
  scheduler/router/serving, or a ``handle_*`` request handler): a bare
  ``queue.Queue()``/``SimpleQueue()``, a ``deque()`` without
  ``maxlen``, or ``.append()`` onto a request-named list. The serving
  plane's backpressure contract is bounded-queues-or-429
  (docs/serving.md); an unbounded buffer absorbs overload into memory
  and tail latency where nothing can shed it.
- **HVD212** (warning) — direct worker spawn/terminate outside the
  driver/actuator modules: a hand-constructed
  ``spawn.SlotProcess(...)`` or ``terminate``/``kill``/``send_signal``
  on a worker process handle (``.proc``, ``workers[...]``, or a name
  bound to either). Cohort mutation is a desired-state write the
  elastic drivers reconcile (target files, drain flags, the fleet
  lease ledger); a bypass mutates membership with no journal entry,
  no lease, and no blacklist accounting.
- **HVD213** (warning) — silent degradation in serving/fleet context
  (a file under ``serving/`` or ``fleet/``, a class named
  router/scheduler/worker/arbiter/migration, or a ``handle_*``
  handler): an ``except`` clause catching a transport error
  (``OSError`` and kin, ``URLError``, ``HTTPException``,
  ``TimeoutError``, a ``*TRANSPORT*`` tuple) whose body neither
  re-raises nor records it (no ``raise``, no log call, no metric
  ``inc``/``observe``). The degradation contract is *loud* fallback
  (docs/serving.md); a swallowed transport fault becomes unexplained
  tail latency or quietly lost capacity.

The HVD3xx block is the static half of ``hvd-sanitize`` (runtime half:
analysis/sanitizer.py) — thread-safety and liveness hazards in the kind
of background-thread control plane this framework is built from:

- **HVD301** (warning) — a mutable ``self`` attribute written both by a
  ``threading.Thread`` target (or a method it calls) and by other
  methods, with at least one write outside any ``with <lock>`` block:
  a data race unless some ownership protocol exists (suppress with an
  ownership comment where one does).
- **HVD302** (error) — ``.acquire()`` with no ``.release()`` of the
  same lock in an enclosing/adjacent ``try``/``finally`` in the same
  scope: an exception between them leaks the lock and wedges every
  later acquirer. Use ``with``.
- **HVD303** (warning) — an *unbounded* blocking call (``urlopen``,
  ``subprocess.*``, or ``.wait()``/``.join()``/``.get()`` with no
  timeout) lexically inside a cycle/watchdog/heartbeat loop body (a
  thread target whose thread or method name says coordinator/cycle/
  watchdog/heartbeat/stall, plus the methods it calls): these threads
  pace the data plane, so one unbounded call starves every in-flight
  collective.
- **HVD305** (warning) — a thread constructed with neither
  ``daemon=True`` nor any visible ``join()``/``.daemon = True`` path:
  it will keep the interpreter alive after ``shutdown()``.

**HVD304** (warning, module-wide) — ``os.environ`` read of an
``HVDTPU_*``/``HOROVOD_*`` name outside utils/envparse.py: it bypasses
the prefix fallback AND the knob registry, so the knob drifts out of
docs/knobs.md (the registry<->docs cross-check is rule HVD306,
:func:`check_knob_docs`).

Suppression: append ``# hvd-lint: disable=HVD201`` (comma-separate for
several rules, or ``disable=all``) to the flagged line or the line
above it; ``# hvd-lint: disable-file=HVD202`` anywhere disables a rule
for the whole file. Pure stdlib — no jax/torch/tf imports.
"""

import ast
import os
import re

from .diagnostics import Diagnostic, dedupe

# Eager named-tensor API (ops/collectives.py + functions.py) plus the
# in-jit spellings (jax.lax collectives) users call inside step bodies.
COLLECTIVE_CALLS = frozenset({
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_",
    "allgather", "allgather_async", "grouped_allgather",
    "grouped_allgather_async",
    "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
    "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async", "grouped_reducescatter",
    "grouped_reducescatter_async",
    "barrier", "join",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_variables", "broadcast_object", "allgather_object",
})
LAX_COLLECTIVE_CALLS = frozenset({
    "psum", "pmean", "pmax", "pmin", "ppermute", "pshuffle",
    "all_gather", "all_to_all", "psum_scatter",
})
# Exempt from HVD203 (the unnamed-collective warning): ops with no
# user-visible name kwarg, lax collectives (paired by program point,
# not name), and the object/state broadcast helpers, whose names are
# fixed internally (functions.py) — never call-order dependent.
_UNNAMED_OK = (frozenset({
    "barrier", "join",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_variables", "broadcast_object", "allgather_object",
}) | LAX_COLLECTIVE_CALLS)
# Per-tensor eager allreduce spellings (rule HVD206): the grouped_*
# family IS the bucketed API and is exempt by construction.
PER_TENSOR_ALLREDUCE_CALLS = frozenset({
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
})
RANK_CALLS = frozenset({"rank", "local_rank", "cross_rank", "axis_index"})
BROADCAST_STATE_CALLS = frozenset({
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_variables", "broadcast_object",
})
DIST_OPT_CALLS = frozenset({
    "DistributedOptimizer", "DistributedAdasumOptimizer",
})
# Accepted env spellings of the ZeRO knob (rule HVD208): a script that
# exports any of these and builds an Adasum / sub-cohort optimizer
# will crash at DistributedOptimizer.__init__.
_ZERO_ENV_NAMES = frozenset({
    "HVDTPU_ZERO", "HOROVOD_TPU_ZERO", "HOROVOD_ZERO",
})
# horovod_tpu.checkpoint helpers that coordinate internally (rank-0
# write + barrier, or restore + broadcast): calling them under a rank
# guard deadlocks the unguarded ranks (HVD204).
CHECKPOINT_CALLS = frozenset({
    "save", "save_step", "restore", "restore_latest",
})
# Lossy members of the Compression surface (ops/compression.py): wire
# quantizers plus the narrowing casts. Reference semantics: compression
# exists for gradient REDUCTION — state sync (broadcast) must be exact,
# and integer/bool payloads have no meaningful lossy representation
# (rule HVD205).
LOSSY_COMPRESSORS = frozenset({"fp16", "bf16", "int8", "fp8"})
SYNC_COLLECTIVE_CALLS = frozenset({
    "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_variables", "broadcast_object",
})
# Attribute names that mark an integer/bool tensor expression
# (dtype=jnp.int32, x.astype(np.bool_), torch.int64, ...).
_INTY_DTYPE_ATTRS = frozenset({
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "bool_", "bool", "long",
})
# Rule HVD209 (extends HVD205's integer-tensor walk): expressions that
# visibly produce INDEX tensors even without a spelled-out int dtype —
# the indices half of a sparse gradient (`grad.indices`, torch
# `t.indices()`, `t._indices()`) and the index-producing constructions.
# Indices must be exact: a lossy wire format rounds row ids into the
# WRONG rows with no arithmetic error to catch it (docs/sparse.md).
_INDEX_ATTRS = frozenset({"indices", "_indices"})
_INDEX_PRODUCING_CALLS = frozenset({
    "indices", "_indices", "argsort", "argmax", "argmin", "nonzero",
    "flatnonzero", "searchsorted",
})
# Presence of any of these identifiers means initial-state sync happens
# through a channel HVD202 should not second-guess.
_SYNC_MARKERS = frozenset({
    "BroadcastGlobalVariablesCallback", "broadcast_global_variables",
})
_ELASTIC_STATE_NAMES = frozenset({
    "TorchState", "TensorFlowKerasState", "KerasState", "ObjectState",
    "State",
})

_SUPPRESS_RE = re.compile(r"hvd-lint:\s*disable=([A-Za-z0-9,\s]+)")
_SUPPRESS_FILE_RE = re.compile(r"hvd-lint:\s*disable-file=([A-Za-z0-9,\s]+)")
_DOC_HINT = "see docs/lint.md"


def _root_name(node):
    """Leftmost Name of an attribute chain (``hvd.torch.rank`` -> hvd)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _terminal_name(func):
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _scan_statements(stmts):
    """Yield nodes in statement bodies without descending into nested
    function/class definitions (code there is defined, not executed,
    under the guard)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


#: Top-level package names whose imports bind horovod aliases: the port's
#: own, the JAX package's and the upstream name.
PKG_ROOTS = ("horovod_tpu", "horovod", "horovod_tpu_torch")


# Names importable directly from the package that are MODULES, not
# functions: `from horovod_tpu import basics` binds a module alias, so
# `basics.allreduce(...)` must resolve like `hvd.allreduce(...)`, not
# like a bare imported function.
_HVD_SUBMODULES = frozenset({
    "basics", "jax", "torch", "tensorflow", "keras", "elastic",
    "checkpoint", "ops", "functions", "native", "spark", "ray",
    "runner", "compression", "tracing", "telemetry", "chaos",
    "guardian", "analysis", "process_sets", "autotune", "coordinator",
    "backend", "utils", "models", "callbacks", "mpi_ops",
})


class AliasResolver:
    """Import-alias bookkeeping shared by every AST rule layer.

    Every spelling of a collective call — ``hvd.allreduce(...)``,
    ``from horovod_tpu import allreduce``, ``basics.allreduce(...)``,
    ``from horovod_tpu.basics import allreduce as ar`` — resolves here,
    in exactly one place, for the HVD2xx single-hop rules and the
    interprocedural schedule extractor (analysis/schedule.py) alike.
    Feed it every Import/ImportFrom node, then classify calls with
    :meth:`is_collective` / :meth:`is_rank_call` /
    :meth:`is_checkpoint_call` / :meth:`collective_kind`.
    """

    def __init__(self):
        self.hvd_aliases = set()    # names bound to horovod_tpu modules
        self.hvd_names = set()      # functions imported from horovod_tpu
        self.ckpt_aliases = set()   # names bound to horovod_tpu.checkpoint
        self.ckpt_names = set()     # functions imported from .checkpoint
        self.lax_aliases = {"lax"}  # `jax.lax` / `from jax import lax`
        self.uses_elastic = False

    # -- imports -----------------------------------------------------------
    def visit_import(self, node):
        for alias in node.names:
            target = alias.asname or alias.name.split(".")[0]
            if alias.name.split(".")[0] in PKG_ROOTS:
                self.hvd_aliases.add(target)
                if "elastic" in alias.name:
                    self.uses_elastic = True
                if (alias.name.endswith(".checkpoint")
                        and alias.asname is not None):
                    # `import horovod_tpu.checkpoint as ckpt`
                    self.ckpt_aliases.add(alias.asname)
            if alias.name in ("jax.lax",):
                self.lax_aliases.add(target)

    def visit_import_from(self, node):
        mod = node.module or ""
        if mod.split(".")[0] in PKG_ROOTS:
            if "elastic" in mod:
                self.uses_elastic = True
            if mod.endswith(".checkpoint"):
                # `from horovod_tpu.checkpoint import save_step [as s]`
                for alias in node.names:
                    self.ckpt_names.add(alias.asname or alias.name)
            for alias in node.names:
                name = alias.asname or alias.name
                if alias.name == "checkpoint":
                    # `from horovod_tpu import checkpoint [as ckpt]`
                    self.ckpt_aliases.add(name)
                if alias.name == "elastic" or name == "elastic":
                    self.uses_elastic = True
                    self.hvd_aliases.add(name)
                elif alias.name in _ELASTIC_STATE_NAMES:
                    self.uses_elastic = True
                elif alias.name == "*":
                    self.hvd_names |= (COLLECTIVE_CALLS | RANK_CALLS
                                       | DIST_OPT_CALLS | {"init"})
                elif alias.name in _HVD_SUBMODULES:
                    # `from horovod_tpu import basics` — a MODULE alias:
                    # `basics.allreduce(...)` resolves through it.
                    self.hvd_aliases.add(name)
                else:
                    self.hvd_names.add(name)
        if mod == "jax":
            for alias in node.names:
                if alias.name == "lax":
                    self.lax_aliases.add(alias.asname or "lax")

    # -- call classification ----------------------------------------------
    def is_hvd_call(self, call, names):
        term = _terminal_name(call.func)
        if term not in names:
            return False
        if isinstance(call.func, ast.Name):
            # A bare name is horovod's only if it was imported from
            # horovod (a file with no horovod imports has no horovod
            # collectives — bare `broadcast(...)` there is someone
            # else's function).
            return term in self.hvd_names
        root = _root_name(call.func)
        return root in self.hvd_aliases

    def is_collective(self, call):
        term = _terminal_name(call.func)
        if term in LAX_COLLECTIVE_CALLS:
            root = _root_name(call.func)
            return root in self.lax_aliases or root == "jax"
        return self.is_hvd_call(call, COLLECTIVE_CALLS)

    def is_rank_call(self, call):
        term = _terminal_name(call.func)
        if term == "axis_index":
            root = _root_name(call.func)
            return root in self.lax_aliases or root == "jax"
        return self.is_hvd_call(call, RANK_CALLS)

    def is_checkpoint_call(self, call):
        term = _terminal_name(call.func)
        if term not in CHECKPOINT_CALLS:
            return False
        if isinstance(call.func, ast.Name):
            return term in self.ckpt_names
        root = _root_name(call.func)
        if root in self.ckpt_aliases:
            return True
        # `hvd.checkpoint.save(...)` — a horovod alias with an explicit
        # `.checkpoint.` hop in the attribute chain.
        if root in self.hvd_aliases:
            chain = []
            node = call.func
            while isinstance(node, ast.Attribute):
                chain.append(node.attr)
                node = node.value
            return "checkpoint" in chain[1:]
        return False

    def collective_kind(self, call):
        """Terminal collective name (``allreduce``, ``psum``, ...) when
        ``call`` is a collective, else None."""
        return _terminal_name(call.func) if self.is_collective(call) \
            else None


class _Analyzer(ast.NodeVisitor):
    def __init__(self, filename):
        self.filename = filename
        self.diags = []
        self.res = AliasResolver()  # shared import-alias bookkeeping
        self.has_init = False
        self.dist_opt_node = None
        self.has_broadcast = False
        self.int_names = set()      # names assigned integer-looking values
        self.index_names = set()    # names assigned index-producing exprs
        self.zero_env_set = False   # script set HVDTPU_ZERO-family env
        self._flagged = set()       # id(call) already reported

    # -- imports -----------------------------------------------------------
    def visit_Import(self, node):
        self.res.visit_import(node)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        self.res.visit_import_from(node)
        self.generic_visit(node)

    # -- call classification (delegated to the shared resolver) ------------
    def _is_hvd_call(self, call, names):
        return self.res.is_hvd_call(call, names)

    def _is_collective(self, call):
        return self.res.is_collective(call)

    def _is_rank_call(self, call):
        return self.res.is_rank_call(call)

    def _is_checkpoint_call(self, call):
        return self.res.is_checkpoint_call(call)

    def _is_rank_dependent(self, expr):
        return any(isinstance(n, ast.Call) and self._is_rank_call(n)
                   for n in ast.walk(expr))

    def _collectives_in(self, stmts):
        out = []
        for node in _scan_statements(stmts):
            if (isinstance(node, ast.Call) and self._is_collective(node)
                    and id(node) not in self._flagged):
                has_name = any(kw.arg == "name" for kw in node.keywords)
                out.append((node, has_name))
        out.sort(key=lambda item: (item[0].lineno, item[0].col_offset))
        return out

    def _checkpoint_calls_in(self, stmts):
        out = [node for node in _scan_statements(stmts)
               if (isinstance(node, ast.Call)
                   and self._is_checkpoint_call(node)
                   and id(node) not in self._flagged)]
        out.sort(key=lambda n: (n.lineno, n.col_offset))
        return out

    # -- rules -------------------------------------------------------------
    def _report_201(self, call, kind):
        self._flagged.add(id(call))
        fn = _terminal_name(call.func)
        self.diags.append(Diagnostic.make(
            "HVD201",
            f"collective `{fn}` runs only on ranks satisfying the "
            f"{kind} condition: the other ranks never enter it and the "
            "job deadlocks (every rank must call every collective)",
            file=self.filename, line=call.lineno,
            hint="move the collective outside the rank guard — guard "
                 "only the rank-local work (logging, checkpointing); "
                 + _DOC_HINT))

    def _report_203(self, call):
        self._flagged.add(id(call))
        fn = _terminal_name(call.func)
        self.diags.append(Diagnostic.make(
            "HVD203",
            f"collective `{fn}` inside rank-dependent control flow has "
            "no explicit name=: auto-generated names follow call order, "
            "which differs across ranks here, so the negotiation never "
            "matches them (DuplicateNameError / stall)",
            file=self.filename, line=call.lineno,
            hint="pass a stable name= shared by every rank; "
                 + _DOC_HINT))

    def _report_204(self, call, kind):
        self._flagged.add(id(call))
        fn = _terminal_name(call.func)
        self.diags.append(Diagnostic.make(
            "HVD204",
            f"checkpoint `{fn}` inside a rank-guarded `{kind}`: the "
            "checkpoint helpers already write on rank 0 only and "
            "barrier (or broadcast to) EVERY rank internally, so the "
            "unguarded ranks never reach the barrier and the job "
            "deadlocks (the non-root-only checkpointing hazard)",
            file=self.filename, line=call.lineno,
            hint="call it unguarded on every rank — rank selection is "
                 "handled inside horovod_tpu.checkpoint; " + _DOC_HINT))

    def visit_If(self, node):
        if self._is_rank_dependent(node.test):
            body_c = self._collectives_in(node.body)
            else_c = self._collectives_in(node.orelse)
            if body_c and else_c:
                for call, has_name in body_c + else_c:
                    if not has_name and (_terminal_name(call.func)
                                         not in _UNNAMED_OK):
                        self._report_203(call)
            elif body_c or else_c:
                for call, _ in (body_c or else_c):
                    self._report_201(call, "if")
            body_k = self._checkpoint_calls_in(node.body)
            else_k = self._checkpoint_calls_in(node.orelse)
            if bool(body_k) != bool(else_k):
                # Symmetric branches (both checkpoint) still reach the
                # internal barrier on every rank; only the one-sided
                # guard strands the other ranks.
                for call in (body_k or else_k):
                    self._report_204(call, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        if self._is_rank_dependent(node.test):
            for call, _ in self._collectives_in(node.body):
                self._report_201(call, "while")
            for call in self._checkpoint_calls_in(node.body):
                self._report_204(call, "while")
        self.generic_visit(node)

    # -- HVD206: per-tensor allreduce in a loop ----------------------------
    def _report_206(self, call):
        self._flagged.add(id(call))
        fn = _terminal_name(call.func)
        self.diags.append(Diagnostic.make(
            "HVD206",
            f"per-tensor `{fn}` over the loop variable: one blocking "
            "collective per tensor pays dispatch + negotiation latency "
            "serially, which the bucketed API amortizes into fused "
            "buckets",
            file=self.filename, line=call.lineno,
            hint="collect the tensors and make one grouped_allreduce() "
                 "call, or reduce gradients through "
                 "DistributedOptimizer (bucketed dispatch; "
                 "HVDTPU_OVERLAP=1 overlaps buckets with backprop); "
                 + _DOC_HINT))

    @staticmethod
    def _is_adasum_call(call):
        """op=...Adasum — per-tensor reduction IS Adasum's semantics
        (bucketing it would change the math: rule HVD405), so HVD206's
        use-the-grouped-API advice must not fire."""
        return any(kw.arg == "op" and _terminal_name(kw.value) == "Adasum"
                   for kw in call.keywords)

    @staticmethod
    def _tensor_is_loop_var(expr, names):
        """True when the reduced tensor IS the loop variable or a
        subscript/attribute/arithmetic view of it. Values that reach
        the loop variable only THROUGH a function call
        (``allreduce(train_step(model, batch))``) are new per-iteration
        data — the canonical per-batch metric reduction — and cannot be
        bucketed, so the walk stops at Call boundaries."""
        stack = [expr]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Name) and n.id in names:
                return True
            if isinstance(n, ast.Call):
                continue
            stack.extend(ast.iter_child_nodes(n))
        return False

    def visit_For(self, node):
        # A per-tensor eager allreduce whose tensor IS (or indexes
        # through) the loop variable — the reduce-one-tensor-per-
        # iteration shape. An unrelated allreduce in a training loop
        # (one metric per epoch/batch) is not a finding.
        names = {n.id for n in ast.walk(node.target)
                 if isinstance(n, ast.Name)}
        if names:
            for sub in _scan_statements(node.body):
                if (isinstance(sub, ast.Call)
                        and id(sub) not in self._flagged
                        and self._is_hvd_call(
                            sub, PER_TENSOR_ALLREDUCE_CALLS)
                        and not self._is_adasum_call(sub)
                        and sub.args
                        and self._tensor_is_loop_var(sub.args[0], names)):
                    self._report_206(sub)
        self.generic_visit(node)

    def _check_206_comp(self, node):
        # The comprehension spelling of the same shape:
        # [allreduce(g) for g in grads].
        names = set()
        for gen in node.generators:
            names |= {n.id for n in ast.walk(gen.target)
                      if isinstance(n, ast.Name)}
        if not names:
            return
        body = [node.value, node.key] if isinstance(node, ast.DictComp) \
            else [node.elt]
        for part in body:
            for sub in ast.walk(part):
                if (isinstance(sub, ast.Call)
                        and id(sub) not in self._flagged
                        and self._is_hvd_call(
                            sub, PER_TENSOR_ALLREDUCE_CALLS)
                        and not self._is_adasum_call(sub)
                        and sub.args
                        and self._tensor_is_loop_var(sub.args[0], names)):
                    self._report_206(sub)

    def visit_ListComp(self, node):
        self._check_206_comp(node)
        self.generic_visit(node)

    def visit_SetComp(self, node):
        self._check_206_comp(node)
        self.generic_visit(node)

    def visit_GeneratorExp(self, node):
        self._check_206_comp(node)
        self.generic_visit(node)

    def visit_DictComp(self, node):
        self._check_206_comp(node)
        self.generic_visit(node)

    # -- HVD205: lossy compression misuse ----------------------------------
    @staticmethod
    def _lossy_compression_kw(call):
        """Name of the lossy Compression member passed as
        ``compression=`` (``Compression.int8`` / ``hvd.Compression.fp16``
        / a bare imported alias), or None."""
        for kw in call.keywords:
            if kw.arg != "compression":
                continue
            if isinstance(kw.value, (ast.Attribute, ast.Name)):
                term = _terminal_name(kw.value)
                if term in LOSSY_COMPRESSORS:
                    return term
        return None

    @staticmethod
    def _expr_is_inty(expr):
        """Integer/bool evidence inside one expression: an int/bool
        dtype attribute or a randint construction."""
        for n in ast.walk(expr):
            if (isinstance(n, ast.Attribute)
                    and n.attr in _INTY_DTYPE_ATTRS):
                return True
            if (isinstance(n, ast.Call)
                    and _terminal_name(n.func) == "randint"):
                return True
        return False

    def _looks_integer_tensor(self, expr):
        """True when the tensor expression is visibly integer/bool
        (:meth:`_expr_is_inty`) or names a variable previously assigned
        one (one-hop local dataflow — visit_Assign records those)."""
        if self._expr_is_inty(expr):
            return True
        return any(isinstance(n, ast.Name) and n.id in self.int_names
                   for n in ast.walk(expr))

    @staticmethod
    def _expr_is_indexy(expr):
        """Index-tensor evidence inside one expression (rule HVD209):
        a ``.indices`` access (attr or call — the sparse-gradient
        halves) or an index-producing construction (argsort/argmax/
        nonzero/searchsorted)."""
        for n in ast.walk(expr):
            if isinstance(n, ast.Attribute) and n.attr in _INDEX_ATTRS:
                return True
            if (isinstance(n, ast.Call)
                    and _terminal_name(n.func)
                    in _INDEX_PRODUCING_CALLS):
                return True
        return False

    def _looks_index_tensor(self, expr):
        """HVD209's walk: visibly index-producing, or a name one-hop
        assigned from an index-producing expression."""
        if self._expr_is_indexy(expr):
            return True
        return any(isinstance(n, ast.Name) and n.id in self.index_names
                   for n in ast.walk(expr))

    # -- HVD208: ZeRO × Adasum / non-global process set --------------------
    def _note_zero_env(self, node):
        """Record ``os.environ["HVDTPU_ZERO"] = "1"`` (any accepted
        prefix spelling, any truthy value)."""
        for target in node.targets:
            if not isinstance(target, ast.Subscript):
                continue
            base = target.value
            is_env = ((isinstance(base, ast.Attribute)
                       and base.attr == "environ")
                      or (isinstance(base, ast.Name)
                          and base.id == "environ"))
            key = target.slice
            if (is_env and isinstance(key, ast.Constant)
                    and isinstance(key.value, str)
                    and key.value in _ZERO_ENV_NAMES
                    and isinstance(node.value, ast.Constant)
                    and str(node.value.value).strip().lower()
                    in ("1", "true", "yes", "on")):
                self.zero_env_set = True

    def _report_208(self, call, why):
        self._flagged.add(id(call))
        self.diags.append(Diagnostic.make(
            "HVD208",
            f"ZeRO sharded update combined with {why}: Adasum's "
            "per-tensor scale-invariant combination does not "
            "reduce-scatter, and a non-global process set derives a "
            "shard plan over the wrong replica axis — "
            "DistributedOptimizer raises at __init__ either way",
            file=self.filename, line=call.lineno,
            hint="drop zero=/HVDTPU_ZERO for this optimizer (or switch "
                 "to op=Average/Sum on the global process set); "
                 + _DOC_HINT))

    def _check_208(self, node):
        term = _terminal_name(node.func)
        if term not in DIST_OPT_CALLS or id(node) in self._flagged:
            return
        zero_on = self.zero_env_set
        for kw in node.keywords:
            if kw.arg == "zero":
                if isinstance(kw.value, ast.Constant):
                    # An explicit constant wins over the env knob —
                    # mirror __init__, where zero=False opts this
                    # optimizer out even under HVDTPU_ZERO=1.
                    zero_on = bool(kw.value.value)
                else:
                    # zero=<flag>: statically unknown — treat as
                    # reachable-on (the combination is never valid).
                    zero_on = True
        if not zero_on:
            return
        reasons = []
        if term == "DistributedAdasumOptimizer":
            reasons.append("Adasum (DistributedAdasumOptimizer)")
        for kw in node.keywords:
            if kw.arg == "op" and _terminal_name(kw.value) == "Adasum":
                reasons.append("op=Adasum")
            elif (kw.arg == "process_set"
                    and _terminal_name(kw.value) != "global_process_set"):
                reasons.append("a non-global process_set")
        if reasons:
            self._report_208(node, " and ".join(reasons))

    def visit_Assign(self, node):
        # One-hop dataflow for HVD205: `labels = ...int32...` marks the
        # NAME, so a later `allreduce(labels, compression=...)` is
        # recognizable. Reassignment from a float-looking value clears
        # the mark (last write wins, like the interpreter).
        self._note_zero_env(node)
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if names:
            inty = self._expr_is_inty(node.value)
            indexy = self._expr_is_indexy(node.value)
            for name in names:
                if inty:
                    self.int_names.add(name)
                else:
                    self.int_names.discard(name)
                if indexy:
                    self.index_names.add(name)
                else:
                    self.index_names.discard(name)
        self.generic_visit(node)

    def _report_205(self, call, comp, why):
        self._flagged.add(id(call))
        fn = _terminal_name(call.func)
        self.diags.append(Diagnostic.make(
            "HVD205",
            f"lossy compressor `Compression.{comp}` on `{fn}`: {why}",
            file=self.filename, line=call.lineno,
            hint="compression is for gradient reduction "
                 "(allreduce/grouped_allreduce of float gradients) "
                 "only — drop the compression= argument here; "
                 + _DOC_HINT))

    def _check_205(self, node):
        comp = self._lossy_compression_kw(node)
        if comp is None or id(node) in self._flagged:
            return
        term = _terminal_name(node.func)
        if (term in SYNC_COLLECTIVE_CALLS
                and self._is_hvd_call(node, SYNC_COLLECTIVE_CALLS)):
            self._report_205(
                node, comp,
                "broadcast/initial-sync collectives must be exact — a "
                "lossy wire format would start ranks from divergent "
                "(and silently different) state")
        elif (self._is_collective(node) and node.args
                and self._looks_integer_tensor(node.args[0])):
            self._report_205(
                node, comp,
                "the tensor is integer/bool, which has no meaningful "
                "lossy representation (counts and masks corrupt "
                "silently)")

    def _report_209(self, call, comp, why):
        self._flagged.add(id(call))
        fn = _terminal_name(call.func)
        self.diags.append(Diagnostic.make(
            "HVD209",
            f"lossy compressor `Compression.{comp}` on `{fn}`: {why}",
            file=self.filename, line=call.lineno,
            hint="only the VALUES half of a sparse gradient may ride a "
                 "wire codec (the sparse plane's row-wise int8 does "
                 "this; docs/sparse.md) — drop the compression= "
                 "argument here; " + _DOC_HINT))

    def _check_209(self, node):
        """HVD209: lossy codec on an index tensor / the indices half of
        a sparse gradient. Runs after HVD205 (the _flagged set dedups:
        an index tensor with a visible int dtype stays an HVD205
        finding; this rule catches the sparse spellings HVD205's
        dtype walk cannot see)."""
        comp = self._lossy_compression_kw(node)
        if comp is None or id(node) in self._flagged:
            return
        if (self._is_collective(node) and node.args
                and self._looks_index_tensor(node.args[0])):
            self._report_209(
                node, comp,
                "the tensor is (or derives from) an index tensor — "
                "indices must cross the wire exactly, or rows "
                "scatter-add into the wrong slots")

    def visit_Call(self, node):
        term = _terminal_name(node.func)
        if term == "init" and self._is_hvd_call(node, {"init"}):
            self.has_init = True
        elif term in DIST_OPT_CALLS:
            if self.dist_opt_node is None:
                self.dist_opt_node = node
            self._check_208(node)
        elif term in BROADCAST_STATE_CALLS:
            self.has_broadcast = True
        self._check_205(node)
        self._check_209(node)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if node.attr in _SYNC_MARKERS:
            self.has_broadcast = True
        elif (node.attr == "elastic"
                and _root_name(node) in self.res.hvd_aliases):
            self.res.uses_elastic = True
        self.generic_visit(node)

    def visit_Name(self, node):
        if node.id in _SYNC_MARKERS:
            self.has_broadcast = True
        self.generic_visit(node)

    def finish(self):
        if (self.has_init and self.dist_opt_node is not None
                and not self.has_broadcast and not self.res.uses_elastic):
            self.diags.append(Diagnostic.make(
                "HVD202",
                "script calls init() and builds a DistributedOptimizer "
                "but never broadcasts initial state: ranks start from "
                "divergent parameters/optimizer moments and silently "
                "train different models",
                file=self.filename, line=self.dist_opt_node.lineno,
                hint="after building params/optimizer, call "
                     "broadcast_parameters(...) and "
                     "broadcast_optimizer_state(..., root_rank=0) (or "
                     "use the Broadcast callback / elastic state); "
                     + _DOC_HINT))
        return self.diags


# ==========================================================================
# HVD207: raw begin/end timing pairs instead of the span API
# ==========================================================================

# Clocks the span API replaces. monotonic/perf_counter_ns are exempt:
# they back interval bookkeeping (stall ages, cycle pacing), not metric
# observations.
_SPAN_CLOCKS = frozenset({"time", "perf_counter"})


def _is_span_clock_call(node):
    """``time.time()`` / ``time.perf_counter()`` (or the bare
    from-imported spellings) with no arguments."""
    if not isinstance(node, ast.Call) or node.args or node.keywords:
        return False
    term = _terminal_name(node.func)
    if term not in _SPAN_CLOCKS:
        return False
    if isinstance(node.func, ast.Attribute):
        return _root_name(node.func) == "time"
    return True


def _clock_in(node):
    """The clock call inside an expression that may be conditioned
    (``t0 = time.perf_counter() if metrics_on else 0.0``)."""
    if _is_span_clock_call(node):
        return node
    if isinstance(node, ast.IfExp):
        for branch in (node.body, node.orelse):
            if _is_span_clock_call(branch):
                return branch
    return None


class _RawTimingAnalyzer:
    """HVD207 over one module: per scope, find ``t0 = <clock>()``
    followed by ``.observe(<clock>() - t0)`` (directly, or through one
    ``elapsed = <clock>() - t0`` hop)."""

    def __init__(self, filename):
        self.filename = filename
        self.diags = []

    def run(self, tree):
        scopes = [tree] + [n for n in ast.walk(tree)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
        for scope in scopes:
            self._scan_scope(scope)
        return self.diags

    @staticmethod
    def _scope_walk(scope):
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _elapsed_of(expr, begin_names):
        """The begin-variable name when ``expr`` is
        ``<clock>() - <t0>``, else None."""
        if (isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Sub)
                and _is_span_clock_call(expr.left)
                and isinstance(expr.right, ast.Name)
                and expr.right.id in begin_names):
            return expr.right.id
        return None

    def _scan_scope(self, scope):
        # Separate passes: the scope walk is not in source order, so
        # begin names must be fully collected before elapsed ones.
        assigns = [n for n in self._scope_walk(scope)
                   if isinstance(n, ast.Assign) and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Name)]
        begin_names = {n.targets[0].id: n.lineno for n in assigns
                       if _clock_in(n.value) is not None}
        if not begin_names:
            return
        elapsed_names = {}  # name -> (begin name, lineno)
        for n in assigns:
            t0 = self._elapsed_of(n.value, begin_names)
            if t0 is not None:
                elapsed_names[n.targets[0].id] = (t0, n.lineno)
        for node in self._scope_walk(scope):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "observe" and node.args):
                continue
            arg = node.args[0]
            t0 = self._elapsed_of(arg, begin_names)
            if t0 is None and isinstance(arg, ast.Name) \
                    and arg.id in elapsed_names:
                t0 = elapsed_names[arg.id][0]
            if t0 is None:
                continue
            self.diags.append(Diagnostic.make(
                "HVD207",
                f"raw `{t0} = time.time()/perf_counter()` begin/end "
                "pair feeding `.observe()`: the span API is the single "
                "instrument for the histogram, the timeline AND the "
                "trace plane, and its disabled mode reads no clock",
                file=self.filename, line=node.lineno,
                hint="wrap the timed region in `with telemetry.span("
                     "names, ACTIVITY, histogram=...)`; if the "
                     "observation is genuinely conditional (a span "
                     "observes unconditionally), document why and "
                     "suppress with `# hvd-lint: disable=HVD207`; "
                     + _DOC_HINT))


# ==========================================================================
# HVD210: unbounded request buffering in serving code
# ==========================================================================

class _RequestBufferAnalyzer:
    """HVD210 over one module: in serving context — a file under
    ``serving/``, a class whose name says scheduler/router/serving, or
    a ``handle_*`` request handler — flag request buffers with no
    bound: a bare ``queue.Queue()``/``queue.SimpleQueue()``, a
    ``deque()`` without ``maxlen``, or ``.append()`` onto a
    request-named list. The serving plane's backpressure contract
    (docs/serving.md) is that the *only* wait station is a bounded
    queue whose overflow answers 429 + Retry-After; any unbounded
    buffer silently converts overload into memory growth and tail
    latency instead of a reject the client can act on."""

    _CTX_CLASS_RE = re.compile(r"scheduler|router|serving", re.IGNORECASE)
    _CTX_FUNC_RE = re.compile(r"^handle_", re.IGNORECASE)
    _BUF_NAME_RE = re.compile(
        r"request|pending|backlog|queue|inbox|waiting", re.IGNORECASE)

    def __init__(self, filename):
        self.filename = filename
        self.diags = []
        parts = os.path.normpath(filename).split(os.sep)
        self._serving_file = "serving" in parts
        self._queue_ctors = set()    # local names of queue.Queue et al.
        self._deque_ctors = set()
        self._buffers = {}           # unparsed target -> assign lineno

    # -- import bookkeeping ------------------------------------------------
    def _note_imports(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if node.module == "queue":
                    for a in node.names:
                        if a.name in ("Queue", "LifoQueue",
                                      "PriorityQueue", "SimpleQueue"):
                            self._queue_ctors.add(a.asname or a.name)
                elif node.module == "collections":
                    for a in node.names:
                        if a.name == "deque":
                            self._deque_ctors.add(a.asname or a.name)

    def _ctor_kind(self, call):
        """'queue' / 'deque' / None for a constructor call node."""
        fn = call.func
        if isinstance(fn, ast.Attribute) and isinstance(fn.value,
                                                        ast.Name):
            if fn.value.id == "queue" and fn.attr in (
                    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"):
                return "queue"
            if fn.value.id == "collections" and fn.attr == "deque":
                return "deque"
        elif isinstance(fn, ast.Name):
            if fn.id in self._queue_ctors:
                return "queue"
            if fn.id in self._deque_ctors:
                return "deque"
        return None

    @staticmethod
    def _is_unbounded(kind, call):
        """True when the constructor carries no effective bound."""
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "SimpleQueue":
            return True  # SimpleQueue has no maxsize at all
        if isinstance(call.func, ast.Name) \
                and call.func.id == "SimpleQueue":
            return True
        bound_kw = "maxsize" if kind == "queue" else "maxlen"
        bound_pos = 0 if kind == "queue" else 1
        candidates = []
        if len(call.args) > bound_pos:
            candidates.append(call.args[bound_pos])
        candidates.extend(kw.value for kw in call.keywords
                          if kw.arg == bound_kw)
        for value in candidates:
            if isinstance(value, ast.Constant) \
                    and value.value in (0, None):
                continue  # explicit "infinite" spelling
            return False  # some bound expression is present
        return True

    def _report(self, node, what):
        self.diags.append(Diagnostic.make(
            "HVD210",
            f"{what} in serving scheduler/handler code: overload "
            "becomes unbounded memory growth and tail latency instead "
            "of backpressure the client can act on",
            file=self.filename, line=node.lineno,
            hint="bound the buffer (queue.Queue(maxsize=...) sized by "
                 "HVDTPU_SERVING_QUEUE_LIMIT, deque(maxlen=...)) and "
                 "answer 429 + Retry-After when full — see "
                 "docs/serving.md \"Backpressure\"; suppress with "
                 "`# hvd-lint: disable=HVD210` only for buffers whose "
                 "growth is bounded elsewhere; " + _DOC_HINT))

    # -- context walk ------------------------------------------------------
    def run(self, tree):
        self._note_imports(tree)
        self._walk(tree.body, self._serving_file)
        return self.diags

    def _walk(self, stmts, ctx):
        for node in stmts:
            node_ctx = ctx
            if isinstance(node, ast.ClassDef):
                node_ctx = ctx or bool(
                    self._CTX_CLASS_RE.search(node.name))
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                node_ctx = ctx or bool(
                    self._CTX_FUNC_RE.search(node.name))
            if node_ctx:
                self._scan_statement(node)
            for field in ("body", "orelse", "finalbody", "handlers"):
                children = getattr(node, field, None)
                if not children:
                    continue
                if field == "handlers":
                    for h in children:
                        self._walk(h.body, node_ctx)
                else:
                    self._walk(children, node_ctx)

    def _scan_statement(self, stmt):
        """One SIMPLE statement — compound statements contribute
        through their bodies, which the context walk owns (so nothing
        is scanned twice)."""
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.Expr,
                                 ast.Return, ast.AugAssign)):
            return
        if isinstance(stmt, ast.Assign):
            self._scan_assign(stmt)
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                self._scan_call(node)

    def _scan_assign(self, node):
        value = node.value
        if isinstance(value, ast.Call):
            kind = self._ctor_kind(value)
            if kind and self._is_unbounded(kind, value):
                ctor = _unparse(value.func)
                self._report(
                    node, f"unbounded `{ctor}()` request buffer")
                return
        if isinstance(value, (ast.List, ast.ListComp)) or (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "list"):
            for target in node.targets:
                name = _unparse(target)
                if self._BUF_NAME_RE.search(name.split(".")[-1]):
                    self._buffers[name] = node.lineno

    def _scan_call(self, node):
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"):
            return
        owner = _unparse(node.func.value)
        if owner in self._buffers:
            self._report(
                node, f"`{owner}.append(...)` grows a request list "
                      "without bound")


# ==========================================================================
# HVD3xx: concurrency & liveness (the static half of hvd-sanitize)
# ==========================================================================

# Thread names / target-method names that mark a collective-pacing loop
# (the coordinator cycle driver also runs the watchdog scans).
_LOOP_ROLE_RE = re.compile(r"coordinator|cycle|watchdog|heartbeat|stall",
                           re.IGNORECASE)
_ENV_PREFIXES = ("HVDTPU_", "HOROVOD_TPU_", "HOROVOD_")
# Attribute calls that block forever without a bound.
_WAITY_METHODS = frozenset({"wait", "join", "get"})
_BOUND_KWARGS = frozenset({"timeout", "deadline"})


def _unparse(node):
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — diagnostics only
        return "<expr>"


def _is_os_environ(node):
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name)
            and node.value.id == "os")


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ==========================================================================
# HVD212: hand-rolled cohort mutation (worker lifecycle outside the
# driver/actuator modules)
# ==========================================================================

#: Modules allowed to spawn/terminate worker processes: the elastic
#: drivers that reconcile desired state (and the launcher/ray shims
#: that implement the SlotProcess surface), plus the fleet actuator
#: module, which is the only legal cohort-mutation surface outside
#: them (docs/fault_tolerance.md "Fleet arbitration").
_LIFECYCLE_OWNER_SUFFIXES = (
    "runner/spawn.py", "runner/elastic_driver.py", "runner/standby.py",
    "runner/job.py", "ray/elastic.py", "fleet/actuators.py")

_KILL_METHODS = frozenset({"terminate", "kill", "send_signal"})


class _WorkerLifecycleAnalyzer:
    """HVD212 over one module: direct worker spawn/terminate outside
    the lifecycle-owner modules. Constructing a
    ``spawn.SlotProcess(...)`` by hand, or calling
    ``terminate``/``kill``/``send_signal`` on a worker process (a
    ``.proc`` attribute, a ``workers[...]`` entry, or a name bound to
    either), mutates a cohort behind the back of the elastic driver —
    no journal entry, no fleet lease, no blacklist accounting, and
    the next discovery tick fights the change. Cohort mutation is a
    desired-state write (target files, drain flags) the drivers
    reconcile; only the modules in ``_LIFECYCLE_OWNER_SUFFIXES`` own
    process handles."""

    def __init__(self, filename):
        self.filename = filename
        self.diags = []
        norm = os.path.normpath(filename).replace(os.sep, "/")
        self._owner = norm.endswith(_LIFECYCLE_OWNER_SUFFIXES)
        self._spawn_ctors = set()   # local names bound to SlotProcess
        self._spawn_mods = set()    # aliases of horovod_tpu.runner.spawn
        self._hvd_module = False    # file imports horovod at all
        self._proc_names = set()    # locals holding worker process handles

    # -- import bookkeeping ------------------------------------------------
    def _note_imports(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    root = a.name.split(".")[0]
                    if root in PKG_ROOTS:
                        self._hvd_module = True
                    if a.name.endswith(".spawn") \
                            and root in PKG_ROOTS:
                        self._spawn_mods.add(
                            a.asname or a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod.split(".")[0] in PKG_ROOTS \
                        or node.level:
                    self._hvd_module = True
                for a in node.names:
                    name = a.asname or a.name
                    if a.name == "SlotProcess":
                        self._spawn_ctors.add(name)
                    elif a.name == "spawn":
                        self._spawn_mods.add(name)

    def _is_spawn_ctor(self, call):
        fn = call.func
        if isinstance(fn, ast.Name):
            return fn.id in self._spawn_ctors
        if isinstance(fn, ast.Attribute) and fn.attr == "SlotProcess":
            root = _root_name(fn)
            return root in self._spawn_mods or self._hvd_module
        return False

    @staticmethod
    def _worker_receiver(node):
        """True when the call receiver reads like a worker process
        handle: any ``.proc`` hop or ``workers``/``.workers[...]``
        container access in the chain."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) \
                    and sub.attr in ("proc", "workers"):
                return True
            if isinstance(sub, ast.Name) and sub.id == "workers":
                return True
        return False

    def _report(self, node, what):
        self.diags.append(Diagnostic.make(
            "HVD212",
            f"{what} outside the driver/actuator modules: the cohort "
            "mutates with no journal entry, no fleet lease, and no "
            "blacklist accounting, and the next discovery reconcile "
            "fights it",
            file=self.filename, line=node.lineno,
            hint="mutate cohorts through desired state the drivers "
                 "reconcile — autoscale.write_target for membership, "
                 "fleet/actuators.py drain flags for serving, the "
                 "arbiter's lease ledger for chip transfers — see "
                 "docs/fault_tolerance.md \"Fleet arbitration\"; "
                 "suppress with `# hvd-lint: disable=HVD212` only in "
                 "launcher shims that own the process table; "
                 + _DOC_HINT))

    def run(self, tree):
        if self._owner:
            return []
        self._note_imports(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and self._is_spawn_ctor(node.value):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        self._proc_names.add(target.id)
            if not isinstance(node, ast.Call):
                continue
            if self._is_spawn_ctor(node):
                self._report(node, "direct `SlotProcess(...)` spawn")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _KILL_METHODS:
                recv = node.func.value
                if isinstance(recv, ast.Name) \
                        and recv.id in self._proc_names:
                    self._report(
                        node, f"`{recv.id}.{node.func.attr}()` on a "
                              "hand-spawned worker process")
                elif self._hvd_module and self._worker_receiver(recv):
                    self._report(
                        node,
                        f"`{_unparse(node.func)}()` on a worker "
                        "process handle")
        return self.diags


# ==========================================================================
# HVD213: silently swallowed transport errors in serving/fleet code
# ==========================================================================

#: Exception names that read as transport/IO failures. Matched on the
#: bare name or the last attribute hop (``urllib.error.URLError``,
#: ``http.client.HTTPException``, ``socket.timeout``).
_TRANSPORT_EXC_NAMES = frozenset({
    "OSError", "IOError", "EnvironmentError", "ConnectionError",
    "ConnectionResetError", "ConnectionRefusedError",
    "ConnectionAbortedError", "BrokenPipeError", "TimeoutError",
    "InterruptedError", "URLError", "HTTPException",
    "timeout", "gaierror", "herror",
})
# HTTPError is deliberately absent: it means the peer ANSWERED (with
# an error status) — a protocol outcome the handler usually translates
# into a status-code return, not a vanished transport failure.

#: Name patterns like ``_TRANSPORT_ERRORS`` — a tuple constant of
#: transport exception types bound to a module-level name.
_TRANSPORT_NAME_RE = re.compile(r"transport|network", re.IGNORECASE)

#: Attribute calls inside a handler that count as "the failure was
#: observed": a log record or a metric update.
_OBSERVE_ATTRS = frozenset({
    "debug", "info", "warning", "warn", "error", "exception",
    "critical", "log", "inc", "observe", "set",
})


class _SilentDegradationAnalyzer:
    """HVD213 over one module: in serving/fleet context — a file under
    ``serving/`` or ``fleet/``, a class whose name says
    router/scheduler/worker/arbiter/migration, or a ``handle_*``
    request handler — flag an ``except`` clause that catches a
    transport error (``OSError`` and kin, ``URLError``,
    ``HTTPException``, ``TimeoutError``, a ``*TRANSPORT*`` tuple) and
    neither re-raises nor records it (no ``raise``, no log call, no
    metric ``inc``/``observe``). The serving plane's degradation
    contract (docs/serving.md "Live migration") is *loud* fallback:
    every skipped peer, failed migration, or dead-marked worker leaves
    a log line or a counter bump; a silent swallow turns a transport
    fault into unexplained tail latency or quietly lost capacity."""

    _CTX_CLASS_RE = re.compile(
        r"serving|router|scheduler|arbiter|fleet|worker|migrat",
        re.IGNORECASE)
    _CTX_FUNC_RE = re.compile(r"^handle_", re.IGNORECASE)

    def __init__(self, filename):
        self.filename = filename
        self.diags = []
        parts = os.path.normpath(filename).split(os.sep)
        self._ctx_file = "serving" in parts or "fleet" in parts

    @classmethod
    def _transport_type(cls, node):
        """The transport-ish spelling in an except type expr, or None.

        Handles bare names, dotted names (last hop decides), and
        tuples (any transport element taints the whole clause — the
        handler body is shared)."""
        if node is None:
            return None
        if isinstance(node, ast.Tuple):
            for elt in node.elts:
                hit = cls._transport_type(elt)
                if hit:
                    return hit
            return None
        if isinstance(node, ast.Name):
            if node.id in _TRANSPORT_EXC_NAMES \
                    or _TRANSPORT_NAME_RE.search(node.id):
                return node.id
            return None
        if isinstance(node, ast.Attribute):
            if node.attr in _TRANSPORT_EXC_NAMES:
                return _unparse(node)
        return None

    @staticmethod
    def _handler_observes(handler):
        """True when the handler body re-raises or records the error:
        any ``raise``, or any call whose attribute name is a log/metric
        verb (``log.warning``, ``counter.inc``, ...)."""
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Raise):
                return True
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _OBSERVE_ATTRS:
                return True
            # A CLI front-end printing the failure (stderr) is loud.
            if isinstance(sub.func, ast.Name) and sub.func.id == "print":
                return True
        return False

    @staticmethod
    def _deferred_reraise(handler, func):
        """True for the retry-ladder idiom: the handler stashes the
        bound exception (``except OSError as e: last = e``) and the
        enclosing function raises it — or raises *through* it (``raise
        X(...) from last``) — after the loop. The error is not
        swallowed, just deferred past the last attempt."""
        if func is None or not handler.name:
            return False
        aliases = {handler.name}
        # Two passes so a chain (a = e; b = a) inside the handler
        # still resolves.
        for _ in range(2):
            for sub in ast.walk(handler):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    continue
                value = sub.value
                if not (isinstance(value, ast.Name)
                        and value.id in aliases):
                    continue
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for tgt in targets:
                    if isinstance(tgt, ast.Name):
                        aliases.add(tgt.id)
        in_handler = set()
        for sub in ast.walk(handler):
            in_handler.add(id(sub))
        for sub in ast.walk(func):
            if not isinstance(sub, ast.Raise) or id(sub) in in_handler:
                continue
            for expr in (sub.exc, sub.cause):
                if expr is None:
                    continue
                for name in ast.walk(expr):
                    if isinstance(name, ast.Name) \
                            and name.id in aliases:
                        return True
        return False

    def _report(self, handler, spelled):
        self.diags.append(Diagnostic.make(
            "HVD213",
            f"`except {spelled}` in serving/fleet code swallows a "
            "transport error without a log, metric, or re-raise: the "
            "failure disappears — degraded capacity and skipped peers "
            "become unexplained tail latency with no audit trail",
            file=self.filename, line=handler.lineno,
            hint="record the fallback before taking it — a "
                 "`log.warning(...)` naming what failed and what "
                 "happens instead, or a counter bump "
                 "(hvd_serving_migrations_total{outcome}), or re-raise "
                 "— see docs/serving.md \"Live migration\" fallback "
                 "ladder; suppress with `# hvd-lint: disable=HVD213` "
                 "only where the caller records the degradation; "
                 + _DOC_HINT))

    def run(self, tree):
        self._walk(tree.body, self._ctx_file, None)
        return self.diags

    def _walk(self, stmts, ctx, func):
        for node in stmts:
            node_ctx = ctx
            node_func = func
            if isinstance(node, ast.ClassDef):
                node_ctx = ctx or bool(
                    self._CTX_CLASS_RE.search(node.name))
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                node_ctx = ctx or bool(
                    self._CTX_FUNC_RE.search(node.name))
                node_func = node
            if node_ctx and isinstance(node, ast.Try):
                for handler in node.handlers:
                    spelled = self._transport_type(handler.type)
                    if spelled \
                            and not self._handler_observes(handler) \
                            and not self._deferred_reraise(handler,
                                                           func):
                        self._report(handler, spelled)
            for field in ("body", "orelse", "finalbody", "handlers"):
                children = getattr(node, field, None)
                if not children:
                    continue
                if field == "handlers":
                    for h in children:
                        self._walk(h.body, node_ctx, node_func)
                else:
                    self._walk(children, node_ctx, node_func)


class _ProtocolOrderAnalyzer:
    """HVD704/HVD705 over one module: AST-level companions to the
    hvd-model protocol checker (docs/modelcheck.md) — they catch the
    two bug shapes the models prove fatal *before* anything runs.

    Context: a file under ``fleet/`` or ``runner/``, or a class whose
    name says arbiter/ledger/journal/lease — the modules that execute
    the control-plane protocols.

    HVD704: within one function, an actuation call (``set_train_slots``
    / ``set_serve_slots`` / ``drain`` / ``write_target``) appears
    *before* the first durable ledger/journal write (a call like
    ``ledger.advance(...)`` / ``self._jrec(...)``). The arbiter's
    contract is ledger-before-actuation (fleet/ledger.py): a crash
    between an early actuation and its late write strands an effect the
    recovery protocol cannot see — exactly the ``actuate_before_ledger``
    counterexample hvd-model minimizes.

    HVD705: a ``<...>server.put(...)`` KV write carrying positional
    scope/key/value but no ``term=`` keyword. An unfenced write slips
    the split-brain fence (journal_spec.term_fences) — the
    ``skip_fence`` counterexample.
    """

    _CTX_CLASS_RE = re.compile(r"arbiter|ledger|journal|lease",
                               re.IGNORECASE)
    _DURABLE_RECV_RE = re.compile(r"ledger|journal", re.IGNORECASE)
    _DURABLE_ATTRS = frozenset({
        "record", "advance", "open", "mark_transfer", "set_split",
        "put", "write"})
    _ACTUATION_ATTRS = frozenset({
        "set_train_slots", "set_serve_slots", "drain", "write_target"})

    def __init__(self, filename):
        self.filename = filename
        self.diags = []
        parts = os.path.normpath(filename).split(os.sep)
        self._ctx_file = "fleet" in parts or "runner" in parts

    @staticmethod
    def _dotted(node):
        """Best-effort dotted receiver text ('self.ledger' etc.)."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
        return ".".join(reversed(parts))

    def _is_durable_write(self, call):
        func = call.func
        if isinstance(func, ast.Name) and func.id == "_jrec":
            return True
        if not isinstance(func, ast.Attribute):
            return False
        if func.attr == "_jrec":
            return True
        if func.attr not in self._DURABLE_ATTRS:
            return False
        return bool(self._DURABLE_RECV_RE.search(
            self._dotted(func.value)))

    def _is_actuation(self, call):
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in self._ACTUATION_ATTRS
        return (isinstance(func, ast.Attribute)
                and func.attr in self._ACTUATION_ATTRS)

    def _check_function(self, func_node):
        durable_line = None
        actuation = None
        for sub in ast.walk(func_node):
            if not isinstance(sub, ast.Call):
                continue
            if self._is_durable_write(sub):
                if durable_line is None or sub.lineno < durable_line:
                    durable_line = sub.lineno
            elif self._is_actuation(sub):
                if actuation is None or sub.lineno < actuation[1]:
                    name = (sub.func.attr
                            if isinstance(sub.func, ast.Attribute)
                            else sub.func.id)
                    actuation = (name, sub.lineno)
        if (durable_line is not None and actuation is not None
                and actuation[1] < durable_line):
            name, lineno = actuation
            self.diags.append(Diagnostic.make(
                "HVD704",
                f"actuation `{name}(...)` at line {lineno} precedes "
                f"the first durable ledger/journal write (line "
                f"{durable_line}) in `{func_node.name}` — a crash in "
                "the window strands an effect the recovery protocol "
                "cannot see (ledger-before-actuation, "
                "fleet/ledger.py)",
                file=self.filename, line=lineno,
                hint="write the lease/journal state first, actuate "
                     "second — recovery replays resume_action() from "
                     "the ledger; hvd-model minimizes the crash "
                     "interleaving (docs/modelcheck.md); suppress "
                     "with `# hvd-lint: disable=HVD704` where the "
                     "early call is not an actuation; " + _DOC_HINT))

    def _check_unfenced_put(self, call):
        func = call.func
        if not (isinstance(func, ast.Attribute) and func.attr == "put"):
            return
        recv = self._dotted(func.value)
        if not recv or not recv.split(".")[-1].endswith("server"):
            return
        if len(call.args) < 3:
            return      # backend .put(key, value) shims, not KV writes
        if any(kw.arg == "term" for kw in call.keywords):
            return
        self.diags.append(Diagnostic.make(
            "HVD705",
            f"`{recv}.put(...)` writes KV state without a `term=` "
            "fence in a protocol module — a resurrected stale primary "
            "could mutate cohort state after a newer term took over "
            "(split-brain; journal_spec.term_fences)",
            file=self.filename, line=call.lineno,
            hint="pass term= (runner/http_server.py rejects stale "
                 "writers with 409); hvd-model's `skip_fence` seeded "
                 "bug shows the interleaving (docs/modelcheck.md); "
                 "suppress with `# hvd-lint: disable=HVD705` for "
                 "stores that are never HA-replicated; " + _DOC_HINT))

    def run(self, tree):
        self._walk(tree.body, self._ctx_file)
        return self.diags

    def _walk(self, stmts, ctx):
        for node in stmts:
            node_ctx = ctx
            if isinstance(node, ast.ClassDef):
                node_ctx = ctx or bool(
                    self._CTX_CLASS_RE.search(node.name))
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) and node_ctx:
                self._check_function(node)
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        self._check_unfenced_put(sub)
                continue
            body = getattr(node, "body", None)
            if isinstance(body, list):
                self._walk(body, node_ctx)


class _HandRollResharding:
    """HVD211 over one module: a ``device_get(...)`` result that flows
    — through any chain of reshape / ravel / asarray / concatenate /
    pad / stack / split / indexing hops — into a ``device_put(...)``
    call is a hand-rolled reshard: it materializes the fully-replicated
    leaf on host and bypasses the redistribution planner
    (``horovod_tpu/resharding/``), whose programs are windowed to
    ``HVDTPU_RESHARD_BUCKET_BYTES``, digest-verified across ranks, and
    proven deadlock-free under hvd-sim. device_get alone (telemetry,
    checkpoint writers, test asserts) and device_put of fresh data are
    both fine — only the get→transform→put chain is the smell.

    Files under a ``resharding`` directory component are exempt (the
    planner's own executor legitimately stages host windows)."""

    _HOP_FUNCS = {"asarray", "array", "reshape", "ravel", "concatenate",
                  "pad", "stack", "hstack", "vstack", "split",
                  "ascontiguousarray", "flatten", "transpose", "copy",
                  "astype", "squeeze", "expand_dims"}

    def __init__(self, filename):
        self.filename = filename
        self.diags = []
        parts = os.path.normpath(filename).split(os.sep)
        self._exempt = "resharding" in parts
        self._tainted = set()

    @staticmethod
    def _call_name(call):
        fn = call.func
        if isinstance(fn, ast.Name):
            return fn.id
        if isinstance(fn, ast.Attribute):
            return fn.attr
        return None

    def _is_tainted(self, node):
        """Does this expression carry device_get-derived data?"""
        if isinstance(node, ast.Name):
            return node.id in self._tainted
        if isinstance(node, ast.Attribute):
            return self._is_tainted(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self._is_tainted(node.value)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._is_tainted(e) for e in node.elts)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp,
                             ast.SetComp)):
            return (self._is_tainted(node.elt)
                    or any(self._is_tainted(g.iter)
                           for g in node.generators))
        if isinstance(node, ast.BinOp):
            return (self._is_tainted(node.left)
                    or self._is_tainted(node.right))
        if isinstance(node, ast.Call):
            name = self._call_name(node)
            if name == "device_get":
                return True
            if name in self._HOP_FUNCS:
                if isinstance(node.func, ast.Attribute) \
                        and self._is_tainted(node.func.value):
                    return True  # tainted.reshape(...) method hop
                return any(self._is_tainted(a) for a in node.args)
        return False

    def run(self, tree):
        if self._exempt:
            return self.diags
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                if self._is_tainted(node.value):
                    for tgt in node.targets:
                        for leaf in ast.walk(tgt):
                            if isinstance(leaf, ast.Name):
                                self._tainted.add(leaf.id)
            elif isinstance(node, ast.AnnAssign) and node.value:
                if self._is_tainted(node.value) \
                        and isinstance(node.target, ast.Name):
                    self._tainted.add(node.target.id)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and self._call_name(node) == "device_put"):
                continue
            payloads = list(node.args[:1]) + [
                kw.value for kw in node.keywords if kw.arg in
                (None, "x", "arrays")]
            if any(self._is_tainted(a) for a in payloads):
                self.diags.append(Diagnostic.make(
                    "HVD211",
                    "device_get-derived data flows into device_put: a "
                    "hand-rolled reshard that materializes the full "
                    "replica on host, outside the planner's "
                    "HVDTPU_RESHARD_BUCKET_BYTES window, digest "
                    "checks, and hvd-sim deadlock proofs",
                    file=self.filename, line=node.lineno,
                    hint="express the transition as (src Spec, dst "
                         "Spec) and run resharding.plan_redistribution "
                         "+ execute_host / make_jit_executor (docs/"
                         "resharding.md); suppress with `# hvd-lint: "
                         "disable=HVD211` only for bounded scalar/"
                         "debug moves; " + _DOC_HINT))
        return self.diags


def _is_thread_ctor(node):
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Name):
        return node.func.id == "Thread"
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr == "Thread"
            and _root_name(node.func) == "threading")


def _thread_kwargs(call):
    """(target_attr_on_self or None, name constant or '', daemon bool)."""
    target, tname, daemon = None, "", False
    for kw in call.keywords:
        if kw.arg == "target":
            v = kw.value
            if (isinstance(v, ast.Attribute)
                    and isinstance(v.value, ast.Name)
                    and v.value.id == "self"):
                target = v.attr
        elif kw.arg == "name":
            tname = _const_str(kw.value) or ""
        elif kw.arg == "daemon":
            daemon = (isinstance(kw.value, ast.Constant)
                      and bool(kw.value.value))
    return target, tname, daemon


class _ConcurrencyAnalyzer:
    """HVD301/302/303/304/305 over one module."""

    def __init__(self, filename):
        self.filename = filename
        self.diags = []

    def run(self, tree):
        self._scan_env_reads(tree)
        for scope in self._scopes(tree):
            self._scan_acquires(scope)
        self._scan_thread_lifetimes(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self._scan_class(node)
        return self.diags

    # -- HVD304: raw env reads ---------------------------------------------
    def _scan_env_reads(self, tree):
        for node in ast.walk(tree):
            name, line = None, 0
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr == "get"
                        and _is_os_environ(f.value) and node.args):
                    name, line = _const_str(node.args[0]), node.lineno
                elif (isinstance(f, ast.Attribute) and f.attr == "getenv"
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "os" and node.args):
                    name, line = _const_str(node.args[0]), node.lineno
            elif (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and _is_os_environ(node.value)):
                name, line = _const_str(node.slice), node.lineno
            if name and name.startswith(_ENV_PREFIXES):
                self.diags.append(Diagnostic.make(
                    "HVD304",
                    f"raw os.environ read of {name!r} bypasses "
                    "utils/envparse.py — no HVDTPU_/HOROVOD_TPU_/"
                    "HOROVOD_ prefix fallback, and the knob never "
                    "reaches the registry that keeps docs/knobs.md "
                    "honest (rule HVD306)",
                    file=self.filename, line=line,
                    hint="read it via envparse.get_*(envparse.<NAME>) "
                         "and register() user-facing knobs; "
                         + _DOC_HINT))

    # -- HVD302: bare acquire ----------------------------------------------
    def _scopes(self, tree):
        """Module + every function, each scanned as one scope (a
        release in a different function cannot protect this one)."""
        yield tree
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def _scope_walk(self, scope):
        """Walk a scope without descending into nested functions."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _scan_acquires(self, scope):
        acquires = []
        released = set()
        for node in self._scope_walk(scope):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                if node.func.attr == "acquire":
                    acquires.append((node, _unparse(node.func.value)))
            if isinstance(node, ast.Try):
                for st in node.finalbody:
                    for sub in ast.walk(st):
                        if (isinstance(sub, ast.Call)
                                and isinstance(sub.func, ast.Attribute)
                                and sub.func.attr == "release"):
                            released.add(_unparse(sub.func.value))
        for call, base in acquires:
            if base in released:
                continue
            self.diags.append(Diagnostic.make(
                "HVD302",
                f"`{base}.acquire()` with no `{base}.release()` in a "
                "try/finally in this scope: an exception between "
                "acquire and release leaks the lock and every later "
                "acquirer blocks forever",
                file=self.filename, line=call.lineno,
                hint=f"use `with {base}:` (or release in a finally); "
                     + _DOC_HINT))

    # -- HVD305: thread lifetime -------------------------------------------
    def _scan_thread_lifetimes(self, tree):
        join_bases, daemon_bases = set(), set()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join"):
                join_bases.add(_unparse(node.func.value))
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and t.attr == "daemon"
                            and isinstance(node.value, ast.Constant)
                            and node.value.value):
                        daemon_bases.add(_unparse(t.value))
        assigned = {}  # id(thread_call) -> target text
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and _is_thread_ctor(node.value):
                assigned[id(node.value)] = _unparse(node.targets[0])
        for node in ast.walk(tree):
            if not _is_thread_ctor(node):
                continue
            _target, _tname, daemon = _thread_kwargs(node)
            if daemon:
                continue
            tgt = assigned.get(id(node))
            if tgt and (tgt in join_bases or tgt in daemon_bases):
                continue
            self.diags.append(Diagnostic.make(
                "HVD305",
                "thread started with neither daemon=True nor a "
                "visible join()/.daemon = True path"
                + (f" (assigned to {tgt})" if tgt else "")
                + ": it outlives shutdown() and keeps the interpreter "
                "from exiting",
                file=self.filename, line=node.lineno,
                hint="pass daemon=True, or keep a handle and join it "
                     "on the shutdown path; " + _DOC_HINT))

    # -- HVD301 + HVD303: per-class thread analysis ------------------------
    def _scan_class(self, cls):
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        thread_calls = []
        for node in ast.walk(cls):
            if _is_thread_ctor(node):
                target, tname, _daemon = _thread_kwargs(node)
                if target in methods:
                    thread_calls.append((target, tname))
        if not thread_calls:
            return
        closures = {t: self._closure(t, methods)
                    for t, _ in thread_calls}
        thread_side = set().union(*closures.values())
        self._rule_301(cls, methods, thread_side,
                       [t for t, _ in thread_calls])
        for target, tname in thread_calls:
            if _LOOP_ROLE_RE.search(tname or "") \
                    or _LOOP_ROLE_RE.search(target):
                role = tname or target
                for mname in sorted(closures[target]):
                    self._rule_303(methods[mname], role)

    def _closure(self, start, methods):
        """Methods reachable from ``start`` through ``self.X()`` calls
        — the code that runs on the thread, statically."""
        seen, stack = set(), [start]
        while stack:
            cur = stack.pop()
            if cur in seen or cur not in methods:
                continue
            seen.add(cur)
            for node in ast.walk(methods[cur]):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"
                        and node.func.attr in methods):
                    stack.append(node.func.attr)
        return seen

    def _attr_writes(self, fn):
        """[(attr, lineno, locked)] for self.<attr> assignments in
        ``fn`` (plain, augmented, subscript, tuple targets); ``locked``
        = lexically inside a ``with`` whose context mentions a lock."""
        out = []

        def targets_of(node):
            if isinstance(node, ast.Assign):
                return node.targets
            return [node.target]

        def self_attr(t):
            if isinstance(t, ast.Subscript):
                t = t.value
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                return t.attr
            return None

        def rec(node, locked):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, ast.With):
                holds = locked or any(
                    "lock" in _unparse(item.context_expr).lower()
                    for item in node.items)
                for st in node.body:
                    rec(st, holds)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                for t in targets_of(node):
                    elts = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t])
                    for e in elts:
                        attr = self_attr(e)
                        if attr:
                            out.append((attr, node.lineno, locked))
            for child in ast.iter_child_nodes(node):
                rec(child, locked)

        for st in fn.body:
            rec(st, False)
        return out

    def _rule_301(self, cls, methods, thread_side, targets):
        thread_writes, other_writes = {}, {}
        for mname, fn in methods.items():
            if mname in thread_side:
                side = thread_writes
            elif mname == "__init__":
                # Pre-start initialization: the universal ownership
                # handoff — the thread does not exist yet.
                continue
            else:
                side = other_writes
            for attr, lineno, locked in self._attr_writes(fn):
                side.setdefault(attr, []).append((mname, lineno, locked))
        for attr in sorted(set(thread_writes) & set(other_writes)):
            entries = thread_writes[attr] + other_writes[attr]
            unlocked = [e for e in entries if not e[2]]
            if not unlocked:
                continue
            mname, lineno, _ = min(unlocked, key=lambda e: e[1])
            t_methods = sorted({m for m, _, _ in thread_writes[attr]})
            o_methods = sorted({m for m, _, _ in other_writes[attr]})
            self.diags.append(Diagnostic.make(
                "HVD301",
                f"attribute `self.{attr}` of class {cls.name} is "
                f"written both on the thread side "
                f"({', '.join(t_methods)}; thread target(s) "
                f"{', '.join(sorted(targets))}) and from "
                f"{', '.join(o_methods)}, with at least one write "
                "outside any lock: concurrent writes race",
                file=self.filename, line=lineno,
                hint="guard every write with one lock, or document "
                     "the ownership protocol and suppress with "
                     "`# hvd-lint: disable=HVD301 — <why>`; "
                     + _DOC_HINT))

    def _rule_303(self, fn, role):
        for node in self._scope_walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            term = _terminal_name(f)
            what = None
            if term == "urlopen":
                what = "urlopen"
            elif (_root_name(f) == "subprocess"
                    or (isinstance(f, ast.Name) and f.id == "Popen")):
                what = _unparse(f)
            elif (isinstance(f, ast.Attribute) and term in _WAITY_METHODS
                    and not node.args
                    and not any(kw.arg in _BOUND_KWARGS
                                for kw in node.keywords)):
                what = f"{_unparse(f)}() with no timeout"
            if what is None:
                continue
            self.diags.append(Diagnostic.make(
                "HVD303",
                f"unbounded blocking call `{what}` inside the "
                f"{role!r} loop body (method {fn.name}): this thread "
                "paces the data plane, so the call starves every "
                "in-flight collective for its duration",
                file=self.filename, line=node.lineno,
                hint="bound it (timeout=/deadline=) or move it to a "
                     "non-critical thread; " + _DOC_HINT))


# ==========================================================================
# HVD306: knob registry <-> docs/knobs.md cross-check
# ==========================================================================

_DOC_KNOB_RE = re.compile(
    r"^\|\s*`(?:HVDTPU_|HOROVOD_TPU_|HOROVOD_)([A-Z0-9_]+)`"
    r"\s*\|\s*([^|]*)\|")


def _norm_default(text):
    """Comparable form of a default: parentheticals dropped
    ("0 (off)" == "0"), em-dash/empty equivalent, case-folded."""
    text = re.sub(r"\(.*?\)", "", text).strip()
    if text in ("—", "-", "–"):
        text = ""
    return text.lower()


def check_knob_docs(doc_path):
    """Cross-check ``envparse.KNOBS`` against the knob table rows of
    ``docs/knobs.md``: every registered knob needs a documented row,
    every documented row needs a registration, and the documented
    default must match the registered one (rule HVD306 — the registry
    is the docs' source of truth, so the default field is checked
    data, not decoration). Returns a list of :class:`Diagnostic`."""
    from ..utils import envparse
    try:
        with open(doc_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError as exc:
        return [Diagnostic.make(
            "HVD306", f"cannot read knob docs: {exc}", file=doc_path)]
    documented = {}
    for lineno, line in enumerate(lines, start=1):
        m = _DOC_KNOB_RE.match(line.strip())
        if m:
            documented.setdefault(m.group(1), (lineno, m.group(2)))
    diags = []
    for name, (lineno, doc_default) in sorted(documented.items()):
        reg = envparse.KNOBS.get(name)
        if reg is None:
            continue  # reported below as undocumented-registration
        if _norm_default(doc_default) != _norm_default(reg["default"]):
            diags.append(Diagnostic.make(
                "HVD306",
                f"knob {name}: documented default "
                f"{doc_default.strip()!r} disagrees with the "
                f"registered default {reg['default']!r}",
                file=doc_path, line=lineno,
                hint="align the docs row and the register() call in "
                     "utils/envparse.py; " + _DOC_HINT))
    for name in sorted(set(envparse.KNOBS) - set(documented)):
        diags.append(Diagnostic.make(
            "HVD306",
            f"knob {name} is registered in utils/envparse.py but has "
            f"no table row in {os.path.basename(doc_path)}",
            file=doc_path, line=0,
            hint=f"add a `HVDTPU_{name}` row (or drop the "
                 "registration); " + _DOC_HINT))
    for name in sorted(set(documented) - set(envparse.KNOBS)):
        diags.append(Diagnostic.make(
            "HVD306",
            f"knob {name} is documented but not registered in "
            "utils/envparse.py — nothing reads it through the "
            "registry, so it will silently drift",
            file=doc_path, line=documented[name][0],
            hint="register() it in utils/envparse.py (or drop the "
                 "row); " + _DOC_HINT))
    return diags


_DOC_METRIC_RE = re.compile(r"^\|\s*`(hvd_[a-z0-9_]+)`\s*\|\s*"
                            r"([a-z]+)\s*\|")
_METRIC_FACTORIES = frozenset({"counter", "gauge", "histogram"})
#: The metric families the serving/fleet registries own — the drift
#: check is scoped to them so rows registered elsewhere (coordinator,
#: elastic, ...) stay out of scope.
_METRIC_PREFIXES = ("hvd_serving_", "hvd_fleet_")


def _registered_metrics(source_paths):
    """``name -> (kind, file, line)`` scraped from
    ``telemetry.counter/gauge/histogram("name", ...)`` calls in the
    metric factory modules."""
    out = {}
    for path in source_paths:
        try:
            _, tree = parse_cached(path)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr in _METRIC_FACTORIES):
                continue
            if not node.args:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) \
                    and isinstance(first.value, str):
                out.setdefault(first.value,
                               (func.attr, path, node.lineno))
    return out


def check_metric_docs(doc_path, source_paths=None):
    """Cross-check the serving/fleet metric registries
    (``serving/metrics.py``, ``fleet/metrics.py``) against the table
    rows of ``docs/metrics.md``: every registered metric needs a
    documented row, every documented ``hvd_serving_*``/``hvd_fleet_*``
    row needs a registration, and the documented type column must match
    the registered factory (rule HVD307 — the registry is the docs'
    source of truth). Returns a list of :class:`Diagnostic`."""
    if source_paths is None:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
        source_paths = [os.path.join(pkg, "serving", "metrics.py"),
                        os.path.join(pkg, "fleet", "metrics.py")]
    try:
        with open(doc_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError as exc:
        return [Diagnostic.make(
            "HVD307", f"cannot read metric docs: {exc}",
            file=doc_path)]
    documented = {}
    for lineno, line in enumerate(lines, start=1):
        m = _DOC_METRIC_RE.match(line.strip())
        if m and m.group(1).startswith(_METRIC_PREFIXES):
            documented.setdefault(m.group(1), (lineno, m.group(2)))
    registered = {
        name: rec
        for name, rec in _registered_metrics(source_paths).items()
        if name.startswith(_METRIC_PREFIXES)}
    diags = []
    for name in sorted(set(documented) & set(registered)):
        doc_line, doc_kind = documented[name]
        reg_kind, _, _ = registered[name]
        if doc_kind != reg_kind:
            diags.append(Diagnostic.make(
                "HVD307",
                f"metric {name}: documented type {doc_kind!r} "
                f"disagrees with the registered factory "
                f"{reg_kind!r}",
                file=doc_path, line=doc_line,
                hint="align the docs row and the telemetry factory "
                     "call; " + _DOC_HINT))
    for name in sorted(set(registered) - set(documented)):
        _, src_file, src_line = registered[name]
        diags.append(Diagnostic.make(
            "HVD307",
            f"metric {name} is registered in "
            f"{os.path.basename(src_file)} but has no table row in "
            f"{os.path.basename(doc_path)}",
            file=src_file, line=src_line,
            hint=f"add a `{name}` row to docs/metrics.md (or drop "
                 "the factory); " + _DOC_HINT))
    for name in sorted(set(documented) - set(registered)):
        diags.append(Diagnostic.make(
            "HVD307",
            f"metric {name} is documented but not registered in the "
            "serving/fleet metric modules — nothing emits it, so the "
            "row is stale",
            file=doc_path, line=documented[name][0],
            hint="register it through telemetry.counter/gauge/"
                 "histogram (or drop the row); " + _DOC_HINT))
    return diags


def _apply_suppressions(diags, src):
    lines = src.splitlines()
    file_off = set()
    per_line = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_FILE_RE.search(line)
        if m:
            file_off.update(r.strip().upper()
                            for r in m.group(1).split(","))
        m = _SUPPRESS_RE.search(line)
        if m:
            per_line[i] = {r.strip().upper() for r in m.group(1).split(",")}

    def suppressed(d):
        if "ALL" in file_off or d.rule in file_off:
            return True
        for ln in (d.line, d.line - 1):
            rules = per_line.get(ln)
            if rules and ("ALL" in rules or d.rule in rules):
                # Same-line marker always applies; a previous-line marker
                # only applies if that line is a standalone comment.
                if ln == d.line or lines[ln - 1].lstrip().startswith("#"):
                    return True
        return False

    return [d for d in diags if not suppressed(d)]


# Parsed-corpus cache shared by every analysis layer of one process:
# within one CLI invocation the AST linter, the interprocedural
# verifier, and the schedule simulator all consume the same files —
# re-reading and re-parsing per leg dominated the --self/dogfood wall
# time. Keyed by (mtime_ns, size) so an edited file re-parses; trees
# are treated as read-only by every consumer.
_PARSE_CACHE = {}
_PARSE_CACHE_MAX = 2048


def parse_cached(path):
    """``(src, tree)`` for ``path``, parsed at most once per content
    version per process. Raises ``OSError``/``SyntaxError`` exactly
    like an uncached open+parse would."""
    path = os.path.abspath(path)
    try:
        st = os.stat(path)
        token = (st.st_mtime_ns, st.st_size)
    except OSError:
        token = None
    hit = _PARSE_CACHE.get(path)
    if hit is not None and hit[0] == token and token is not None:
        return hit[1], hit[2]
    with open(path, encoding="utf-8", errors="replace") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
        _PARSE_CACHE.clear()
    _PARSE_CACHE[path] = (token, src, tree)
    return src, tree


def _lint_tree(src, tree, filename):
    analyzer = _Analyzer(filename)
    analyzer.visit(tree)
    diags = analyzer.finish()
    diags.extend(_RawTimingAnalyzer(filename).run(tree))
    diags.extend(_RequestBufferAnalyzer(filename).run(tree))
    diags.extend(_WorkerLifecycleAnalyzer(filename).run(tree))
    diags.extend(_SilentDegradationAnalyzer(filename).run(tree))
    diags.extend(_ProtocolOrderAnalyzer(filename).run(tree))
    diags.extend(_HandRollResharding(filename).run(tree))
    diags.extend(_ConcurrencyAnalyzer(filename).run(tree))
    diags = _apply_suppressions(diags, src)
    return dedupe(sorted(diags, key=Diagnostic.sort_key))


def lint_source(src, filename="<string>"):
    """Lint python source text; returns a list of :class:`Diagnostic`."""
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as exc:
        return [Diagnostic.make(
            "HVD001", f"syntax error: {exc.msg}",
            file=filename, line=exc.lineno or 0)]
    return _lint_tree(src, tree, filename)


def lint_file(path):
    try:
        src, tree = parse_cached(path)
    except SyntaxError as exc:
        return [Diagnostic.make(
            "HVD001", f"syntax error: {exc.msg}",
            file=path, line=exc.lineno or 0)]
    return _lint_tree(src, tree, path)


def iter_python_files(paths):
    for path in paths:
        if os.path.isfile(path):
            yield path
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def lint_paths(paths):
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    diags = []
    for path in iter_python_files(paths):
        diags.extend(lint_file(path))
    return diags

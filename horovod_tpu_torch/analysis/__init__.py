"""Offline collective-correctness analysis (``hvd-lint``; port of
``horovod_tpu/analysis/``).

One finding type (:class:`Diagnostic`) across the layers:

1. **AST linter** (:func:`lint_paths` / :func:`lint_source`) — the
   HVD2xx collective rules and the HVD3xx concurrency rules over user
   scripts written against either package.
2. **interprocedural schedule verifier** (:func:`verify_paths` /
   :func:`extract_schedule`) — ``hvd-lint verify``: call graph +
   rank-dependence taint lattice + symbolic per-rank collective
   schedules (HVD4xx), then **executed** by the symbolic N-rank
   simulator (:func:`verify_and_simulate_paths`, ``hvd-sim``) whose
   lockstep matcher proves deadlocks/digest mismatches as HVD501/502
   with per-rank counterexample traces; ``resharding.Program.prove``
   runs redistribution programs through the same matcher.
   ``hvd-lint explain`` maps a flight-recorder postmortem bundle back to
   the divergent slot's source line. SARIF 2.1.0 output and the
   content-hash baseline workflow ride on the same Diagnostic stream.
3. **α–β cost model** (``costmodel``) — ``hvd-lint perf``: step
   prediction, calibration from trace shards, HVD6xx.
4. **protocol model checker** (``protocol``/``hvd-model``) — the
   control-plane spec modules the HA journal, fleet ledger, and
   KV-migration runtimes execute, plus the explicit-state explorer
   (HVD7xx).
5. **runtime order guard** (:class:`SubmissionOrderGuard`) — the opt-in
   ``HOROVOD_TPU_ORDER_CHECK=1`` dynamic backstop in the coordinator.
6. **runtime concurrency sanitizer** (``sanitizer``) — the opt-in
   ``HVDTPU_SANITIZE=1`` lock-order/liveness instrumentation behind the
   HVD3xx thread-safety rules.

The CLI is ``python -m horovod_tpu_torch.analysis.cli`` (``hvd-model``:
``python -m horovod_tpu_torch.analysis.protocol.cli``). Not ported yet:
the traced-program analyzer behind ``verify=`` (the JAX package's
jaxpr layer; :func:`verify_traceable` raises).

Public names resolve lazily (PEP 562): the control-plane runtime
imports the ``analysis.protocol`` spec modules on its hot import path,
so touching this package must not load the parser stack or the
simulator until a caller asks for them.
"""

import importlib

from .diagnostics import (  # noqa: F401  (eager: stdlib-only)
    Diagnostic, RULES, ERROR, WARNING, dedupe, worst_severity,
)

#: public name -> the submodule that defines it (resolved on first use).
_LAZY_NAMES = {
    "AliasResolver": "ast_lint", "lint_source": "ast_lint",
    "lint_file": "ast_lint", "lint_paths": "ast_lint",
    "iter_python_files": "ast_lint",
    "extract_schedule": "schedule", "verify_paths": "schedule",
    "verify_source": "schedule",
    "render_trace": "simulate", "simulate_paths": "simulate",
    "simulate_source": "simulate",
    "verify_and_simulate_paths": "simulate",
    "verify_and_simulate_source": "simulate",
    "ExplainError": "explain", "explain_bundle": "explain",
    "render_report": "explain",
    "to_sarif": "sarif", "write_sarif": "sarif",
    "filter_new": "baseline", "load_baseline": "baseline",
    "write_baseline": "baseline",
    "SubmissionOrderGuard": "order_guard",
}

_LAZY_MODULES = frozenset({
    "ast_lint", "baseline", "cli", "costmodel", "explain", "order_guard",
    "protocol", "sanitizer", "sarif", "schedule", "simulate",
})

def __getattr__(name):
    if name in _LAZY_NAMES:
        mod = importlib.import_module("." + _LAZY_NAMES[name], __name__)
        value = getattr(mod, name)
        globals()[name] = value
        return value
    if name in _LAZY_MODULES:
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_NAMES) | _LAZY_MODULES)


def runtime_axis_sizes():
    """Axis sizes of the initialized runtime (``{"hvd": size}``, the
    replica axis of the JAX package's mesh). Empty when the runtime is
    not initialized."""
    from .. import basics
    if not basics.is_initialized():
        return {}
    return {"hvd": basics.size()}


def enforce(diags, mode, what="function", logger=None):
    """Apply a ``verify=`` policy to analyzer findings.

    ``mode`` False/None: no-op. ``"warn"``: log every finding. ``True``
    or ``"error"``: log warnings, raise :class:`CollectiveLintError`
    when any error-severity finding exists.
    """
    if not mode or not diags:
        return diags
    from ..exceptions import CollectiveLintError
    if logger is None:
        from ..utils.logging_util import get_logger
        logger = get_logger()
    errors = [d for d in diags if d.severity == ERROR]
    for d in diags:
        logger.warning("hvd-lint [%s]: %s", what, d.format())
    if errors and mode is not False and mode != "warn":
        raise CollectiveLintError(errors)
    return diags


def verify_traceable(fn, args, kwargs=None, axis_sizes=None, mode=True,
                     what="compiled function"):
    """The hook the compile bridge calls behind ``verify=``: needs the
    traced-program analyzer, which is not ported yet."""
    raise NotImplementedError(
        "verify=: the traced-program collective analyzer (the torch.fx "
        "counterpart of the JAX package's jaxpr_lint) is not ported yet "
        "(ROADMAP queue A, item 15); the offline analyzer is "
        "`python -m horovod_tpu_torch.analysis.cli verify`")

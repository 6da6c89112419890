"""``hvd-lint``: static collective-correctness + concurrency linter CLI
(port of ``horovod_tpu/analysis/cli.py``; run it as
``python -m horovod_tpu_torch.analysis.cli``).

Runs the AST layer over scripts/directories and prints structured
findings with ``file:line`` + fix hints:

    hvd-lint train.py examples/
    hvd-lint verify train.py             # + HVD4xx + simulated HVD5xx
    hvd-lint perf train.py               # + α–β cost model + HVD6xx
    hvd-lint perf --calibrate ./hvd_traces --write-table model.json
    hvd-lint explain ./traces --program train.py   # postmortem → line
    hvd-lint --format json --fail-on warning src/
    hvd-lint --format sarif src/ > lint.sarif
    hvd-lint --write-baseline lint-baseline.json src/
    hvd-lint --baseline lint-baseline.json src/   # fail on NEW only
    hvd-lint --self                 # sweep horovod_tpu_torch/ itself
    hvd-lint --check-knobs          # knob registry vs docs/knobs.md
    hvd-lint --list-rules

``verify`` is the interprocedural mode: on top of the single-hop rules
it builds a call graph over each script plus the package modules it
imports (``horovod_tpu_torch``'s, and the JAX package's read as text),
propagates a rank-dependence taint lattice, extracts the symbolic per-rank collective schedule, applies the
heuristic HVD4xx family (analysis/schedule.py), and then **executes**
the extracted schedules in the symbolic N-rank simulator
(analysis/simulate.py): proven deadlocks (HVD501) and digest
mismatches (HVD502) are emitted with per-rank counterexample traces
(SARIF ``codeFlows``), approximations stay HVD503 warnings, and a
proven finding supersedes the heuristic one on the same event. Both
layers share one parsed corpus and one call-graph fixpoint per
invocation.

``perf`` is everything ``verify`` does plus the calibrated α–β cost
model (analysis/costmodel.py) over the SAME parsed corpus and
call-graph fixpoint: every extracted schedule gets a predicted
per-step critical path and comm/compute split at the probed cohort
sizes (``--target-ranks`` / ``HVDTPU_PERF_TARGET_RANKS``), and the
static HVD6xx performance rules (bucket pessimality, serialization
points, scale cliffs) join the finding stream. ``--calibrate DIR``
fits the model table from trace shards (``HVDTPU_TRACE=1``) first
(``--write-table FILE`` persists it; ``--table FILE`` /
``HVDTPU_COSTMODEL_TABLE`` loads one); without a table the checked-in
default covers the cold case.

``explain`` is the postmortem loop (analysis/explain.py): point it at
a flight-recorder postmortem bundle directory (and the program via
``--program``) and it names the first divergent slot, the matching
HVD5xx diagnosis, and the submitting source line.

``--self`` is the hvd-sanitize self-analysis: every rule — collective
HVD2xx + concurrency HVD3xx + the interprocedural HVD4xx — over the
installed ``horovod_tpu_torch`` package, plus the knob-docs
cross-check (HVD306) when the repo's docs/knobs.md is present, failing
on warnings — the framework must hold itself to the rules it enforces
on user scripts. Unless a baseline is named, ``--self`` filters through
:data:`SELF_BASELINE`, keyed relative to the checkout root: the rows of
docs/knobs.md for knobs the port does not read yet, and nothing else.

Baselines (analysis/baseline.py): ``--write-baseline FILE`` records
current findings keyed by rule x file x content-hash;
``--baseline FILE`` (default: the ``HVDTPU_LINT_BASELINE`` knob) then
fails only on findings NOT in the record — the supported way to turn
a new warning-strength rule on in CI without fixing the world first.
SARIF output (analysis/sarif.py) marks baseline-suppressed results
with ``suppressions`` instead of dropping them.

Exit codes: 0 no NEW findings at/above ``--fail-on``; 1 findings; 2
usage or internal error. The jaxpr layer needs traced inputs, so it is
an API and a bridge flag (``verify=``) rather than a CLI mode; the
port's counterpart of that layer is not written yet, so this CLI is
the whole of the port's analyzer.
"""

import argparse
import json
import os
import sys
import time

from . import (ast_lint, baseline as baseline_mod, costmodel, explain
               as explain_mod, sarif, simulate)
from .diagnostics import ERROR, RULES, dedupe, Diagnostic


def _package_dir():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: The baseline ``--self`` filters through: HVD306 rows of docs/knobs.md
#: for knobs the port does not read yet (written with ``--self
#: --write-baseline``; keys relative to the checkout root).
SELF_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "self_baseline.json")


def _default_knob_docs():
    """docs/knobs.md next to the package (repo checkouts); None when
    absent (pip installs ship no docs — nothing to cross-check)."""
    path = os.path.join(os.path.dirname(_package_dir()), "docs",
                        "knobs.md")
    return path if os.path.isfile(path) else None


def _default_metric_docs():
    """docs/metrics.md next to the package; None when absent."""
    path = os.path.join(os.path.dirname(_package_dir()), "docs",
                        "metrics.md")
    return path if os.path.isfile(path) else None


def _build_parser():
    parser = argparse.ArgumentParser(
        prog="hvd-lint",
        description="Static collective-correctness and concurrency "
                    "linter for horovod_tpu_torch training scripts "
                    "(and, via --self, for horovod_tpu_torch itself). "
                    "Prepend the "
                    "`verify` subcommand for the interprocedural "
                    "schedule verifier + symbolic simulator "
                    "(HVD4xx/HVD5xx), or `explain` to map a "
                    "postmortem bundle back to source.")
    parser.add_argument("paths", nargs="*", default=[],
                        help="python files or directories (default: . "
                             "unless only --check-knobs is requested)")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text")
    parser.add_argument("--rules", default="",
                        help="comma-separated rule ids to enable "
                             "(default: all)")
    parser.add_argument("--fail-on", choices=("error", "warning", "never"),
                        default="error",
                        help="lowest severity that fails the run "
                             "(default: error; --self implies warning)")
    parser.add_argument("--self", dest="self_sweep", action="store_true",
                        help="sweep the horovod_tpu_torch package with "
                             "every rule (incl. the interprocedural "
                             "HVD4xx family and the simulated HVD5xx) "
                             "+ the knob-docs cross-check, failing on "
                             "warnings (the hvd-sanitize "
                             "self-analysis)")
    parser.add_argument("--check-knobs", action="store_true",
                        help="cross-check the envparse knob registry "
                             "against docs/knobs.md (HVD306); with no "
                             "paths given, runs only the cross-check")
    parser.add_argument("--knobs-md", default="", metavar="PATH",
                        help="knob docs to cross-check against "
                             "(default: the repo's docs/knobs.md)")
    parser.add_argument("--check-metrics", action="store_true",
                        help="cross-check the serving/fleet metric "
                             "registries against docs/metrics.md "
                             "(HVD307); with no paths given, runs "
                             "only the cross-check")
    parser.add_argument("--metrics-md", default="", metavar="PATH",
                        help="metric docs to cross-check against "
                             "(default: the repo's docs/metrics.md)")
    parser.add_argument("--baseline", default="", metavar="FILE",
                        help="fail only on findings NOT recorded in "
                             "FILE (default: the HVDTPU_LINT_BASELINE "
                             "knob); recorded ones are reported as "
                             "suppressed")
    parser.add_argument("--write-baseline", default="", metavar="FILE",
                        help="record the current findings as the "
                             "accepted baseline and exit 0")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    perf = parser.add_argument_group(
        "perf (the `perf` subcommand / --self)")
    perf.add_argument("--calibrate", default="", metavar="DIR",
                      help="fit the α–β model table from the trace "
                           "shards under DIR before analyzing "
                           "(unreadable/torn shards are skipped with "
                           "a warning)")
    perf.add_argument("--write-table", default="", metavar="FILE",
                      help="persist the calibrated table as JSON "
                           "(with no paths: calibrate-and-write only)")
    perf.add_argument("--table", default="", metavar="FILE",
                      help="model table to predict with (default: "
                           "the HVDTPU_COSTMODEL_TABLE knob, else the "
                           "built-in default table)")
    perf.add_argument("--target-ranks", default="", metavar="LIST",
                      help="comma-separated cohort sizes to probe "
                           "(default: the HVDTPU_PERF_TARGET_RANKS "
                           "knob, else 8,64,256,1024)")
    return parser


def _collect(paths, verify, perf=False, table=None, ranks=None,
             want_report=False):
    """One invocation, one parsed corpus: the AST layer shares file
    reads with the verifier through the parse cache, and the verify
    and perf legs share ONE Verifier (one corpus load, one call-graph
    fixpoint — the perf leg's ``Verifier.fixpoint()`` is idempotent).
    Returns ``(diags, perf_report_or_None)``."""
    diags = ast_lint.lint_paths(paths)
    report = None
    if verify or perf:
        verifier = simulate.Verifier()
        for path in ast_lint.iter_python_files(paths):
            verifier.add_path(path)
        if verify:
            # heuristic HVD4xx + simulated HVD5xx
            diags.extend(simulate.run_combined(verifier))
        if perf:
            diags.extend(costmodel.perf_diagnostics(
                verifier, table=table, target_ranks=ranks))
            if want_report:
                report = costmodel.analyze_corpus(
                    verifier, table=table, target_ranks=ranks)
    return dedupe(sorted(diags, key=Diagnostic.sort_key)), report


def _explain_main(argv):
    parser = argparse.ArgumentParser(
        prog="hvd-lint explain",
        description="Map a flight-recorder postmortem bundle back to "
                    "the source line where the per-rank schedules "
                    "diverged.")
    parser.add_argument("bundle", help="directory holding the "
                        "postmortem.*.jsonl shards")
    parser.add_argument("--program", action="append", default=[],
                        metavar="PATH",
                        help="the training program (repeatable) whose "
                             "extracted schedule maps slots to source "
                             "lines")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    args = parser.parse_args(argv)
    try:
        report = explain_mod.explain_bundle(args.bundle, args.program)
    except explain_mod.ExplainError as exc:
        print(f"hvd-lint explain: {exc}", file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"hvd-lint explain: {exc}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(explain_mod.to_json(report))
    else:
        print(explain_mod.render_report(report))
    return 0


def _baseline_path(args):
    if args.baseline:
        return args.baseline, True
    from ..utils import envparse
    path = envparse.get_str(envparse.LINT_BASELINE)
    # the env-default baseline is best-effort: a job exported the knob
    # but the file is gone -> run unfiltered rather than die in CI
    if path:
        return path, False
    if args.self_sweep:
        return SELF_BASELINE, True
    return None, False


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    argv = list(argv)
    if argv and argv[0] == "explain":
        return _explain_main(argv[1:])
    verify = bool(argv) and argv[0] == "verify"
    perf = bool(argv) and argv[0] == "perf"
    if verify or perf:
        argv = argv[1:]
    verify = verify or perf  # perf = verify + the cost-model layer
    parser = _build_parser()
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    if args.list_rules:
        for rule, (severity, title) in sorted(RULES.items()):
            print(f"{rule}  {severity:7s}  {title}")
        return 0

    fail_on = args.fail_on
    # An explicit --knobs-md implies the cross-check: a user who named
    # the file expects it to be read.
    check_knobs = (args.check_knobs or args.self_sweep
                   or bool(args.knobs_md))
    check_metrics = (args.check_metrics or args.self_sweep
                     or bool(args.metrics_md))
    paths = list(args.paths)
    if args.self_sweep:
        paths = [_package_dir()]
        verify = True
        perf = True   # the perf leg rides the same corpus — HVD6xx
        if fail_on == "error":
            fail_on = "warning"
    elif not paths and not (check_knobs or check_metrics) \
            and not args.calibrate:
        paths = ["."]
    # `hvd-lint --check-knobs`/`--check-metrics` with no paths runs
    # ONLY the cross-check(s).

    table, ranks = None, None
    if perf:
        if args.calibrate:
            try:
                table = costmodel.fit_paths([args.calibrate])
            except (OSError, ValueError) as exc:
                print(f"hvd-lint perf: {exc}", file=sys.stderr)
                return 2
            worlds = "/".join(str(w) for w in table["worlds"])
            compute = ("none" if table["compute_s"] is None
                       else f"{table['compute_s'] * 1e3:.3f} ms")
            print(f"hvd-lint perf: calibrated {table['spans']} span(s) "
                  f"at world size(s) {worlds or '?'} "
                  f"(compute baseline: {compute})")
            if args.write_table:
                try:
                    costmodel.save_table(table, args.write_table)
                except OSError as exc:
                    print(f"hvd-lint perf: cannot write table: {exc}",
                          file=sys.stderr)
                    return 2
                print("hvd-lint perf: model table -> "
                      f"{args.write_table}")
            if not paths:
                return 0
        elif args.table:
            try:
                table = costmodel.load_table(args.table)
            except (OSError, ValueError) as exc:
                print(f"hvd-lint perf: cannot read table: {exc}",
                      file=sys.stderr)
                return 2
        if args.target_ranks:
            ranks = sorted({int(p) for p in
                            args.target_ranks.split(",")
                            if p.strip().isdigit() and int(p) >= 2}) \
                or None

    diags, perf_report = [], None
    try:
        if paths:
            diags, perf_report = _collect(
                paths, verify, perf=perf, table=table, ranks=ranks,
                want_report=(perf and not args.self_sweep
                             and args.format == "text"))
    except OSError as exc:
        print(f"hvd-lint: {exc}", file=sys.stderr)
        return 2

    if check_knobs:
        # An explicit --knobs-md that cannot be read surfaces as an
        # HVD306 diagnostic from check_knob_docs. A missing DEFAULT
        # docs file is only tolerated for the implicit --self case
        # (pip installs ship no docs); an explicit --check-knobs that
        # finds nothing to check must not report green.
        doc_path = args.knobs_md or _default_knob_docs()
        if doc_path:
            diags.extend(ast_lint.check_knob_docs(doc_path))
        elif args.check_knobs or args.knobs_md:
            print("hvd-lint: no knob docs found (no docs/knobs.md "
                  "next to the package); pass --knobs-md PATH",
                  file=sys.stderr)
            return 2

    if check_metrics:
        # Same tolerance contract as the knob cross-check: implicit
        # (--self) skips silently when the docs are absent, explicit
        # --check-metrics must not report green on nothing.
        doc_path = args.metrics_md or _default_metric_docs()
        if doc_path:
            diags.extend(ast_lint.check_metric_docs(doc_path))
        elif args.check_metrics or args.metrics_md:
            print("hvd-lint: no metric docs found (no docs/metrics.md "
                  "next to the package); pass --metrics-md PATH",
                  file=sys.stderr)
            return 2

    only = {r.strip().upper() for r in args.rules.split(",") if r.strip()}
    if only:
        diags = [d for d in diags if d.rule in only]
    diags.sort(key=lambda d: d.sort_key())

    # --self keys its baseline to the checkout root, so the sweep reads
    # the same from any working directory.
    root = os.path.dirname(_package_dir()) if args.self_sweep else None
    if args.write_baseline:
        try:
            baseline_mod.write_baseline(diags, args.write_baseline,
                                        root=root)
        except OSError as exc:
            print(f"hvd-lint: cannot write baseline: {exc}",
                  file=sys.stderr)
            return 2
        print(f"hvd-lint: baseline recorded ({len(diags)} finding(s) "
              f"-> {args.write_baseline})")
        return 0

    suppressed = []
    base_path, explicit = _baseline_path(args)
    if base_path:
        try:
            doc = baseline_mod.load_baseline(base_path)
        except (OSError, ValueError) as exc:
            if explicit:
                print(f"hvd-lint: cannot read baseline: {exc}",
                      file=sys.stderr)
                return 2
            doc = None
        if doc is not None:
            diags, suppressed = baseline_mod.filter_new(diags, doc,
                                                        root=root)

    if args.format == "json":
        print(json.dumps([d.to_dict() for d in diags], indent=1))
    elif args.format == "sarif":
        sarif.write_sarif(None, diags, suppressed=suppressed)
    else:
        if perf_report is not None:
            report_text = costmodel.render_report(perf_report)
            if report_text:
                print(report_text)
        for d in diags:
            print(d.format())
            trace_text = simulate.render_trace(d)
            if trace_text:
                print(trace_text)
        errors = sum(d.severity == ERROR for d in diags)
        tail = (f", {len(suppressed)} baseline-suppressed"
                if suppressed else "")
        elapsed = time.perf_counter() - t_start
        print(f"hvd-lint: {len(diags)} finding(s) "
              f"({errors} error(s), {len(diags) - errors} warning(s)"
              f"{tail}) in {elapsed:.2f}s")

    if fail_on == "never":
        return 0
    if fail_on == "warning":
        return 1 if diags else 0
    return 1 if any(d.severity == ERROR for d in diags) else 0


if __name__ == "__main__":
    sys.exit(main())

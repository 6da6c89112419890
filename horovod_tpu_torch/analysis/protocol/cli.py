"""``hvd-model`` — explicit-state model checker for the control-plane
protocols (HA terms, fleet leases, KV migration); port of
``horovod_tpu/analysis/protocol/cli.py``, run as
``python -m horovod_tpu_torch.analysis.protocol.cli``.

Explores the bounded state space of each protocol model
(machines.py) with crash/restart, message loss, duplication, and
reorder injected at every step, checks the safety invariants on every
state and bounded liveness on complete explorations, and renders
violations through the hvd-lint machinery: HVD701 (safety), HVD702
(liveness), HVD703 (budget), with minimized counterexample traces as
text interleavings or SARIF codeFlows. See docs/modelcheck.md.

Exit codes: 0 all explored models clean, 1 violations (at --fail-on
severity) found, 2 usage error.
"""

import argparse
import json
import sys
import time

from ..diagnostics import ERROR, worst_severity
from . import machines
from .model import explore, result_diagnostics


def _parser():
    parser = argparse.ArgumentParser(
        prog="hvd-model",
        description="Explicit-state model checker for the "
                    "control-plane protocols (docs/modelcheck.md).")
    parser.add_argument(
        "--protocol", default="all",
        choices=("all",) + machines.PROTOCOLS,
        help="which protocol to check (default: all)")
    parser.add_argument(
        "--seed-bug", default=None, metavar="NAME",
        help="re-introduce a named historical bug into the model "
             "(the mutation proof; see --list). Requires a single "
             "--protocol.")
    parser.add_argument(
        "--depth", type=int, default=24,
        help="BFS depth bound (default: 24)")
    parser.add_argument(
        "--max-states", type=int, default=100000,
        help="state-count bound (default: 100000)")
    parser.add_argument(
        "--budget-s", type=float, default=None, metavar="SECONDS",
        help="wall-clock bound across ALL explored models; running "
             "out is itself a finding (HVD703)")
    parser.add_argument(
        "--format", default="text", choices=("text", "json", "sarif"))
    parser.add_argument(
        "--fail-on", default="warning",
        choices=("error", "warning", "never"),
        help="exit 1 at this severity (default: warning — budget "
             "overruns fail CI too)")
    parser.add_argument(
        "--keep-going", action="store_true",
        help="collect every violation per model instead of stopping "
             "at the first")
    parser.add_argument(
        "--list", action="store_true",
        help="list protocols, their invariants, and seeded bugs")
    return parser


def _list_models():
    for proto in machines.PROTOCOLS:
        for model in machines.build(proto):
            invs = ", ".join(name for name, _ in model.invariants)
            goals = ", ".join(name for name, _ in model.liveness)
            print(f"{proto}: invariants [{invs}] liveness [{goals}]")
        bugs = ", ".join(machines.BUGS.get(proto, ())) or "none"
        print(f"{proto}: seeded bugs: {bugs}")


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.list:
        _list_models()
        return 0
    protocols = (machines.PROTOCOLS if args.protocol == "all"
                 else (args.protocol,))
    if args.seed_bug is not None and args.protocol == "all":
        print("hvd-model: --seed-bug needs a single --protocol",
              file=sys.stderr)
        return 2
    t0 = time.monotonic()
    diags, summaries = [], []
    for proto in protocols:
        try:
            models = machines.build(proto, bug=args.seed_bug)
        except ValueError as exc:
            print(f"hvd-model: {exc}", file=sys.stderr)
            return 2
        for model in models:
            remaining = None
            if args.budget_s is not None:
                remaining = max(0.5, args.budget_s
                                - (time.monotonic() - t0))
            result = explore(
                model, max_depth=args.depth,
                max_states=args.max_states, deadline_s=remaining,
                stop_on_first=not args.keep_going)
            diags.extend(result_diagnostics(model, result))
            summaries.append(
                f"{model.name}: {result.states} state(s), "
                f"{result.edges} edge(s), depth {result.depth}, "
                f"{'complete' if result.complete else 'INCOMPLETE'}, "
                f"{len(result.violations)} violation(s) in "
                f"{result.elapsed_s:.2f}s")

    if args.format == "json":
        print(json.dumps([d.to_dict() for d in diags], indent=1))
    elif args.format == "sarif":
        from .. import sarif
        sarif.write_sarif(None, diags, tool="hvd-model")
    else:
        from ..simulate import render_trace
        for d in diags:
            print(d.format())
            trace_text = render_trace(d)
            if trace_text:
                print(trace_text)
        for line in summaries:
            print(f"hvd-model: {line}")
        bug = f" [seeded bug: {args.seed_bug}]" if args.seed_bug else ""
        print(f"hvd-model: {len(diags)} finding(s) across "
              f"{len(summaries)} model(s){bug} in "
              f"{time.monotonic() - t0:.2f}s")

    if args.fail_on == "never" or not diags:
        return 0
    if args.fail_on == "error":
        return 1 if worst_severity(diags) == ERROR else 0
    return 1


if __name__ == "__main__":
    sys.exit(main())

"""``hvd-chaos``: validate and inspect chaos fault-injection specs (port of
``horovod_tpu/chaos/cli.py``).

    python -m horovod_tpu_torch.chaos.cli validate "kv_get:fail:n=3"
    python -m horovod_tpu_torch.chaos.cli validate   # $HVDTPU_CHAOS
    python -m horovod_tpu_torch.chaos.cli points     # points + actions

Exit codes: 0 valid (or nothing to validate with a warning), 2 invalid
spec or usage error — the same convention as hvd-lint. Meant for CI:
validate the spec a chaos job will run with BEFORE burning cluster time
on it (a malformed spec otherwise fails at the first injection point
inside the job).
"""

import argparse
import sys

from ..utils import envparse
from .spec import ACTIONS, POINTS, ChaosSpecError, parse_spec


def _build_parser():
    parser = argparse.ArgumentParser(
        prog="hvd-chaos",
        description="Validate and inspect HVDTPU_CHAOS fault-injection "
                    "specs (docs/fault_tolerance.md).")
    sub = parser.add_subparsers(dest="command")
    val = sub.add_parser("validate",
                         help="parse a spec and print the rule table")
    val.add_argument("spec", nargs="?", default=None,
                     help="spec text (default: $HVDTPU_CHAOS)")
    sub.add_parser("points",
                   help="list injection points and actions")
    return parser


def _cmd_validate(spec_text):
    if spec_text is None:
        spec_text = envparse.get_str(envparse.CHAOS, "")
    if not spec_text:
        print("hvd-chaos: no spec given and HVDTPU_CHAOS is unset; "
              "nothing to validate")
        return 0
    try:
        rules = parse_spec(spec_text)
    except ChaosSpecError as exc:
        print(f"hvd-chaos: invalid spec: {exc}", file=sys.stderr)
        return 2
    print(f"hvd-chaos: {len(rules)} rule(s)")
    for i, rule in enumerate(rules):
        print(f"  [{i}] {rule.describe()}")
    return 0


def _cmd_points():
    print("Injection points:")
    for point, where in sorted(POINTS.items()):
        print(f"  {point:15s} {where}")
    print("Actions:")
    for action, what in sorted(ACTIONS.items()):
        print(f"  {action:15s} {what}")
    return 0


def main(argv=None):
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.command == "points":
        return _cmd_points()
    # Default command is validate (so `hvd-chaos` alone checks the env).
    return _cmd_validate(getattr(args, "spec", None))


if __name__ == "__main__":
    sys.exit(main())

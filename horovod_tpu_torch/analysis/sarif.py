"""SARIF 2.1.0 emitter for hvd-lint findings (``--format sarif``; port of
``horovod_tpu/analysis/sarif.py``; the tool version is the port's
``version.py``).

One run object, one driver (``hvd-lint``), rule metadata pulled from
the shared catalog (diagnostics.RULES) for every rule that appears in
the output, one result per finding with a physical location and the
content-addressed baseline key as a partial fingerprint. Findings
suppressed by a ``--baseline`` file are still emitted — with a
``suppressions`` entry of kind ``external`` — so CI code-scanning UIs
show them as suppressed instead of silently losing them (that is the
SARIF-blessed way to ship warning-strength rules without a flag-day).

Spec: SARIF 2.1.0 (OASIS). The emitted document restricts itself to
required properties plus the widely-consumed optional ones
(``rules``, ``partialFingerprints``, ``suppressions``), so it loads in
GitHub code scanning and the VS Code SARIF viewer.
"""

import json
import sys

from .baseline import finding_keys
from .diagnostics import ERROR, RULES, relative_to_cwd

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")
_INFO_URI = "https://example.invalid/horovod_tpu/docs/lint.md"


def _tool_version():
    try:
        from ..version import __version__
        return str(__version__)
    except Exception:  # noqa: BLE001 — metadata only
        return "0.0.0"


def _level(severity):
    # SARIF level vocabulary: "error" | "warning" | "note" | "none"
    return "error" if severity == ERROR else "warning"


def _uri(path):
    """Relative forward-slash URI when the file sits under cwd (stable
    across checkouts — what baselines and CI artifacts want), the
    original path otherwise."""
    return relative_to_cwd(path, posix=True)


def _thread_flow_location(file, line, text):
    return {"location": {
        "physicalLocation": {
            "artifactLocation": {"uri": _uri(file)},
            "region": {"startLine": max(1, int(line or 0))},
        },
        "message": {"text": text},
    }}


def _code_flows(diag):
    """The simulator's counterexample trace as a SARIF
    ``codeFlows``/``threadFlows`` object — ONE threadFlow per symbolic
    rank, so code-scanning UIs render the interleaving that deadlocks:
    each rank's matched prefix, then its blocked/mismatched head (or
    exhaustion), then the fork points that split the paths."""
    trace = getattr(diag, "trace", None)
    if not trace:
        return None
    thread_flows = []
    for entry in trace.get("ranks", []):
        locations = []
        for ev in entry.get("events", []):
            name = f" name={ev['name']!r}" if ev.get("name") else ""
            locations.append(_thread_flow_location(
                ev["file"], ev["line"],
                f"rank {entry['rank']}: {ev['kind']}{name} "
                f"[{ev['status']}]"))
        if entry.get("end") == "exhausted":
            anchor = trace.get("forks") or [
                {"file": diag.file, "line": diag.line}]
            locations.append(_thread_flow_location(
                anchor[0]["file"], anchor[0]["line"],
                f"rank {entry['rank']}: schedule exhausted — "
                "submits nothing further"))
        if not locations:
            locations.append(_thread_flow_location(
                diag.file, diag.line,
                f"rank {entry['rank']}: no collective submissions"))
        thread_flows.append({"id": f"rank {entry['rank']}",
                             "locations": locations})
    if not thread_flows:
        return None
    flow = {"threadFlows": thread_flows}
    forks = trace.get("forks", [])
    if forks:
        flow["message"] = {"text": "schedules fork at " + "; ".join(
            f"{f['file']}:{f['line']} ({f['why']})" for f in forks)}
    return [flow]


def to_sarif(diags, suppressed=(), tool="hvd-lint"):
    """Build the SARIF 2.1.0 document for ``diags`` (new findings) plus
    ``suppressed`` (baseline-suppressed findings, emitted with a
    ``suppressions`` entry). ``tool`` names the driver — every emitter
    in the package (``hvd-lint``, the perf sweep, ``hvd-model``) routes
    through this one builder so the artifacts stay schema-identical.
    Returns a plain dict — ``json.dump`` it."""
    diags = list(diags)
    suppressed = list(suppressed)
    every = diags + suppressed
    rule_ids = sorted({d.rule for d in every})
    rule_index = {rule: i for i, rule in enumerate(rule_ids)}
    rules = []
    for rule in rule_ids:
        severity, title = RULES.get(rule, (ERROR, rule))
        rules.append({
            "id": rule,
            "name": rule,
            "shortDescription": {"text": title or rule},
            "helpUri": _INFO_URI,
            "defaultConfiguration": {"level": _level(severity)},
        })
    keys = finding_keys(every)
    results = []
    for d, key in zip(every, keys):
        message = d.message + (f" (hint: {d.hint})" if d.hint else "")
        result = {
            "ruleId": d.rule,
            "ruleIndex": rule_index[d.rule],
            "level": _level(d.severity),
            "message": {"text": message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": _uri(d.file)},
                    "region": {"startLine": max(1, int(d.line or 0))},
                },
            }],
            "partialFingerprints": {"hvdLintKey/v1": key},
        }
        code_flows = _code_flows(d)
        if code_flows:
            result["codeFlows"] = code_flows
        if len(results) >= len(diags):
            result["suppressions"] = [{
                "kind": "external",
                "justification": "recorded in the hvd-lint baseline "
                                 "(--baseline); fails only when new "
                                 "findings appear",
            }]
        results.append(result)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": tool,
                    "informationUri": _INFO_URI,
                    "version": _tool_version(),
                    "rules": rules,
                },
            },
            "results": results,
        }],
    }


def write_sarif(path, diags, suppressed=(), tool="hvd-lint"):
    """Serialize :func:`to_sarif` to ``path`` (``None``/``"-"`` means
    stdout) with the one canonical encoding every CI artifact uses
    (sorted keys, indent 1, trailing newline). Returns the document."""
    doc = to_sarif(diags, suppressed=suppressed, tool=tool)
    text = json.dumps(doc, indent=1, sort_keys=True) + "\n"
    if path in (None, "-"):
        sys.stdout.write(text)
    else:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(text)
    return doc


# -- artifact validation (python -m horovod_tpu_torch.analysis.sarif) ------------

def _results(doc):
    return [r for run in doc.get("runs", [])
            for r in run.get("results", [])]


def validate(doc, require_rules=(), require_families=(),
             require_flows=(), forbid_locations=(), expect_none=False):
    """Structural checks for one SARIF artifact; the list of failure
    messages (empty = pass). This is the single gate scripts/ci_lint.sh
    runs over every leg's artifact, replacing the per-leg ad-hoc
    canaries.

    - ``require_rules``: each named rule must appear among result
      ruleIds.
    - ``require_families``: each prefix (e.g. ``HVD5``) must match at
      least one result ruleId.
    - ``require_flows``: ``("RULE", n)`` pairs — every result of RULE
      must carry a codeFlow with at least n threadFlows.
    - ``forbid_locations``: no result location URI may contain the
      substring.
    - ``expect_none``: there must be no unsuppressed result at all.
    """
    problems = []
    if doc.get("version") != SARIF_VERSION:
        problems.append(f"version {doc.get('version')!r} != "
                        f"{SARIF_VERSION}")
    results = _results(doc)
    live = [r for r in results if not r.get("suppressions")]
    seen = {r.get("ruleId", "") for r in results}
    for rule in require_rules:
        if rule not in seen:
            problems.append(f"required rule {rule} missing "
                            f"(saw: {', '.join(sorted(seen)) or 'none'})")
    for family in require_families:
        if not any(rid.startswith(family) for rid in seen):
            problems.append(f"no result from family {family}*")
    for rule, min_flows in require_flows:
        for r in results:
            if r.get("ruleId") != rule:
                continue
            flows = r.get("codeFlows") or []
            n = len(flows[0].get("threadFlows", [])) if flows else 0
            if n < min_flows:
                problems.append(
                    f"{rule} result has {n} threadFlows < {min_flows}")
    for needle in forbid_locations:
        for r in results:
            for loc in r.get("locations", []):
                uri = (loc.get("physicalLocation", {})
                       .get("artifactLocation", {}).get("uri", ""))
                if needle in uri:
                    problems.append(
                        f"{r.get('ruleId')} hit forbidden location "
                        f"{uri} (contains {needle!r})")
    if expect_none and live:
        rids = sorted({r.get("ruleId", "") for r in live})
        problems.append(f"expected a clean artifact but found "
                        f"{len(live)} result(s): {', '.join(rids)}")
    return problems


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis.sarif",
        description="Validate a SARIF artifact's structure (the CI "
                    "gate shared by the hvd-lint, perf, and hvd-model "
                    "legs).")
    parser.add_argument("path", help="SARIF file to check")
    parser.add_argument("--require-rule", action="append", default=[],
                        metavar="RULE")
    parser.add_argument("--require-family", action="append",
                        default=[], metavar="PREFIX")
    parser.add_argument("--require-flows", action="append", default=[],
                        metavar="RULE:MIN",
                        help="every RULE result needs >= MIN "
                             "threadFlows")
    parser.add_argument("--forbid-location", action="append",
                        default=[], metavar="SUBSTRING")
    parser.add_argument("--expect-none", action="store_true",
                        help="fail on any unsuppressed result")
    args = parser.parse_args(argv)
    flows = []
    for spec in args.require_flows:
        rule, _, min_flows = spec.partition(":")
        if not min_flows.isdigit():
            parser.error(f"--require-flows wants RULE:MIN, got {spec!r}")
        flows.append((rule, int(min_flows)))
    try:
        with open(args.path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as exc:
        print(f"sarif-check: {args.path}: unreadable: {exc}",
              file=sys.stderr)
        return 2
    problems = validate(
        doc, require_rules=args.require_rule,
        require_families=args.require_family, require_flows=flows,
        forbid_locations=args.forbid_location,
        expect_none=args.expect_none)
    if problems:
        for p in problems:
            print(f"sarif-check: {args.path}: {p}", file=sys.stderr)
        return 1
    tool = (doc.get("runs") or [{}])[0].get("tool", {}) \
        .get("driver", {}).get("name", "?")
    print(f"sarif-check: {args.path} ok "
          f"({len(_results(doc))} result(s), tool {tool})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

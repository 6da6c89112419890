"""Baseline workflow: land warning-strength rules without a flag-day (port
of ``horovod_tpu/analysis/baseline.py``).

``hvd-lint --write-baseline lint-baseline.json <paths>`` records every
current finding; subsequent runs with ``--baseline lint-baseline.json``
fail only on NEW findings — the recorded ones are reported as
suppressed (and marked so in SARIF output) until the code they flag is
actually touched.

Findings are keyed by **rule x file x content-hash of the flagged
line x occurrence index**, NOT by line number: editing an unrelated
part of the file shifts line numbers but not content hashes, so the
baseline survives rebases; editing the flagged line itself invalidates
its key, so the finding resurfaces exactly when someone touches the
code it is about. The occurrence index disambiguates identical lines
(two copy-pasted ``hvd.allreduce(x)`` both stay individually tracked).

File format (JSON, versioned)::

    {"version": 1, "tool": "hvd-lint",
     "findings": {"<rule>:<file>:<hash>:<n>": {"rule": ..., "file": ...,
                                               "line": ..., "message": ...}}}

The ``line``/``message`` fields are display metadata for humans
reading the baseline diff in review; only the key participates in
matching.

``root`` (the port's addition, used by ``hvd-lint --self``) keys files
relative to that directory instead of the working directory.
"""

import hashlib
import json
import os

from .diagnostics import relative_to_cwd

_VERSION = 1


def _norm_file(path, root=None):
    """Stable relative form of a finding's file (baselines are
    committed, so keys must not embed the checkout prefix)."""
    if root is not None:
        rel = os.path.relpath(os.path.abspath(path), root)
        if not rel.startswith(".."):
            return rel.replace(os.sep, "/")
    return relative_to_cwd(path, posix=True)


def _line_content(cache, path, line):
    if path not in cache:
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                cache[path] = f.read().splitlines()
        except OSError:
            cache[path] = None
    lines = cache[path]
    if lines is None or not (1 <= line <= len(lines)):
        return f"<line {line}>"
    return lines[line - 1].strip()


def finding_keys(diags, root=None):
    """Content-addressed key per finding, parallel to ``diags``.
    Deterministic: equal inputs, equal keys, independent of order."""
    cache = {}
    occurrence = {}
    keys = []
    for d in sorted(diags, key=lambda d: (d.file, d.line, d.rule)):
        content = _line_content(cache, d.file, int(d.line or 0))
        digest = hashlib.sha1(
            f"{d.rule}:{content}".encode("utf-8",
                                         "replace")).hexdigest()[:16]
        stem = f"{d.rule}:{_norm_file(d.file, root)}:{digest}"
        n = occurrence.get(stem, 0)
        occurrence[stem] = n + 1
        keys.append((id(d), f"{stem}:{n}"))
    order = {ident: key for ident, key in keys}
    return [order[id(d)] for d in diags]


def write_baseline(diags, path, root=None):
    """Record ``diags`` as the accepted baseline at ``path``."""
    findings = {}
    for d, key in zip(diags, finding_keys(diags, root)):
        findings[key] = {
            "rule": d.rule, "file": _norm_file(d.file, root),
            "line": int(d.line or 0), "message": d.message,
        }
    doc = {"version": _VERSION, "tool": "hvd-lint",
           "findings": dict(sorted(findings.items()))}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return doc


def load_baseline(path):
    """Parsed baseline dict, or raise OSError/ValueError with a usable
    message (a corrupt baseline must fail loudly, not pass silently)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "findings" not in doc:
        raise ValueError(f"{path}: not an hvd-lint baseline "
                         "(missing 'findings')")
    if doc.get("version") != _VERSION:
        raise ValueError(f"{path}: baseline version "
                         f"{doc.get('version')!r} unsupported "
                         f"(expected {_VERSION})")
    return doc


def filter_new(diags, baseline_doc, root=None):
    """Split ``diags`` into (new, suppressed) against a loaded
    baseline. A key present in the baseline absorbs one finding per
    recorded occurrence — content changes resurface findings because
    the hash no longer matches."""
    known = set(baseline_doc.get("findings", {}))
    new, suppressed = [], []
    for d, key in zip(diags, finding_keys(diags, root)):
        (suppressed if key in known else new).append(d)
    return new, suppressed

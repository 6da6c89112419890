"""``hvd-lint explain``: postmortem bundle → first divergent slot →
source line (port of ``horovod_tpu/analysis/explain.py``).

The flight recorder (tracing/recorder.py) leaves a per-rank postmortem
bundle on every coordinated abort: the last N trace records of every
live rank. This module closes the feedback loop the simulator opens at
lint time — it aligns the bundle's *runtime* per-rank submission
(``sub``) / completion (``fin``) sequences against the *statically
extracted* schedule of the program that produced them, finds the first
slot where the cohort diverged, and maps it back to the exact source
line (f-string collective names like ``f"step{epoch}"`` are matched
through the patterns the schedule extractor records).

Divergence taxonomy (mirrors the simulator's rule family):

- ``missing_submission`` → **HVD501**: some rank(s) never submitted a
  slot the others are waiting in — the runtime incarnation of a proven
  schedule fork (the guardian's "never submitted by rank(s) …" abort).
- ``field_mismatch`` → **HVD502**: every rank submitted the slot but
  with diverging collective kinds — the digest-mismatch abort.
- ``never_finished`` → **HVD503**: every rank submitted compatibly and
  the collective still never completed — a runtime stall
  (backend/network/chaos), not a schedule divergence; static analysis
  cannot prove more, so it stays a "possible hang" diagnosis.

Consumes :func:`horovod_tpu_torch.tracing.merge.load_paths` /
:func:`bundle_by_rank` — one loader for every forensic consumer.
Pure stdlib + tracing.merge — no torch or jax imports.
"""

import json
import os
import re

from .diagnostics import RULES, relative_to_cwd
from .schedule import Verifier
from .ast_lint import iter_python_files

#: how many trailing runtime events to show per rank in the report
_TAIL_EVENTS = 6


class ExplainError(ValueError):
    """Unusable bundle (no postmortem shards / no events)."""


def _load_bundle(bundle_dir):
    from ..tracing import merge
    shards = merge.load_paths([bundle_dir],
                              kinds=(merge.POSTMORTEM_PREFIX,))
    version, by_rank = merge.bundle_by_rank(shards)
    if not by_rank:
        raise ExplainError(
            f"no postmortem shards (postmortem.*.jsonl) under "
            f"{bundle_dir} — postmortems are dumped by the flight "
            "recorder on guardian aborts (docs/fault_tolerance.md)")
    return version, by_rank


def _rank_sequences(by_rank):
    """Per rank: ordered submissions + completion set, clock-aligned
    (meta ``off`` subtracted, the same alignment the trace merger
    applies)."""
    seqs = {}
    for rank, shard in sorted(by_rank.items()):
        off = shard["meta"].get("off") or 0.0
        subs, fins = [], set()
        for rec in shard["events"]:
            e = rec.get("e")
            if e == "sub":
                subs.append({"name": rec.get("n"),
                             "occ": rec.get("o", 0),
                             "kind": rec.get("k"),
                             "t": (rec.get("t") or 0.0) - off})
            elif e == "fin":
                fins.add((rec.get("n"), rec.get("o", 0)))
        seqs[rank] = {"subs": subs, "fins": fins}
    return seqs


def _find_divergence(seqs):
    """The first slot (name × occurrence) the cohort disagreed on,
    ordered by earliest aligned submit time. Returns None when every
    observed slot is fully submitted, compatible, and finished."""
    ranks = sorted(seqs)
    slots = {}
    for rank in ranks:
        for sub in seqs[rank]["subs"]:
            slot = slots.setdefault((sub["name"], sub["occ"]), {})
            slot[rank] = sub
    out = []
    for (name, occ), per_rank in slots.items():
        t0 = min(s["t"] for s in per_rank.values())
        # A rank whose sub record fell off the bounded flight ring but
        # whose fin record survived DID submit the slot (a completion
        # proves the submission) — window eviction, not divergence.
        missing = [r for r in ranks
                   if r not in per_rank
                   and (name, occ) not in seqs[r]["fins"]]
        kinds = {s["kind"] for s in per_rank.values()
                 if s["kind"] is not None}
        unfinished = [r for r in per_rank
                      if (name, occ) not in seqs[r]["fins"]]
        if missing:
            out.append((t0, "missing_submission", name, occ,
                        per_rank, missing))
        elif len(kinds) > 1:
            out.append((t0, "field_mismatch", name, occ, per_rank,
                        []))
        elif unfinished:
            out.append((t0, "never_finished", name, occ, per_rank,
                        unfinished))
    if not out:
        return None
    t0, dtype, name, occ, per_rank, involved = min(
        out, key=lambda item: item[0])
    return {"type": dtype, "name": name, "occurrence": occ,
            "submitted": per_rank, "involved": involved, "t": t0}


_RULE_FOR = {"missing_submission": "HVD501",
             "field_mismatch": "HVD502",
             "never_finished": "HVD503"}


def _static_sources(program_paths):
    """Extract the program's schedule events: ``(name -> sites)`` for
    constant names plus a list of ``(regex, site)`` for f-string
    names. A site is ``{file, line, kind, context}``."""
    verifier = Verifier()
    loaded = False
    for path in iter_python_files(program_paths):
        if verifier.add_path(path) is not None:
            loaded = True
    if program_paths and not loaded:
        raise ExplainError(
            "no analyzable .py file under --program path(s): "
            + ", ".join(map(str, program_paths)))
    verifier._fixpoint()
    exact, patterns = {}, []
    for mod_path in sorted(verifier.corpus.modules):
        mod = verifier.corpus.modules[mod_path]
        for qual in sorted(mod.funcs):
            fn = mod.funcs[qual]
            for ev in fn.events:
                site = {"file": relative_to_cwd(mod.path),
                        "line": ev.line, "kind": ev.kind,
                        "function": qual,
                        "context": [fr.describe() for fr in ev.ctx]}
                if ev.name is not None:
                    exact.setdefault(ev.name, []).append(site)
                elif ev.pattern is not None:
                    try:
                        patterns.append((re.compile(ev.pattern),
                                         site))
                    except re.error:
                        continue
    return exact, patterns


def _locate(name, kind, exact, patterns):
    """Source site(s) for a runtime collective name: exact ``name=``
    constants first, then f-string patterns; sites whose static kind
    matches the runtime kind are preferred."""
    candidates = list(exact.get(name, []))
    if not candidates and name is not None:
        candidates = [site for rx, site in patterns
                      if rx.fullmatch(name)]
    if kind:
        matching = [s for s in candidates if s["kind"] == kind]
        if matching:
            candidates = matching
    return candidates


def _check_programs(program_paths):
    """A named program path that does not exist is an
    :class:`ExplainError` — a typo'd ``--program`` must not silently
    degrade to 'no source mapping', even on a bundle with no
    divergence to map."""
    for p in program_paths:
        if not os.path.exists(p):
            raise ExplainError(f"program path not found: {p}")


def explain_bundle(bundle_dir, program_paths=()):
    """Analyze a postmortem bundle; returns the report dict. Raises
    :class:`ExplainError` when the directory holds no usable bundle
    or a ``program_paths`` entry does not exist."""
    _check_programs(program_paths)
    version, by_rank = _load_bundle(bundle_dir)
    seqs = _rank_sequences(by_rank)
    ranks = sorted(seqs)
    report = {
        "bundle": bundle_dir,
        "version": version,
        "ranks": ranks,
        "world_size": by_rank[ranks[0]]["meta"].get("size"),
        "reason": by_rank[ranks[0]]["meta"].get("reason"),
        "slots_observed": len({(s["name"], s["occ"])
                               for r in ranks
                               for s in seqs[r]["subs"]}),
        "tail": {r: seqs[r]["subs"][-_TAIL_EVENTS:] for r in ranks},
        "divergence": None,
    }
    div = _find_divergence(seqs)
    if div is None:
        return report
    rule = _RULE_FOR[div["type"]]
    entry = {
        "type": div["type"],
        "rule": rule,
        "rule_title": RULES[rule][1],
        "name": div["name"],
        "occurrence": div["occurrence"],
        "submitted_by": sorted(div["submitted"]),
        "involved_ranks": div["involved"],
        "sources": [],
    }
    kinds = {s["kind"] for s in div["submitted"].values()
             if s["kind"] is not None}
    entry["kinds"] = sorted(kinds)
    if program_paths:
        exact, patterns = _static_sources(program_paths)
        kind = next(iter(kinds)) if len(kinds) == 1 else None
        entry["sources"] = _locate(div["name"], kind, exact, patterns)
    report["divergence"] = entry
    return report


def render_report(report):
    """Human-readable explanation (the ``hvd-lint explain`` output)."""
    lines = [
        f"hvd-lint explain: postmortem bundle {report['bundle']}",
        f"  ranks: {report['ranks']} (world size "
        f"{report['world_size']}, elastic version {report['version']},"
        f" abort reason: {report['reason']})",
        f"  slots observed: {report['slots_observed']}",
    ]
    div = report["divergence"]
    if div is None:
        lines.append(
            "  no divergent slot: every observed collective was "
            "submitted by every rank, compatibly, and completed — "
            "the abort cause is outside the recorded window")
        return "\n".join(lines)
    slot = f"`{div['name']}` occurrence {div['occurrence']}"
    lines.append(f"  first divergent slot: {slot}")
    if div["type"] == "missing_submission":
        lines.append(
            f"    submitted by rank(s) {div['submitted_by']}; NEVER "
            f"submitted by rank(s) {div['involved_ranks']}")
    elif div["type"] == "field_mismatch":
        lines.append(
            f"    every rank submitted it, but kinds diverge: "
            f"{div['kinds']}")
    else:
        lines.append(
            f"    every rank submitted it compatibly; rank(s) "
            f"{div['involved_ranks']} never saw it finish (runtime "
            "stall, not a schedule divergence)")
    lines.append(f"  diagnosis: {div['rule']} — {div['rule_title']}")
    if div["sources"]:
        for site in div["sources"][:3]:
            ctx = ("; context: " + ", ".join(site["context"])
                   if site["context"] else "")
            lines.append(
                f"  source: {site['file']}:{site['line']} "
                f"`{site['kind']}` in {site['function']}{ctx}")
    else:
        lines.append(
            "  source: pass --program <train.py> to map the slot "
            "back to the submitting call site")
    return "\n".join(lines)


def to_json(report):
    return json.dumps(report, indent=1, sort_keys=True, default=str)

"""Symbolic N-rank schedule simulator — proven HVD5xx findings (port of
``horovod_tpu/analysis/simulate.py``).

The HVD4xx verifier (schedule.py) flags divergence *heuristically*: it
pattern-matches guard shapes (rank-tainted branches, divergent loop
bounds) without asking whether the resulting per-rank schedules could
still reconcile. This layer answers that question by **executing** the
extracted schedules: it instantiates symbolic cohorts, forks the
per-rank event streams at every rank-tainted decision, and runs them
through a lockstep matching semantics that mirrors the coordinator's
negotiation — an event completes only when every member of its process
set has submitted a compatible head ``(kind, name, process_set, op)``.
What cannot reconcile is a **proven** finding with a counterexample:

- **HVD501** — proven deadlock: the symbolic ranks' heads are
  irreconcilable (different slots, or a rank's schedule is exhausted
  while peers still wait). Emitted with a full per-rank counterexample
  trace: each rank's event list up to the hang point with source
  locations, plus the taint chain (fork points) that split the paths.
- **HVD502** — proven digest mismatch: the heads *match* as a
  negotiation slot (same name / same call site) but diverge in a
  statically-computable field (kind or op) — exactly what the runtime
  guardian's digest compare aborts on (``CollectiveMismatchError``
  foretold at lint time).
- **HVD503** — possible hang: bounded exploration (scenario caps,
  inline depth, loop widening, data-dependent trip counts) forced an
  approximation, so divergence could neither be proven nor refuted.
  Proven findings are errors; approximations stay warnings.

Symbolic cohorts: ``any n >= 2`` (rank ``r`` vs. ``rest`` — the
abstraction that generalizes a counterexample to every world size,
and subsumes a concrete n=2 run, which would be byte-identical up to
labels), plus concrete ``n=3`` (three ranks are what expose three-way
forks such as ``if rank()==0 … elif rank()==1 …``).

Semantics and deliberate approximations (docs/lint.md "Simulator
semantics"):

- Only **rank-tainted** decisions fork the cohort; replica-invariant
  branches move every rank together (both arms are still explored).
  ``split`` assigns the first symbolic rank to reach the branch to the
  ``then`` arm and the rest to ``else``.
- **Non-global process sets complete immediately**: their membership is
  statically unknown, so divergence involving them stays HVD404's
  heuristic territory, and member-only guarded collectives
  (``if ps.included(): allreduce(..., process_set=ps)``) are exempt by
  construction.
- **Unnamed collectives** match when their kinds agree: fixed-name ops
  (barrier, the object/state broadcasts) really do negotiate one
  internal name, and auto-named call sites are HVD203's business — the
  simulator never *proves* anything about a name it cannot compute.
  f-string names likewise make a slot unprovable and it is skipped.
- **Exception handlers** are never executed; a tainted argument
  steering a callee's *parameter* guard is not forked (that shape stays
  HVD401's); recursion and inline depth are capped.

Rule ownership (mirrors the 201-vs-401 contract): a proven HVD501/502
supersedes the heuristic HVD401/HVD402/HVD404 finding on the same
event — one report per defect, the proven one. HVD503 is only emitted
where no heuristic already covers the shape. A ``# hvd-lint:
disable=HVD40x`` suppression on the superseded heuristic carries over:
the human already waived that exact divergence.

Pure stdlib — no jax imports.
"""

import itertools
import os

from .ast_lint import iter_python_files
from .diagnostics import Diagnostic, dedupe, relative_to_cwd
from .schedule import Verifier, _suppress

_DOC_HINT = "see docs/lint.md"

#: scenario budget per (function, cohort): the cartesian product of
#: branch/loop choices is cut here; hitting the cap flags approximation
_MAX_SCENARIOS = 96
_MAX_INLINE_DEPTH = 4
#: per-rank stream cap (runaway loop x inline guard)
_MAX_RANK_EVENTS = 200
#: trace events kept per rank in the emitted counterexample
_TRACE_EVENTS = 20

#: (cohort label, symbolic rank labels). Order matters: findings are
#: deduped first-wins, so the any-n abstraction (whose counterexample
#: generalizes to every world size) takes precedence. A concrete
#: ``n=2`` cohort would be byte-identical to the two-symbolic-rank
#: any-n run (the matcher only sees labels), so it is subsumed rather
#: than simulated twice; ``n=3`` is what reaches the deepest arm of a
#: three-way ``elif`` fork.
COHORTS = (
    ("any n >= 2", ("r", "rest")),
    ("n=3", ("0", "1", "2")),
)

_SUPERSEDED_RULES = frozenset({"HVD401", "HVD402", "HVD404"})


class _Return(Exception):
    pass


class _Raise(Exception):
    pass


class _Break(Exception):
    pass


class _Cont(Exception):
    pass


class _Trunc(Exception):
    pass


class SimEvent:
    """One symbolic collective submission in a generated stream."""

    __slots__ = ("kind", "name", "pattern", "pset", "op", "file",
                 "line")

    def __init__(self, ev, path):
        self.kind = ev.kind
        self.name = ev.name
        self.pattern = ev.pattern
        self.pset = ev.pset
        self.op = ev.op
        self.file = path
        self.line = ev.line

    def slot(self):
        """Negotiation-slot key: explicit names key the slot; unnamed
        events key by kind (fixed-name ops match across call sites,
        auto-named hazards are HVD203's, not provable here)."""
        if self.name is not None:
            return ("n", self.name)
        return ("u", self.kind)

    def describe(self):
        out = f"`{self.kind}`"
        if self.name is not None:
            out += f"(name={self.name!r})"
        elif self.pattern is not None:
            out += f"(name~/{self.pattern}/)"
        if self.op is not None:
            out += f" op={self.op}"
        return out


class _Decision:
    __slots__ = ("key", "choices", "tainted", "line", "file", "loop")

    def __init__(self, key, choices, tainted, line, file, loop):
        self.key = key
        self.choices = choices
        self.tainted = tainted
        self.line = line
        self.file = file
        self.loop = loop


def _body_divergent(prog):
    """Does this loop body contain a rank-tainted fork point? (Such
    loops are widened to two base iterations so a divergent first
    iteration can desynchronize against a second.)"""
    for node in prog:
        tag = node[0]
        if tag == "br":
            if node[1].tainted or _body_divergent(node[2]) \
                    or _body_divergent(node[3]):
                return True
        elif tag == "loop":
            if node[1].frame.tainted or _body_divergent(node[2]):
                return True
        elif tag == "exit":
            if any(f.tainted for f in node[1].ctx):
                return True
    return False


def _loop_data_dependent(loop):
    return loop.kind == "while" and any(
        cls == "call" for cls in loop.body_assigns.values())


class _Survey:
    """Static pre-pass over one entry function (inlined callees
    included): collects the ordered **rank-tainted** decision points
    (the only ones that can fork the cohort — replica-invariant
    branches move every rank together and are swept with uniform
    all-then/all-else patterns instead of being enumerated), whether
    any collective event is reachable, and the approximation flags."""

    def __init__(self, fn):
        self.decisions = []           # tainted decisions only
        self._seen = set()
        self.has_events = False
        self.approx = []              # list of reason strings
        self.tainted_lines = set()    # (file, line) of fork points
        self._walk(fn.program, fn.module.path, 0, frozenset({fn}))

    def _walk(self, prog, path, depth, stack):
        for node in prog:
            tag = node[0]
            if tag == "ev":
                self.has_events = True
            elif tag == "call":
                callee = node[1].callee
                if not callee.has_coll_trans:
                    continue
                if depth >= _MAX_INLINE_DEPTH or callee in stack:
                    self.approx.append(
                        f"call to {callee.qualname} not inlined "
                        "(depth/recursion cap)")
                    continue
                self._walk(callee.program, callee.module.path,
                           depth + 1, stack | {callee})
            elif tag == "br":
                frame = node[1]
                if id(node) not in self._seen:
                    self._seen.add(id(node))
                    if frame.tainted:
                        self.decisions.append(_Decision(
                            id(node), ("split", "then", "else"), True,
                            frame.line, path, loop=False))
                        self.tainted_lines.add((path, frame.line))
                self._walk(node[2], path, depth, stack)
                self._walk(node[3], path, depth, stack)
            elif tag == "loop":
                loop = node[1]
                if id(node) not in self._seen:
                    self._seen.add(id(node))
                    if loop.frame.tainted:
                        self.decisions.append(_Decision(
                            id(node), ("split", "uniform"), True,
                            loop.line, path, loop=True))
                        self.tainted_lines.add((path, loop.line))
                    elif _loop_data_dependent(loop):
                        # each rank's own data picks the trip count —
                        # real divergence, but not statically
                        # enumerable: approximation (HVD402 owns the
                        # heuristic diagnosis)
                        self.approx.append(
                            f"data-dependent `while` trip count at "
                            f"{relative_to_cwd(path)}:{loop.line}")
                        self.tainted_lines.add((path, loop.line))
                self._walk(node[2], path, depth, stack)
            elif tag == "exit":
                if any(f.tainted for f in node[1].ctx):
                    self.tainted_lines.add((path, node[1].line))
            # "opt" (exception handlers): never simulated


class _RankRun:
    """Generate one symbolic rank's event stream for one scenario.

    ``choice`` assigns the tainted decisions; every replica-invariant
    branch takes ``clean_arm`` uniformly (both sweeps are run per
    scenario), and clean loops always run their widened base count."""

    def __init__(self, rank_i, choice, clean_arm, first_reach, forks):
        self.rank_i = rank_i
        self.choice = choice          # tainted decision key -> choice
        self.clean_arm = clean_arm    # "then" | "else"
        self.first_reach = first_reach  # decision key -> rank index
        self.forks = forks            # (path, line) -> fork dict
        self.out = []
        self.truncated = False

    def run(self, fn):
        try:
            self._block(fn.program, fn.module.path, 0, frozenset({fn}))
        except (_Return, _Raise):
            pass
        except _Trunc:
            self.truncated = True
        return self.out

    def _fork(self, path, frame, loop=False):
        key = (path, frame.line)
        if key in self.forks:
            return
        if loop:
            why = (f"`{frame.kind}` loop trip count is rank-tainted — "
                   "ranks iterate different numbers of times")
        elif frame.direct:
            why = ("condition tests rank()/membership directly — "
                   "arms differ per rank")
        else:
            why = ("condition is rank-tainted through data flow (a "
                   "variable or return value derived from rank()) — "
                   "arms can differ per rank")
        self.forks[key] = {"file": path, "line": frame.line,
                           "why": why}

    def _exit_fork(self, path, exit_):
        key = (path, exit_.line)
        if key not in self.forks:
            self.forks[key] = {
                "file": path, "line": exit_.line,
                "why": f"rank-gated `{exit_.kind}` ends this rank's "
                       "schedule early"}

    def _block(self, prog, path, depth, stack):
        for node in prog:
            tag = node[0]
            if tag == "ev":
                if len(self.out) >= _MAX_RANK_EVENTS:
                    raise _Trunc
                self.out.append(SimEvent(node[1], path))
            elif tag == "call":
                callee = node[1].callee
                if not callee.has_coll_trans:
                    continue
                if depth >= _MAX_INLINE_DEPTH or callee in stack:
                    continue  # surveyed as approximation already
                try:
                    self._block(callee.program, callee.module.path,
                                depth + 1, stack | {callee})
                except _Return:
                    pass
            elif tag == "br":
                frame, then_prog, else_prog = node[1], node[2], node[3]
                c = self.choice.get(id(node), self.clean_arm)
                if c == "split":
                    first = self.first_reach.setdefault(id(node),
                                                        self.rank_i)
                    arm = then_prog if self.rank_i == first \
                        else else_prog
                    self._fork(path, frame)
                else:
                    arm = then_prog if c == "then" else else_prog
                self._block(arm, path, depth, stack)
            elif tag == "loop":
                loop, body = node[1], node[2]
                c = self.choice.get(id(node), "uniform")
                iters = 2 if _body_divergent(body) else 1
                if c == "split":
                    first = self.first_reach.setdefault(id(node),
                                                        self.rank_i)
                    if self.rank_i == first:
                        iters += 1
                    self._fork(path, loop.frame, loop=True)
                for _ in range(iters):
                    try:
                        self._block(body, path, depth, stack)
                    except _Break:
                        break
                    except _Cont:
                        continue
            elif tag == "exit":
                exit_ = node[1]
                if any(f.tainted for f in exit_.ctx):
                    self._exit_fork(path, exit_)
                if exit_.kind == "return":
                    raise _Return
                if exit_.kind == "raise":
                    raise _Raise
                if exit_.kind == "continue":
                    raise _Cont
                raise _Break
            # "opt": exception handlers are never executed


def _gen_streams(fn, ranks, choice, clean_arm):
    """Per-rank streams for one scenario. Returns
    ``(streams, forks, truncated)``."""
    first_reach, forks = {}, {}
    streams, truncated = {}, False
    for i, label in enumerate(ranks):
        run = _RankRun(i, choice, clean_arm, first_reach, forks)
        streams[label] = run.run(fn)
        truncated = truncated or run.truncated
    return streams, list(forks.values()), truncated


# -- lockstep matcher -------------------------------------------------------
def _lockstep(streams, ranks):
    """Run the per-rank streams through the coordinator's matching
    semantics. Returns ``None`` (schedules reconcile) or a finding
    descriptor dict."""
    idx = {r: 0 for r in ranks}
    matched = {r: [] for r in ranks}

    def head(r):
        s = streams[r]
        return s[idx[r]] if idx[r] < len(s) else None

    while True:
        live = {r: h for r in ranks
                for h in (head(r),) if h is not None}
        if not live:
            return None
        # Non-global process sets: membership statically unknown —
        # complete immediately (divergence there stays HVD404's).
        progressed = False
        for r, h in list(live.items()):
            if h.pset != "global":
                matched[r].append((h, "matched"))
                idx[r] += 1
                progressed = True
        if progressed:
            continue
        if len(live) < len(ranks):
            return {"type": "deadlock", "blocked": live,
                    "matched": matched}
        # Every rank's head is a global collective: one negotiation
        # slot must cover them all.
        heads = list(live.values())
        if any(h.pattern is not None for h in heads):
            # f-string names: the slot is not statically computable —
            # assume it matches (never *prove* from an unknown name)
            for r, h in live.items():
                matched[r].append((h, "matched"))
                idx[r] += 1
            continue
        slots = {h.slot() for h in heads}
        if len(slots) > 1:
            # Distinct slots never negotiate together: different
            # explicit names, an explicit name racing an unnamed op
            # (whose fixed/auto internal name cannot equal it), or
            # unnamed ops of different kinds (fixed names differ, and
            # per-call-site auto names carry the kind). Proven hang.
            return {"type": "deadlock", "blocked": live,
                    "matched": matched}
        # One slot. Statically-computable field compatibility: the
        # guardian digest compares kind/op (incl. the Adasum fence —
        # Sum vs Adasum on one slot is a digest abort).
        kinds = {h.kind for h in heads}
        ops = {h.op for h in heads if h.op is not None}
        if len(kinds) > 1:
            return {"type": "mismatch", "field": "kind",
                    "blocked": live, "matched": matched}
        if len(ops) > 1:
            return {"type": "mismatch", "field": "op",
                    "blocked": live, "matched": matched}
        for r, h in live.items():
            matched[r].append((h, "matched"))
            idx[r] += 1


# -- finding construction ---------------------------------------------------
def _rel(path):
    return relative_to_cwd(path)


def _trace_event(ev, status):
    return {"kind": ev.kind, "name": ev.name,
            "file": _rel(ev.file), "line": ev.line, "status": status}


def _build_trace(cohort, ranks, result, forks):
    trace = {"cohort": cohort, "ranks": [], "forks": [
        {"file": _rel(f["file"]), "line": f["line"], "why": f["why"]}
        for f in sorted(forks, key=lambda f: (f["file"], f["line"]))]}
    blocked = result["blocked"]
    blocked_status = ("mismatched" if result["type"] == "mismatch"
                      else "blocked")
    for r in ranks:
        events = [_trace_event(e, status)
                  for e, status in result["matched"][r]]
        dropped = 0
        if len(events) > _TRACE_EVENTS:
            dropped = len(events) - _TRACE_EVENTS
            events = events[-_TRACE_EVENTS:]
        if r in blocked:
            events.append(_trace_event(blocked[r], blocked_status))
        entry = {"rank": r,
                 "end": blocked_status if r in blocked
                 else "exhausted",
                 "events": events}
        if dropped:
            entry["dropped"] = dropped
        trace["ranks"].append(entry)
    return trace


def _covered_lines(result, forks):
    lines = {(f["file"], f["line"]) for f in forks}
    for h in result["blocked"].values():
        lines.add((h.file, h.line))
    return lines


def _fork_summary(forks):
    if not forks:
        return "program entry"
    return ", ".join(
        f"{_rel(f['file'])}:{f['line']}"
        for f in sorted(forks, key=lambda f: (f["file"], f["line"])))


def _make_finding(fn, cohort, ranks, result, forks):
    blocked = result["blocked"]
    anchor = next(blocked[r] for r in ranks if r in blocked)
    trace = _build_trace(cohort, ranks, result, forks)
    if result["type"] == "deadlock":
        states = []
        for r in ranks:
            if r in blocked:
                h = blocked[r]
                states.append(f"rank {r} blocks at {h.describe()} "
                              f"({_rel(h.file)}:{h.line})")
            else:
                states.append(f"rank {r} exhausts its schedule and "
                              "never submits it")
        diag = Diagnostic.make(
            "HVD501",
            f"proven deadlock (cohort {cohort}): the per-rank "
            "schedules are irreconcilable — "
            + "; ".join(states)
            + f". Schedules fork at {_fork_summary(forks)}; "
            "counterexample trace attached",
            file=anchor.file, line=anchor.line,
            hint="every rank must submit the same collective "
                 "sequence: hoist collectives out of rank-dependent "
                 "paths, or make the gating value replica-invariant "
                 "(allreduce the flag first); " + _DOC_HINT,
            trace=trace)
    else:
        field = result["field"]
        values = ", ".join(
            f"rank {r}: {blocked[r].kind if field == 'kind' else blocked[r].op}"
            f" ({_rel(blocked[r].file)}:{blocked[r].line})"
            for r in ranks if r in blocked)
        diag = Diagnostic.make(
            "HVD502",
            f"proven digest mismatch (cohort {cohort}): matched "
            f"collective slot {anchor.describe()} diverges on "
            f"`{field}` across ranks — {values}. The runtime "
            "guardian digest compare aborts exactly here "
            "(CollectiveMismatchError foretold at lint time)",
            file=anchor.file, line=anchor.line,
            hint="every rank must submit identical collective "
                 "metadata for one named slot — align the op/kind "
                 "across the diverging paths; " + _DOC_HINT,
            trace=trace)
    diag._covered = _covered_lines(result, forks)
    return diag


# -- per-function driver ----------------------------------------------------
def _scenarios(decisions):
    """Choice assignments for the tainted decisions. Full cartesian
    product while it fits the budget; past the cap, a **linear
    fallback** explores each fork point independently (that decision
    split, the others held uniform) plus the everything-splits case —
    deadlocks overwhelmingly manifest from a single fork, so the
    fallback stays sound for what it proves and is simply silent on
    exotic multi-fork interactions (documented approximation)."""
    total = 1
    for d in decisions:
        total *= len(d.choices)
    if total <= _MAX_SCENARIOS:
        return [
            {d.key: c for d, c in zip(decisions, combo)}
            for combo in itertools.product(
                *[d.choices for d in decisions])]

    def uniform(arm):
        return {d.key: ("uniform" if d.loop else arm)
                for d in decisions}

    out = [{d.key: "split" for d in decisions}]
    for d in decisions:
        for arm in ("then", "else"):
            sc = uniform(arm)
            sc[d.key] = "split"
            out.append(sc)
    return out[:_MAX_SCENARIOS]


def _simulate_function(fn, seen, findings, approx_notes):
    if not fn.program:
        return
    survey = _Survey(fn)
    if not survey.has_events:
        return
    tainted = [d for d in survey.decisions if d.tainted]
    data_dep = any("data-dependent" in a for a in survey.approx)
    if not tainted and not data_dep:
        # no rank-tainted fork point: every rank runs the identical
        # schedule — reconciles trivially, nothing to explore
        return
    truncated_any = False
    proven_here = False
    if tainted:
        scenarios = _scenarios(survey.decisions)
        for choice in scenarios:
            for cohort, ranks in COHORTS:
                for clean_arm in ("then", "else"):
                    streams, forks, truncated = _gen_streams(
                        fn, ranks, choice, clean_arm)
                    truncated_any = truncated_any or truncated
                    result = _lockstep(streams, ranks)
                    if result is None:
                        continue
                    if truncated and any(r not in result["blocked"]
                                         for r in ranks):
                        # a rank "exhausted" by the event cap is not
                        # a proven exhaustion — approximation only
                        continue
                    diag = _make_finding(fn, cohort, ranks, result,
                                         forks)
                    key = (diag.rule, diag.file, diag.line)
                    if key not in seen:
                        seen.add(key)
                        findings.append(diag)
                    proven_here = True
    if proven_here:
        return
    if truncated_any or survey.approx:
        reasons = []
        if truncated_any:
            reasons.append("event cap")
        reasons.extend(survey.approx[:2])
        anchor = min(survey.tainted_lines) if survey.tainted_lines \
            else (fn.module.path, getattr(fn.node, "lineno", 1) or 1)
        approx_notes.append({
            "fn": fn.qualname,
            "file": anchor[0],
            "line": anchor[1],
            "covered": set(survey.tainted_lines) | {anchor},
            "reason": "; ".join(reasons),
        })


def simulate_verifier(verifier):
    """Run the simulator over every function of an already-fixpointed
    :class:`Verifier`'s corpus. Returns ``(proven_diags,
    approx_notes)`` — both pre-suppression; :func:`combine` applies
    ownership and suppression."""
    seen, findings, approx_notes = set(), [], []
    for path in sorted(verifier.corpus.modules):
        mod = verifier.corpus.modules[path]
        for qual in sorted(mod.funcs):
            _simulate_function(mod.funcs[qual], seen, findings,
                               approx_notes)
    return findings, approx_notes


# -- ownership + assembly ---------------------------------------------------
def combine(heur_raw, proven_raw, approx_notes, corpus):
    """Assemble the final ``hvd-lint verify`` finding stream:

    1. standard suppression comments on both layers;
    2. a suppressed heuristic HVD4xx carries over to the proven
       finding covering the same lines (the human waived that exact
       divergence);
    3. a surviving proven HVD501/502 supersedes the heuristic
       HVD401/402/404 on the same event (no double reports);
    4. HVD503 approximation warnings are emitted only where no
       heuristic or proven finding already covers the shape.
    """
    heur_kept = _suppress(heur_raw, corpus)
    kept_ids = {id(d) for d in heur_kept}
    suppressed_lines = {(d.file, d.line) for d in heur_raw
                        if id(d) not in kept_ids}

    proven = _suppress(proven_raw, corpus)
    proven = [d for d in proven
              if not (getattr(d, "_covered", set()) & suppressed_lines)
              and (d.file, d.line) not in suppressed_lines]

    covered = set()
    for d in proven:
        covered |= getattr(d, "_covered", set())
        covered.add((d.file, d.line))
    heur_final = [d for d in heur_kept
                  if not (d.rule in _SUPERSEDED_RULES
                          and (d.file, d.line) in covered)]

    heur_lines = {(d.file, d.line) for d in heur_kept
                  if d.rule.startswith("HVD4")}
    blocked = covered | heur_lines | suppressed_lines
    approx = []
    for note in approx_notes:
        if note["covered"] & blocked:
            continue
        approx.append(Diagnostic.make(
            "HVD503",
            f"possible hang in {note['fn']}: bounded simulation "
            f"({note['reason']}) could neither prove nor refute "
            "schedule divergence under rank-tainted control flow",
            file=note["file"], line=note["line"],
            hint="restructure toward a statically-checkable schedule "
                 "(replica-invariant bounds, fewer rank-dependent "
                 "paths), or suppress with a rationale; " + _DOC_HINT))
    approx = _suppress(approx, corpus)

    return dedupe(sorted(heur_final + proven + approx,
                         key=Diagnostic.sort_key))


def run_combined(verifier):
    """HVD4xx + HVD5xx over one shared corpus and one fixpoint."""
    heur_raw = verifier.run()
    proven_raw, approx_notes = simulate_verifier(verifier)
    return combine(heur_raw, proven_raw, approx_notes, verifier.corpus)


def verify_and_simulate_paths(paths):
    """The ``hvd-lint verify`` pipeline: heuristic HVD4xx + proven
    HVD5xx over every ``.py`` file under ``paths``, one shared parsed
    corpus and call-graph fixpoint for both layers."""
    verifier = Verifier()
    for path in iter_python_files(paths):
        verifier.add_path(path)
    return run_combined(verifier)


def verify_and_simulate_source(src, filename="<string>"):
    verifier = Verifier()
    try:
        verifier.add_source(src, filename)
    except SyntaxError as exc:
        return [Diagnostic.make(
            "HVD001", f"syntax error: {exc.msg}",
            file=filename, line=exc.lineno or 0)]
    return run_combined(verifier)


def simulate_paths(paths):
    """HVD5xx findings only (the simulator's own stream, after
    ownership/suppression) — what the fixture pins assert on."""
    return [d for d in verify_and_simulate_paths(paths)
            if d.rule.startswith("HVD5")]


def simulate_source(src, filename="<string>"):
    return [d for d in verify_and_simulate_source(src, filename)
            if d.rule.startswith("HVD5")]


# -- trace rendering --------------------------------------------------------
def render_trace(diag):
    """Human-readable counterexample for a HVD501/502 finding (the CLI
    text formatter appends this under the finding line). Format is
    golden-pinned — tooling parses it."""
    trace = getattr(diag, "trace", None)
    if not trace:
        return ""
    lines = [f"    counterexample (cohort: {trace['cohort']})"]
    for entry in trace["ranks"]:
        lines.append(f"      rank {entry['rank']}:")
        if entry.get("dropped"):
            lines.append(f"        ... {entry['dropped']} earlier "
                         "event(s) elided ...")
        for i, ev in enumerate(entry["events"], start=1):
            name = f"(name={ev['name']!r})" if ev["name"] else ""
            lines.append(
                f"        {i}. {ev['kind']}{name}  "
                f"{ev['file']}:{ev['line']}  [{ev['status']}]")
        if entry["end"] == "exhausted":
            lines.append("        (schedule exhausted — submits "
                         "nothing further)")
    if trace["forks"]:
        lines.append("      forks:")
        for f in trace["forks"]:
            lines.append(f"        - {f['file']}:{f['line']}: "
                         f"{f['why']}")
    return "\n".join(lines)

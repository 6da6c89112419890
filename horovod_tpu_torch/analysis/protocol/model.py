"""Explicit-state BFS explorer for the control-plane protocol specs (port
of ``horovod_tpu/analysis/protocol/model.py``).

The checker is deliberately small-model: each protocol
(analysis/protocol/machines.py) is a :class:`Model` whose actions call
the SAME spec functions the runtime executes, with crash/restart,
message loss, duplication, and reorder expressed as fault actions
enabled at every step. :func:`explore` walks the reachable state
space breadth-first up to a bounded depth/state/wall-clock budget,
checks every safety invariant on every state, and — when the bounded
space was covered completely — checks bounded liveness: every
reachable state must reach a goal state over *fair* (non-fault) edges
alone, i.e. the protocol cannot be wedged by any prefix of faults
once the faults stop.

Counterexamples come out minimized twice over: BFS order makes the
violating trace shortest by construction, and :func:`minimize` then
greedily deletes steps that the violation does not actually need
(replaying candidate traces through the model), which strips fault
injections a shorter organic path can do without. Violations render
through the existing hvd-lint machinery — :func:`violation_diagnostic`
emits HVD701/702/703 :class:`Diagnostic` objects whose ``trace`` dict
reuses the simulator's counterexample schema, so ``hvd-lint``'s text
renderer and the SARIF ``codeFlows`` writer need nothing new.
"""

import collections
import copy
import dataclasses
import json
import time

from ..diagnostics import Diagnostic


def _anchor(fn):
    """(file, line) of a spec function — counterexample steps point at
    the transition's source, not at the model harness."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return "<model>", 0
    return code.co_filename, code.co_firstlineno


@dataclasses.dataclass
class Action:
    """One enabled transition: ``run`` takes an already-deep-copied
    state, mutates it, and returns it. ``fault`` actions model the
    environment (crash, loss, duplication); everything else is fair
    scheduling. ``anchor`` is the spec function the step executes."""

    label: str
    actor: str
    run: object
    fault: bool = False
    anchor: tuple = ("<model>", 0)


@dataclasses.dataclass
class Step:
    label: str
    actor: str
    fault: bool
    file: str
    line: int


@dataclasses.dataclass
class Violation:
    kind: str          # "safety" | "liveness" | "budget"
    name: str          # invariant / goal name
    message: str
    trace: list        # [Step]; the minimized counterexample


@dataclasses.dataclass
class CheckResult:
    model: str
    states: int = 0
    edges: int = 0
    depth: int = 0
    complete: bool = False
    elapsed_s: float = 0.0
    violations: list = dataclasses.field(default_factory=list)

    @property
    def ok(self):
        return self.complete and not self.violations


class Model:
    """A protocol model: subclass-free — construct with callables.

    ``init()`` returns the initial state (a JSON-able dict);
    ``actions(state)`` returns the list of *enabled* :class:`Action`;
    ``invariants`` is ``[(name, check)]`` where ``check(state)``
    returns None when the invariant holds, else a message;
    ``liveness`` is ``[(name, goal)]`` where ``goal(state)`` is True
    on goal states."""

    def __init__(self, name, init, actions, invariants=(),
                 liveness=()):
        self.name = name
        self.init = init
        self.actions = actions
        self.invariants = list(invariants)
        self.liveness = list(liveness)


def canon(state):
    """Canonical serialization — the visited-set key."""
    return json.dumps(state, sort_keys=True, separators=(",", ":"))


def _steps_from(parents, key):
    steps = []
    while True:
        parent, action = parents[key]
        if parent is None:
            break
        file, line = action.anchor
        steps.append(Step(action.label, action.actor, action.fault,
                          file, line))
        key = parent
    steps.reverse()
    return steps


def replay(model, labels):
    """Replay a label sequence from init; the list of visited states,
    or None when some label is not enabled where the sequence needs
    it (deterministic: labels are unique per state by construction)."""
    state = model.init()
    out = [state]
    for label in labels:
        for action in model.actions(state):
            if action.label == label:
                state = action.run(copy.deepcopy(state))
                break
        else:
            return None
        out.append(state)
    return out


def minimize(model, steps, failing):
    """Greedy delta-minimization: drop any step whose removal keeps
    ``failing(final_state)`` true, until a fixpoint. BFS already made
    the trace shortest; this strips injected faults and setup steps a
    violation does not actually depend on."""
    labels = [s.label for s in steps]
    by_label = {s.label: s for s in steps}
    changed = True
    while changed:
        changed = False
        for i in range(len(labels)):
            candidate = labels[:i] + labels[i + 1:]
            states = replay(model, candidate)
            if states is not None and failing(states[-1]):
                labels = candidate
                changed = True
                break
    return [by_label[label] for label in labels]


def explore(model, max_depth=24, max_states=100000, deadline_s=None,
            stop_on_first=True):
    """BFS over the model's reachable states within the budget;
    returns a :class:`CheckResult`. ``complete`` is True only when the
    bounded space was exhausted without tripping any budget — liveness
    is only *judged* on a complete exploration (an incomplete one gets
    a ``budget`` violation instead, rendered as HVD703)."""
    t0 = time.monotonic()
    result = CheckResult(model=model.name)
    init = model.init()
    init_key = canon(init)
    parents = {init_key: (None, None)}
    states = {init_key: init}
    fair_succ = collections.defaultdict(set)
    queue = collections.deque([(init_key, 0)])
    budget_hit = None

    def violated(key):
        state = states[key]
        for name, check in model.invariants:
            msg = check(state)
            if msg is not None:
                steps = _steps_from(parents, key)
                steps = minimize(
                    model, steps,
                    lambda final, _c=check: _c(final) is not None)
                result.violations.append(Violation(
                    "safety", name, msg, steps))
                return True
        return False

    if violated(init_key) and stop_on_first:
        result.states = 1
        result.elapsed_s = time.monotonic() - t0
        return result

    while queue:
        if deadline_s is not None and time.monotonic() - t0 > deadline_s:
            budget_hit = f"wall clock over {deadline_s:.1f}s"
            break
        key, depth = queue.popleft()
        state = states[key]
        for action in model.actions(state):
            succ = action.run(copy.deepcopy(state))
            succ_key = canon(succ)
            result.edges += 1
            if not action.fault:
                fair_succ[key].add(succ_key)
            if succ_key in parents:
                continue
            if depth >= max_depth:
                # A genuinely new state past the horizon: the bounded
                # space was NOT covered (an already-seen successor at
                # the horizon costs nothing).
                budget_hit = f"depth bound {max_depth} reached"
                continue
            if len(parents) >= max_states:
                budget_hit = f"state bound {max_states} reached"
                queue.clear()
                break
            parents[succ_key] = (key, action)
            states[succ_key] = succ
            result.depth = max(result.depth, depth + 1)
            if violated(succ_key) and stop_on_first:
                queue.clear()
                break
            queue.append((succ_key, depth + 1))

    result.states = len(parents)
    result.complete = budget_hit is None and not (
        result.violations and stop_on_first)
    if budget_hit is not None:
        result.violations.append(Violation(
            "budget", "exploration",
            f"bounded exploration incomplete: {budget_hit} after "
            f"{len(parents)} state(s)", []))

    if result.complete and model.liveness:
        _check_liveness(model, result, parents, states, fair_succ)
    result.elapsed_s = time.monotonic() - t0
    return result


def _check_liveness(model, result, parents, states, fair_succ):
    """Bounded liveness under fair scheduling: from every reachable
    state a goal state must be reachable over fair edges alone.
    Backward reachability from the goal set over the fair edge
    relation; any state left outside is a wedge — its shortest
    incoming trace is the counterexample."""
    preds = collections.defaultdict(set)
    for src, succs in fair_succ.items():
        for dst in succs:
            preds[dst].add(src)
    for name, goal in model.liveness:
        can_reach = {key for key, state in states.items()
                     if goal(state)}
        frontier = collections.deque(can_reach)
        while frontier:
            key = frontier.popleft()
            for pred in preds[key]:
                if pred not in can_reach:
                    can_reach.add(pred)
                    frontier.append(pred)
        wedged = [key for key in states if key not in can_reach]
        if not wedged:
            continue
        # Shortest trace = the wedged state discovered earliest.
        key = min(wedged,
                  key=lambda k: len(_steps_from(parents, k)))
        result.violations.append(Violation(
            "liveness", name,
            f"{len(wedged)} reachable state(s) cannot reach the "
            f"{name!r} goal over fair (fault-free) scheduling — the "
            "protocol is wedged once the faults stop",
            _steps_from(parents, key)))


# -- rendering through the hvd-lint machinery ------------------------------

def _trace_dict(model_name, steps):
    """The simulator's counterexample schema (analysis/simulate.py
    render_trace, analysis/sarif.py codeFlows): one "rank" per
    protocol actor, events carrying the global step index so the
    interleaving stays readable after the per-actor split."""
    per_actor = {}
    for i, step in enumerate(steps, start=1):
        per_actor.setdefault(step.actor, []).append({
            "kind": step.label,
            "name": f"step {i}",
            "file": step.file,
            "line": step.line,
            "status": "fault" if step.fault else "ok",
        })
    ranks = [{"rank": actor, "events": events, "end": ""}
             for actor, events in per_actor.items()]
    return {"cohort": model_name, "ranks": ranks, "forks": []}


def violation_diagnostic(model, violation):
    """One :class:`Diagnostic` per violation: HVD701 (safety), HVD702
    (liveness), HVD703 (budget). Location anchors at the last spec
    transition of the counterexample — the step that lands in the bad
    state."""
    rule = {"safety": "HVD701", "liveness": "HVD702",
            "budget": "HVD703"}[violation.kind]
    if violation.trace:
        file, line = violation.trace[-1].file, violation.trace[-1].line
    else:
        file, line = _anchor(model.init)
    kind_txt = {"safety": "invariant", "liveness": "liveness goal",
                "budget": "budget"}[violation.kind]
    message = (f"protocol {model.name!r}, {kind_txt} "
               f"{violation.name!r}: {violation.message}")
    hint = ("replay the counterexample with `hvd-model --protocol "
            f"{model.name} --format text` and see docs/modelcheck.md "
            "\"Reading a counterexample\""
            if violation.trace else
            "raise --depth/--max-states/--budget-s, or shrink the "
            "model's bounds (docs/modelcheck.md \"Budgets\")")
    trace = (_trace_dict(model.name, violation.trace)
             if violation.trace else None)
    return Diagnostic.make(rule, message, file=file, line=line,
                           hint=hint, trace=trace)


def result_diagnostics(model, result):
    """Every violation of one :class:`CheckResult` as Diagnostics."""
    return [violation_diagnostic(model, v) for v in result.violations]


__all__ = ["Action", "Step", "Violation", "CheckResult", "Model",
           "canon", "replay", "minimize", "explore",
           "violation_diagnostic", "result_diagnostics"]

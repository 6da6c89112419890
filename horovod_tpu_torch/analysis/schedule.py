"""Interprocedural collective-schedule verifier (``hvd-lint verify``; port
of ``horovod_tpu/analysis/schedule.py``).

The HVD1xx/2xx/3xx layers are single-function, one-hop analyses: a
rank-dependent branch two calls above an ``allreduce``, or a loop whose
trip count differs per rank, sails through them clean. This layer
closes that gap by extracting a **symbolic per-rank collective
schedule** for a whole program and flagging every way that schedule can
diverge across ranks.

Architecture (prose version: docs/lint.md "Analyzer architecture"):

1. **Call graph.** Every analyzed file becomes a module of functions
   (top-level defs, methods, nested defs, plus the module body itself).
   ``import horovod_tpu_torch.x`` / ``from horovod_tpu_torch.x import f``
   (and the JAX package's ``horovod_tpu.x``, read as text) /
   relative imports inside the package are resolved to files on disk
   and pulled into the corpus on demand, so a collective buried in a
   helper module is analyzed in the caller's context. Call edges carry
   the control context of the call site and the taint of every
   argument.
2. **Taint lattice.** A two-point lattice (clean < rank-tainted)
   propagated through local assignment: ``hvd.rank()`` /
   ``local_rank()`` / ``lax.axis_index`` / process-set membership
   (``ps.rank()``/``ps.included()``) seed it; variables, conditions,
   loop bounds, and function *return values* (interprocedural fixpoint)
   carry it. Replica-invariant values — results of collectives — reset
   it: ``done = allreduce(flag)`` is rank-invariant by construction.
3. **Schedule extraction.** Walking each function once per fixpoint
   round records every collective as a ``ScheduleEvent`` (kind x name x
   process set x control context), every call site, every early exit
   (``return``/``raise``/``continue``/``break``), and every loop with
   its bound classification. :func:`extract_schedule` exposes the raw
   per-function schedules.
4. **HVD4xx rules** over the extracted schedules:

   - **HVD401** — a collective reachable under rank-tainted control
     flow through *any* call depth (generalizes HVD102/HVD201 beyond
     one hop; direct single-hop guards stay HVD201's finding).
   - **HVD402** — a loop containing a collective whose trip count is
     rank-tainted or data-dependent (schedule-*length* divergence:
     ranks submit different collective counts — a guaranteed stall).
   - **HVD403** — an early ``return``/``raise``/``continue``/``break``
     under a rank-tainted condition that skips a collective other
     ranks execute.
   - **HVD404** — collectives on distinct process sets interleaved in
     a context where relative order can differ per rank (deadlock by
     cross-set wait cycle).
   - **HVD405** — a per-tensor-semantics reduction (Adasum) routed
     through a bucketing/concatenating path (``grouped_allreduce`` or
     a concatenated payload): bucketing silently changes the dot
     products Adasum's scale-invariant combination is built from.

Known approximations (deliberate, documented in docs/lint.md):
over-approximation — any taint inside a condition taints the whole
frame (no path-sensitive pruning); under-approximation — attribute
*reads* (``topology.rank``) do not seed taint (only calls do), exits
are matched to skipped collectives lexically within one function, and
dynamic dispatch (``getattr``, callables in containers) is invisible.
Member-only collectives guarded by their own set's membership test
(``if ps.included(): allreduce(..., process_set=ps)``) are recognized
and exempt. Pure stdlib — no jax imports.
"""

import ast
import os
import re

from .diagnostics import Diagnostic, dedupe, relative_to_cwd
from .ast_lint import (
    PKG_ROOTS, AliasResolver, _apply_suppressions, _root_name, _terminal_name,
    iter_python_files, parse_cached,
)

_DOC_HINT = "see docs/lint.md"

# Bucketing / concatenating constructors feeding HVD405.
_CONCAT_CALLS = frozenset({
    "concatenate", "concat", "stack", "hstack", "vstack", "cat",
})
_GROUPED_PREFIX = "grouped_"
_PSET_CTORS = frozenset({"ProcessSet", "add_process_set"})
_PSET_MEMBER_METHODS = frozenset({"rank", "local_rank", "included"})
# Corpus safety valve: lazy import resolution must never crawl the
# world. Far above the package's module count.
_MAX_MODULES = 512
_MAX_PASSES = 6


def _params_of(node):
    args = node.args
    names = [a.arg for a in (args.posonlyargs + args.args
                             + args.kwonlyargs)]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


def _unparse(node):
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — diagnostics only
        return "<expr>"


class _Frame:
    """One control-flow context (an ``if`` arm, a loop body)."""

    __slots__ = ("kind", "line", "tainted", "direct", "loop",
                 "test_params", "partner", "balanced", "pset_guard")

    def __init__(self, kind, line, tainted, direct, loop=False,
                 test_params=frozenset(), pset_guard=None):
        self.kind = kind
        self.line = line
        self.tainted = tainted
        self.direct = direct          # test literally calls rank()
        self.loop = loop
        self.test_params = test_params
        self.partner = None           # the else-arm frame of an if
        self.balanced = False         # both arms issue collectives
        self.pset_guard = pset_guard  # membership-tested pset var

    def describe(self):
        tag = self.kind
        if self.tainted:
            tag += " rank-tainted"
        return f"{tag}@{self.line}"


class ScheduleEvent:
    """One collective in the symbolic per-rank schedule."""

    __slots__ = ("kind", "name", "pset", "op", "line", "ctx",
                 "from_concat", "pattern")

    def __init__(self, kind, name, pset, op, line, ctx, from_concat,
                 pattern=None):
        self.kind = kind
        self.name = name              # explicit name= constant, or None
        self.pset = pset              # "global" or the unparsed expr
        self.op = op                  # terminal name of op=, or None
        self.line = line
        self.ctx = ctx                # tuple of _Frame
        self.from_concat = from_concat
        # regex for an f-string name= (``f"step{epoch}"`` -> ``step(.+)``)
        # — what lets `hvd-lint explain` map a runtime name like
        # ``step3`` back to this call site. None for constant/absent.
        self.pattern = pattern

    def to_dict(self, func):
        return {
            "function": func, "kind": self.kind, "name": self.name,
            "process_set": self.pset, "line": self.line,
            "context": [fr.describe() for fr in self.ctx],
        }


class _CallSite:
    __slots__ = ("callee", "line", "ctx", "tainted_params",
                 "adasum_params", "arg_params", "arg_names")

    def __init__(self, callee, line, ctx, tainted_params, adasum_params,
                 arg_params, arg_names):
        self.callee = callee
        self.line = line
        self.ctx = ctx
        self.tainted_params = tainted_params  # callee params bound tainted
        self.adasum_params = adasum_params    # callee params bound Adasum
        self.arg_params = arg_params  # callee param -> caller param names
        self.arg_names = arg_names    # every Name appearing in the args


class _Exit:
    __slots__ = ("kind", "line", "ctx")

    def __init__(self, kind, line, ctx):
        self.kind = kind
        self.line = line
        self.ctx = ctx


class _Loop:
    __slots__ = ("frame", "kind", "line", "test_names", "body_assigns")

    def __init__(self, frame, kind, line, test_names):
        self.frame = frame
        self.kind = kind              # "for" | "while"
        self.line = line
        self.test_names = test_names  # Names in the bound/condition
        self.body_assigns = {}        # name -> "invariant"|"call"|"pure"


class _Func:
    """One function (or module body) plus its fixpoint summary."""

    def __init__(self, qualname, node, module):
        self.qualname = qualname
        self.node = node
        self.module = module
        self.params = _params_of(node) if node is not None else []
        self.local_funcs = {}
        # per-pass walk products
        self.events = []
        self.calls = []
        self.exits = []
        self.loops = []
        self.frames = []
        self.program = []             # structured tree (walk_block doc)
        # fixpoint summary bits
        self.return_tainted = False
        self.guard_params = frozenset()
        self.grouped_op_params = frozenset()
        self.has_coll = False
        self.has_coll_trans = False
        self.reached = None           # call-chain text when rank-gated

    def summary(self):
        return (self.return_tainted, self.guard_params,
                self.grouped_op_params, self.has_coll)

    @property
    def body(self):
        return self.node.body if self.node is not None else []


class _Module:
    def __init__(self, path, src, tree):
        self.path = path
        self.src = src
        self.tree = tree
        self.res = AliasResolver()
        self.funcs = {}               # qualname -> _Func
        self.import_map = {}          # local name -> ("mod"|"from", ...)
        self._scan()

    def _scan(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                self.res.visit_import(node)
                for alias in node.names:
                    target = alias.asname or alias.name.split(".")[0]
                    self.import_map.setdefault(
                        target, ("mod", alias.name if alias.asname
                                 else alias.name.split(".")[0], 0))
            elif isinstance(node, ast.ImportFrom):
                self.res.visit_import_from(node)
                mod = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    name = alias.asname or alias.name
                    self.import_map.setdefault(
                        name, ("from", mod, node.level, alias.name))
        # the module body itself is the entry "function"
        body_fn = _Func("<module>", None, self)
        body_fn.node = None
        self.funcs["<module>"] = body_fn
        self._collect_funcs(self.tree.body, prefix="", owner=body_fn)

    def _collect_funcs(self, stmts, prefix, owner):
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + node.name
                fn = _Func(qual, node, self)
                self.funcs[qual] = fn
                if owner is not None:
                    owner.local_funcs[node.name] = fn
                self._collect_funcs(node.body, qual + ".", fn)
            elif isinstance(node, ast.ClassDef):
                # methods keep the full enclosing prefix so a class
                # nested in a function cannot clobber a same-named
                # top-level class; no owner — methods are not callable
                # by bare name
                self._collect_funcs(node.body, prefix + node.name + ".",
                                    owner=None)


class _Corpus:
    """Modules under analysis, with lazy package import loading."""

    def __init__(self):
        self.modules = {}             # abspath -> _Module
        self.pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))

    def add_source(self, src, filename):
        tree = ast.parse(src, filename=filename)
        mod = _Module(filename, src, tree)
        self.modules[filename] = mod
        return mod

    def load(self, path):
        path = os.path.abspath(path)
        if path in self.modules:
            return self.modules[path]
        if len(self.modules) >= _MAX_MODULES:
            return None
        try:
            src, tree = parse_cached(path)
        except (OSError, SyntaxError):
            return None
        mod = _Module(path, src, tree)
        self.modules[path] = mod
        return mod

    def resolve_module_path(self, modname, level, from_path):
        """File for ``modname`` (absolute ``horovod_tpu_torch.*`` and the
        other :data:`~.ast_lint.PKG_ROOTS` beside it, or relative
        with ``level`` leading dots), or None for everything else."""
        if level:
            base = os.path.dirname(os.path.abspath(from_path))
            for _ in range(level - 1):
                base = os.path.dirname(base)
            parts = modname.split(".") if modname else []
        else:
            root = modname.split(".")[0]
            if root in PKG_ROOTS:
                base = self.pkg_root
            else:
                # a sibling module of the entry script (`from helpers
                # import sync` next to train.py) — how plain scripts
                # import their own helpers
                base = os.path.dirname(os.path.abspath(from_path))
            parts = modname.split(".")
        candidate = os.path.join(base, *parts) if parts else base
        for path in (candidate + ".py",
                     os.path.join(candidate, "__init__.py")):
            if os.path.isfile(path):
                return path
        return None

    def resolve_call(self, call, func, module):
        """The _Func a call resolves to, or None (collectives, library
        calls, dynamic dispatch)."""
        f = call.func
        if isinstance(f, ast.Name):
            name = f.id
            cur = func
            while cur is not None:
                if name in cur.local_funcs:
                    return cur.local_funcs[name]
                cur = None  # one level is enough: nested defs register
            if name in module.funcs:
                return module.funcs[name]
            entry = module.import_map.get(name)
            if entry and entry[0] == "from":
                _, mod, level, orig = entry
                path = self.resolve_module_path(mod, level, module.path)
                if path:
                    other = self.load(path)
                    if other:
                        return other.funcs.get(orig)
            return None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            base = f.value.id
            if base in ("self", "cls") and "." in func.qualname:
                cls = func.qualname.rsplit(".", 1)[0]
                return module.funcs.get(f"{cls}.{f.attr}")
            entry = module.import_map.get(base)
            if entry and entry[0] == "from":
                _, mod, level, orig = entry
                # `from horovod_tpu import checkpoint` -> module alias
                parent = self.resolve_module_path(mod, level, module.path)
                if parent:
                    sub = os.path.join(os.path.dirname(parent)
                                       if parent.endswith("__init__.py")
                                       else parent[:-3], "")
                    for path in (
                            os.path.join(os.path.dirname(parent), orig
                                         + ".py")
                            if parent.endswith("__init__.py") else None,
                            os.path.join(sub, orig, "__init__.py")):
                        if path and os.path.isfile(path):
                            other = self.load(path)
                            if other:
                                return other.funcs.get(f.attr)
            elif entry and entry[0] == "mod":
                path = self.resolve_module_path(entry[1], 0, module.path)
                if path:
                    other = self.load(path)
                    if other:
                        return other.funcs.get(f.attr)
        return None


class _FuncWalker:
    """One fixpoint pass over one function's body."""

    def __init__(self, corpus, module, func):
        self.corpus = corpus
        self.module = module
        self.func = func
        self.res = module.res
        self.tainted = set()
        self.pset_vars = set()
        self.call_derived = set()     # assigned from local compute calls
        self.concat_vars = set()
        self.active_loops = []

    # -- taint -------------------------------------------------------------
    def _call_tainted(self, n):
        if self.res.is_rank_call(n):
            return True
        if (isinstance(n.func, ast.Attribute)
                and n.func.attr in _PSET_MEMBER_METHODS
                and _root_name(n.func) in self.pset_vars):
            return True
        callee = self.corpus.resolve_call(n, self.func, self.module)
        return callee is not None and callee.return_tainted

    def expr_tainted(self, expr):
        if expr is None:
            return False
        for n in ast.walk(expr):
            if isinstance(n, ast.Call) and self._call_tainted(n):
                return True
            if isinstance(n, ast.Name) and n.id in self.tainted:
                return True
        return False

    def _expr_direct(self, expr):
        """The test itself calls rank()/membership — the one-hop shape
        HVD201 already owns."""
        if expr is None:
            return False
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                if self.res.is_rank_call(n):
                    return True
                if (isinstance(n.func, ast.Attribute)
                        and n.func.attr in _PSET_MEMBER_METHODS
                        and _root_name(n.func) in self.pset_vars):
                    return True
        return False

    def _pset_guard_of(self, expr):
        if expr is None:
            return None
        for n in ast.walk(expr):
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _PSET_MEMBER_METHODS):
                root = _root_name(n.func)
                if root in self.pset_vars:
                    return root
        return None

    def _test_params(self, expr):
        if expr is None:
            return frozenset()
        params = set(self.func.params)
        return frozenset(n.id for n in ast.walk(expr)
                         if isinstance(n, ast.Name) and n.id in params)

    # -- expression scan: events + call sites ------------------------------
    def scan_expr(self, expr, ctx, prog=None):
        if expr is None:
            return
        for n in ast.walk(expr):
            if not isinstance(n, ast.Call):
                continue
            kind = self.res.collective_kind(n)
            if kind is not None:
                self._record_event(n, kind, ctx, prog)
                continue
            callee = self.corpus.resolve_call(n, self.func, self.module)
            if callee is None or callee is self.func:
                continue
            self._record_call(n, callee, ctx, prog)

    @staticmethod
    def _name_pattern(node):
        """Regex for an f-string ``name=`` (constant parts escaped,
        interpolations matched loosely), or None."""
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(re.escape(str(v.value)))
            else:
                parts.append("(.+)")
        return "".join(parts) or None

    def _record_event(self, n, kind, ctx, prog=None):
        name = op = pattern = None
        pset = "global"
        for kw in n.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                name = str(kw.value.value)
            elif kw.arg == "name" and isinstance(kw.value,
                                                 ast.JoinedStr):
                pattern = self._name_pattern(kw.value)
            elif kw.arg == "op":
                op = _terminal_name(kw.value)
            elif kw.arg == "process_set":
                text = _unparse(kw.value)
                pset = ("global" if text.endswith("global_process_set")
                        else text)
        from_concat = False
        if n.args:
            first = n.args[0]
            if (isinstance(first, ast.Call)
                    and _terminal_name(first.func) in _CONCAT_CALLS):
                from_concat = True
            elif (isinstance(first, ast.Name)
                    and first.id in self.concat_vars):
                from_concat = True
        event = ScheduleEvent(kind, name, pset, op, n.lineno,
                              tuple(ctx), from_concat, pattern)
        self.func.events.append(event)
        if prog is not None:
            prog.append(("ev", event))
        # an op= that is a bare parameter feeding a grouped/bucketed
        # collective: record for the interprocedural HVD405 check
        if kind.startswith(_GROUPED_PREFIX):
            for kw in n.keywords:
                if (kw.arg == "op" and isinstance(kw.value, ast.Name)
                        and kw.value.id in self.func.params):
                    self.func.grouped_op_params = (
                        self.func.grouped_op_params | {kw.value.id})

    def _record_call(self, n, callee, ctx, prog=None):
        tainted_params, adasum_params = set(), set()
        arg_params, arg_names = {}, set()
        own = set(self.func.params)

        def bind(param, value):
            if param is None:
                return
            if self.expr_tainted(value):
                tainted_params.add(param)
            if _terminal_name(value) == "Adasum":
                adasum_params.add(param)
            referenced = {m.id for m in ast.walk(value)
                          if isinstance(m, ast.Name)}
            arg_names.update(referenced)
            hits = referenced & own
            if hits:
                arg_params.setdefault(param, set()).update(hits)

        for i, value in enumerate(n.args):
            bind(callee.params[i] if i < len(callee.params) else None,
                 value)
        for kw in n.keywords:
            if kw.arg and kw.arg in callee.params:
                bind(kw.arg, kw.value)
        site = _CallSite(
            callee, n.lineno, tuple(ctx), frozenset(tainted_params),
            frozenset(adasum_params), arg_params, frozenset(arg_names))
        self.func.calls.append(site)
        if prog is not None:
            prog.append(("call", site))

    # -- assignment bookkeeping --------------------------------------------
    @staticmethod
    def _target_names(target):
        elts = (target.elts if isinstance(target, (ast.Tuple, ast.List))
                else [target])
        return [t.id for t in elts if isinstance(t, ast.Name)]

    def _value_class(self, value):
        """invariant (collective result) > call (local compute) > pure."""
        has_call = False
        for n in ast.walk(value):
            if isinstance(n, ast.Call):
                if self.res.is_collective(n):
                    return "invariant"
                has_call = True
            elif (isinstance(n, ast.Name)
                    and n.id in self.call_derived):
                has_call = True
        return "call" if has_call else "pure"

    def _note_assign(self, targets, value):
        # element-wise tuple unpacking: `rank, size = hvd.rank(),
        # hvd.size()` must taint `rank` only, not smear over `size`
        if (len(targets) == 1
                and isinstance(targets[0], (ast.Tuple, ast.List))
                and isinstance(value, (ast.Tuple, ast.List))
                and len(targets[0].elts) == len(value.elts)):
            for t, v in zip(targets[0].elts, value.elts):
                self._note_assign([t], v)
            return
        names = []
        for t in targets:
            names.extend(self._target_names(t))
        if not names:
            return
        cls = self._value_class(value)
        # collective results are replica-invariant BY CONSTRUCTION
        # (every rank gets the identical reduction/concatenation), so
        # an assignment through a collective launders rank taint:
        # `n = min(allgather(local_n))` is the canonical lockstep idiom
        tainted = cls != "invariant" and self.expr_tainted(value)
        is_pset = (isinstance(value, ast.Call)
                   and _terminal_name(value.func) in _PSET_CTORS)
        is_concat = (isinstance(value, ast.Call)
                     and _terminal_name(value.func) in _CONCAT_CALLS)
        for name in names:
            for store, on in ((self.tainted, tainted),
                              (self.pset_vars, is_pset),
                              (self.concat_vars, is_concat),
                              (self.call_derived, cls == "call")):
                (store.add if on else store.discard)(name)
            for loop in self.active_loops:
                if name in loop.test_names:
                    loop.body_assigns[name] = cls

    # -- statement walk ----------------------------------------------------
    def walk(self):
        fn = self.func
        fn.events, fn.calls, fn.exits = [], [], []
        fn.loops, fn.frames = [], []
        fn.program = []
        fn.return_tainted = False
        fn.grouped_op_params = frozenset()
        body = fn.body if fn.node is not None else fn.module.tree.body
        self.walk_block(body, [], fn.program)
        fn.has_coll = bool(fn.events)

    def _make_frame(self, kind, test, line, loop=False):
        frame = _Frame(
            kind, line, tainted=self.expr_tainted(test),
            direct=self._expr_direct(test), loop=loop,
            test_params=self._test_params(test),
            pset_guard=self._pset_guard_of(test))
        self.func.frames.append(frame)
        return frame

    def walk_block(self, stmts, ctx, prog):
        """Walk statements recording events/calls/exits/loops (the rule
        inputs) AND building the structured **program tree** in ``prog``
        — the executable form the schedule simulator
        (analysis/simulate.py) replays per symbolic rank. Node shapes:
        ``("ev", ScheduleEvent)``, ``("call", _CallSite)``,
        ``("br", _Frame, then_prog, else_prog)``,
        ``("loop", _Loop, body_prog)``, ``("exit", _Exit)``, and
        ``("opt", prog)`` for exception handlers (never executed by the
        simulator — exception paths are a documented approximation)."""
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # separate _Func entries
            elif isinstance(node, ast.If):
                self.scan_expr(node.test, ctx, prog)
                frame = self._make_frame("if", node.test, node.lineno)
                then_prog, else_prog = [], []
                self.walk_block(node.body, ctx + [frame], then_prog)
                other = _Frame("else", node.lineno, frame.tainted,
                               frame.direct,
                               test_params=frame.test_params,
                               pset_guard=frame.pset_guard)
                frame.partner = other
                other.partner = frame
                self.func.frames.append(other)
                self.walk_block(node.orelse, ctx + [other], else_prog)
                prog.append(("br", frame, then_prog, else_prog))
            elif isinstance(node, ast.While):
                self.scan_expr(node.test, ctx, prog)
                frame = self._make_frame("while", node.test, node.lineno,
                                         loop=True)
                loop = _Loop(frame, "while", node.lineno,
                             {m.id for m in ast.walk(node.test)
                              if isinstance(m, ast.Name)})
                self.func.loops.append(loop)
                self.active_loops.append(loop)
                body_prog = []
                self.walk_block(node.body, ctx + [frame], body_prog)
                self.active_loops.pop()
                prog.append(("loop", loop, body_prog))
                self.walk_block(node.orelse, ctx, prog)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                self.scan_expr(node.iter, ctx, prog)
                frame = self._make_frame("for", node.iter, node.lineno,
                                         loop=True)
                if frame.tainted:
                    target = node.target
                    if (isinstance(node.iter, ast.Call)
                            and _terminal_name(node.iter.func)
                            == "enumerate"
                            and isinstance(target, ast.Tuple)
                            and len(target.elts) == 2):
                        # enumerate counters are replica-invariant
                        # (every rank counts 0,1,2,...) even over
                        # rank-sharded data — taint only the values
                        target = target.elts[1]
                    for name in self._target_names(target):
                        self.tainted.add(name)
                loop = _Loop(frame, "for", node.lineno, set())
                self.func.loops.append(loop)
                self.active_loops.append(loop)
                body_prog = []
                self.walk_block(node.body, ctx + [frame], body_prog)
                self.active_loops.pop()
                prog.append(("loop", loop, body_prog))
                self.walk_block(node.orelse, ctx, prog)
            elif isinstance(node, ast.Try):
                self.walk_block(node.body, ctx, prog)
                for handler in node.handlers:
                    handler_prog = []
                    self.walk_block(handler.body, ctx, handler_prog)
                    prog.append(("opt", handler_prog))
                self.walk_block(node.orelse, ctx, prog)
                self.walk_block(node.finalbody, ctx, prog)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    self.scan_expr(item.context_expr, ctx, prog)
                self.walk_block(node.body, ctx, prog)
            elif isinstance(node, ast.Assign):
                self.scan_expr(node.value, ctx, prog)
                self._note_assign(node.targets, node.value)
            elif isinstance(node, ast.AugAssign):
                self.scan_expr(node.value, ctx, prog)
                # += keeps the existing classification ("pure" update)
                for loop in self.active_loops:
                    for name in self._target_names(node.target):
                        if (name in loop.test_names
                                and name not in loop.body_assigns):
                            loop.body_assigns[name] = "pure"
            elif isinstance(node, ast.AnnAssign):
                self.scan_expr(node.value, ctx, prog)
                if node.value is not None:
                    self._note_assign([node.target], node.value)
            elif isinstance(node, ast.Return):
                self.scan_expr(node.value, ctx, prog)
                if self.expr_tainted(node.value):
                    self.func.return_tainted = True
                exit_ = _Exit("return", node.lineno, tuple(ctx))
                self.func.exits.append(exit_)
                prog.append(("exit", exit_))
            elif isinstance(node, ast.Raise):
                self.scan_expr(node.exc, ctx, prog)
                exit_ = _Exit("raise", node.lineno, tuple(ctx))
                self.func.exits.append(exit_)
                prog.append(("exit", exit_))
            elif isinstance(node, ast.Continue):
                exit_ = _Exit("continue", node.lineno, tuple(ctx))
                self.func.exits.append(exit_)
                prog.append(("exit", exit_))
            elif isinstance(node, ast.Break):
                exit_ = _Exit("break", node.lineno, tuple(ctx))
                self.func.exits.append(exit_)
                prog.append(("exit", exit_))
            elif isinstance(node, ast.Expr):
                self.scan_expr(node.value, ctx, prog)
            else:
                # assert/delete/global/... — scan any embedded
                # expressions; no new control context
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, ast.expr):
                        self.scan_expr(child, ctx, prog)


def _mentions(pset_text, var):
    return var is not None and var in re.findall(r"\w+", pset_text or "")


class Verifier:
    """Drive the fixpoint and evaluate the HVD4xx rules."""

    def __init__(self):
        self.corpus = _Corpus()
        self.entries = []
        self._fixpointed = False

    def add_path(self, path):
        mod = self.corpus.load(path)
        if mod is not None:
            self.entries.append(mod)
            self._fixpointed = False
        return mod

    def add_source(self, src, filename="<string>"):
        mod = self.corpus.add_source(src, filename)
        self.entries.append(mod)
        self._fixpointed = False
        return mod

    def fixpoint(self):
        """Idempotent fixpoint: consumers that run AFTER the rules
        (the perf cost model) share the invocation's one call-graph
        fixpoint instead of re-walking the corpus."""
        if not self._fixpointed:
            self._fixpoint()
            self._compute_balance()
            self._fixpointed = True

    def _all_funcs(self):
        for path in sorted(self.corpus.modules):
            mod = self.corpus.modules[path]
            for qual in list(mod.funcs):
                yield mod.funcs[qual]

    # -- fixpoint ----------------------------------------------------------
    def _fixpoint(self):
        for _ in range(_MAX_PASSES):
            changed = False
            count_before = len(self.corpus.modules)
            for fn in list(self._all_funcs()):
                before = fn.summary()
                _FuncWalker(self.corpus, fn.module, fn).walk()
                if fn.summary() != before:
                    changed = True
            self._close_has_coll()
            for fn in self._all_funcs():
                before = fn.guard_params
                self._compute_guard_params(fn)
                if fn.guard_params != before:
                    changed = True
            if len(self.corpus.modules) != count_before:
                changed = True
            if not changed:
                break

    def _close_has_coll(self):
        funcs = list(self._all_funcs())
        for fn in funcs:
            fn.has_coll_trans = fn.has_coll
        moved = True
        while moved:
            moved = False
            for fn in funcs:
                if fn.has_coll_trans:
                    continue
                if any(c.callee.has_coll_trans for c in fn.calls):
                    fn.has_coll_trans = True
                    moved = True

    def _compute_guard_params(self, fn):
        guards = set(fn.guard_params)
        for event in fn.events:
            for frame in event.ctx:
                guards |= frame.test_params
        for call in fn.calls:
            if call.callee.has_coll_trans:
                for frame in call.ctx:
                    guards |= frame.test_params
            for callee_param, caller_params in call.arg_params.items():
                if callee_param in call.callee.guard_params:
                    guards |= caller_params
        fn.guard_params = frozenset(guards)

    # -- rules -------------------------------------------------------------
    def run(self):
        self.fixpoint()
        diags = []
        diags_404, cross_set_events = self._rule_404()
        diags += diags_404
        self._mark_reached()
        diags += self._rule_401(cross_set_events)
        diags += self._rule_402()
        diags += self._rule_403()
        diags += self._rule_405()
        return dedupe(sorted(diags, key=Diagnostic.sort_key))

    def _frame_events(self, fn):
        by_frame = {}
        for event in fn.events:
            for frame in event.ctx:
                by_frame.setdefault(frame, []).append(event)
        return by_frame

    def _frame_coll_calls(self, fn):
        by_frame = {}
        for call in fn.calls:
            if not call.callee.has_coll_trans:
                continue
            for frame in call.ctx:
                by_frame.setdefault(frame, []).append(call)
        return by_frame

    def _compute_balance(self):
        for fn in self._all_funcs():
            events = self._frame_events(fn)
            calls = self._frame_coll_calls(fn)
            for frame in fn.frames:
                if frame.kind != "if" or frame.partner is None:
                    continue
                mine = bool(events.get(frame)) or bool(calls.get(frame))
                theirs = (bool(events.get(frame.partner))
                          or bool(calls.get(frame.partner)))
                frame.balanced = frame.partner.balanced = mine and theirs

    @staticmethod
    def _divergent_frame(ctx, arg_names=frozenset()):
        """Innermost rank-tainted frame that actually diverges: not
        balanced (both arms issue collectives is SPMD-correct shape),
        not a loop (divergent trip counts are HVD402's finding, one
        per loop, not one per collective inside it), and not a
        membership guard for a set the call itself works on."""
        for frame in reversed(ctx):
            if not frame.tainted or frame.balanced or frame.loop:
                continue
            if frame.pset_guard and frame.pset_guard in arg_names:
                continue
            return frame
        return None

    def _mark_reached(self):
        worklist = []
        for fn in self._all_funcs():
            for call in fn.calls:
                frame = self._divergent_frame(call.ctx, call.arg_names)
                if frame is not None and call.callee.has_coll_trans \
                        and call.callee.reached is None:
                    call.callee.reached = (
                        f"called from {fn.qualname} at "
                        f"{_rel(fn.module.path)}:{call.line} under the "
                        f"rank-tainted `{frame.kind}` at line "
                        f"{frame.line}")
                    worklist.append(call.callee)
        while worklist:
            fn = worklist.pop()
            for call in fn.calls:
                callee = call.callee
                if callee.has_coll_trans and callee.reached is None:
                    callee.reached = (f"reached through {fn.qualname} "
                                      f"({fn.reached})")
                    worklist.append(callee)

    def _rule_401(self, cross_set_events=frozenset()):
        diags = []
        for fn in self._all_funcs():
            if fn.reached is not None:
                for event in fn.events:
                    diags.append(Diagnostic.make(
                        "HVD401",
                        f"collective `{event.kind}`"
                        + (f" (name={event.name!r})" if event.name
                           else "")
                        + " runs only on ranks that take a rank-"
                        "dependent path: " + fn.reached + " — the other "
                        "ranks never submit it and the job deadlocks",
                        file=fn.module.path, line=event.line,
                        hint="hoist the collective out of the rank-"
                             "dependent path (every rank must submit "
                             "every collective), or make the gating "
                             "condition replica-invariant; "
                             + _DOC_HINT))
                continue
            for event in fn.events:
                if id(event) in cross_set_events:
                    continue  # HVD404 is the more precise diagnosis
                frame = self._divergent_frame(
                    event.ctx, frozenset(re.findall(r"\w+",
                                                    event.pset or "")))
                if frame is None or frame.direct:
                    # direct one-hop guards are HVD201/HVD402 territory
                    continue
                diags.append(Diagnostic.make(
                    "HVD401",
                    f"collective `{event.kind}`"
                    + (f" (name={event.name!r})" if event.name else "")
                    + f" is guarded by the `{frame.kind}` at line "
                    f"{frame.line} whose condition is rank-tainted "
                    "through data flow (a variable or return value "
                    "derived from rank()): only some ranks reach it",
                    file=fn.module.path, line=event.line,
                    hint="make the condition replica-invariant "
                         "(allreduce the flag first) or hoist the "
                         "collective; " + _DOC_HINT))
            # a tainted argument steering a callee's guard
            for call in fn.calls:
                inter = call.tainted_params & call.callee.guard_params
                if not inter or call.callee.reached is not None:
                    continue
                callee = call.callee
                for event in callee.events:
                    if any(frame.test_params & inter
                           and not frame.balanced
                           for frame in event.ctx):
                        diags.append(Diagnostic.make(
                            "HVD401",
                            f"collective `{event.kind}` in "
                            f"{callee.qualname} is guarded by "
                            f"parameter(s) {sorted(inter)} that "
                            f"{fn.qualname} binds to a rank-tainted "
                            f"value at {_rel(fn.module.path)}:"
                            f"{call.line}: the guard differs per rank",
                            file=callee.module.path, line=event.line,
                            hint="pass a replica-invariant value, or "
                                 "restructure so every rank submits "
                                 "the collective; " + _DOC_HINT))
        return diags

    def _rule_402(self):
        diags = []
        for fn in self._all_funcs():
            events = self._frame_events(fn)
            calls = self._frame_coll_calls(fn)
            for loop in fn.loops:
                frame = loop.frame
                if not (events.get(frame) or calls.get(frame)):
                    continue
                if frame.tainted:
                    if loop.kind == "while" and frame.direct \
                            and events.get(frame):
                        continue  # HVD201's exact one-hop shape
                    diags.append(Diagnostic.make(
                        "HVD402",
                        f"`{loop.kind}` loop bound at line {loop.line} "
                        "is rank-tainted and the body submits "
                        "collectives: per-rank schedule LENGTHS "
                        "diverge (ranks run different iteration "
                        "counts), so some rank always waits on a "
                        "collective nobody else submits",
                        file=fn.module.path, line=loop.line,
                        hint="make the trip count replica-invariant "
                             "(pmax/allreduce the bound, pad the last "
                             "iterations); " + _DOC_HINT))
                elif loop.kind == "while" and any(
                        kind == "call"
                        for kind in loop.body_assigns.values()):
                    var = next(n for n, k in loop.body_assigns.items()
                               if k == "call")
                    diags.append(Diagnostic.make(
                        "HVD402",
                        f"`while` condition at line {loop.line} "
                        f"depends on `{var}`, updated inside the body "
                        "from rank-local compute: each rank's data "
                        "decides its own trip count, so collective "
                        "counts diverge (the convergence-loop stall)",
                        file=fn.module.path, line=loop.line,
                        hint=f"make `{var}` replica-invariant — e.g. "
                             "reduce it first (`done = hvd.allreduce("
                             "done_flag)`), so every rank agrees when "
                             "to stop; " + _DOC_HINT))
        return diags

    def _rule_403(self):
        diags = []
        for fn in self._all_funcs():
            if fn.reached is not None:
                continue  # the whole function is already HVD401
            for exit_ in fn.exits:
                frame = self._divergent_frame(exit_.ctx)
                if frame is None:
                    continue
                skipped = None
                for event in fn.events:
                    if event.line <= exit_.line or frame in event.ctx:
                        continue
                    if _mentions(event.pset, frame.pset_guard):
                        continue
                    if exit_.kind in ("continue", "break"):
                        loop_frames = [f for f in exit_.ctx if f.loop]
                        if loop_frames and \
                                loop_frames[-1] not in event.ctx:
                            continue
                    skipped = event
                    break
                if skipped is None:
                    for call in fn.calls:
                        if call.line <= exit_.line \
                                or not call.callee.has_coll_trans \
                                or frame in call.ctx:
                            continue
                        if exit_.kind in ("continue", "break"):
                            loop_frames = [f for f in exit_.ctx
                                           if f.loop]
                            if loop_frames and \
                                    loop_frames[-1] not in call.ctx:
                                continue
                        skipped = call
                        break
                if skipped is None:
                    continue
                what = (f"collective `{skipped.kind}`"
                        if isinstance(skipped, ScheduleEvent)
                        else f"call to `{skipped.callee.qualname}` "
                             "(which submits collectives)")
                diags.append(Diagnostic.make(
                    "HVD403",
                    f"early `{exit_.kind}` under the rank-tainted "
                    f"condition at line {frame.line} skips the {what} "
                    f"at line {skipped.line} that the other ranks "
                    "execute: schedule divergence, guaranteed stall",
                    file=fn.module.path, line=exit_.line,
                    hint="restructure so every rank reaches every "
                         "collective — move the early exit below the "
                         "collectives, or make the condition "
                         "replica-invariant; " + _DOC_HINT))
        return diags

    def _rule_404(self):
        diags = []
        cross_set_events = set()
        for fn in self._all_funcs():
            events = self._frame_events(fn)
            seen_pairs = set()
            for frame in fn.frames:
                if frame.kind != "if" or frame.partner is None \
                        or not frame.tainted or not frame.balanced:
                    continue
                key = (id(frame), id(frame.partner))
                if key in seen_pairs or (key[1], key[0]) in seen_pairs:
                    continue
                seen_pairs.add(key)
                mine = sorted((e for e in events.get(frame, [])),
                              key=lambda e: e.line)
                theirs = sorted((e for e in events.get(frame.partner,
                                                       [])),
                                key=lambda e: e.line)
                seq_a = [e.pset for e in mine]
                seq_b = [e.pset for e in theirs]
                if not seq_a or not seq_b or seq_a == seq_b:
                    continue
                if len(set(seq_a) | set(seq_b)) < 2:
                    continue
                where = mine[0] if mine else theirs[0]
                diags.append(Diagnostic.make(
                    "HVD404",
                    "branches of the rank-dependent `if` at line "
                    f"{frame.line} issue collectives on distinct "
                    f"process sets in divergent order ({seq_a} vs "
                    f"{seq_b}): ranks taking different branches wait "
                    "inside different sets' collectives — a cross-set "
                    "wait cycle that never resolves",
                    file=fn.module.path, line=where.line,
                    hint="issue cross-set collectives in one fixed "
                         "program order on every rank (hoist them out "
                         "of the rank-dependent branches); "
                         + _DOC_HINT))
            # a rank-gated collective on set A followed by an
            # unconditional collective on set B: gated ranks sit in A
            # while the rest enter B
            for event in fn.events:
                frame = self._divergent_frame(
                    event.ctx, frozenset(re.findall(r"\w+",
                                                    event.pset or "")))
                if frame is None:
                    continue
                follow = next(
                    (g for g in fn.events
                     if g.line > event.line and frame not in g.ctx
                     and g.pset != event.pset), None)
                if follow is None:
                    continue
                cross_set_events.add(id(event))
                diags.append(Diagnostic.make(
                    "HVD404",
                    f"collective `{event.kind}` on process set "
                    f"`{event.pset}` runs only under the rank-tainted "
                    f"`{frame.kind}` at line {frame.line}, while "
                    f"`{follow.kind}` on `{follow.pset}` (line "
                    f"{follow.line}) runs on every rank: gated ranks "
                    f"wait inside `{event.pset}` while the others have "
                    f"moved on to `{follow.pset}` — a cross-set wait "
                    "cycle",
                    file=fn.module.path, line=event.line,
                    hint="run cross-set collectives in the same "
                         "relative order on every rank; guard only "
                         "rank-local work; " + _DOC_HINT))
        return diags, frozenset(cross_set_events)

    def _rule_405(self):
        diags = []
        for fn in self._all_funcs():
            for event in fn.events:
                if event.op != "Adasum":
                    continue
                if event.kind.startswith(_GROUPED_PREFIX):
                    diags.append(Diagnostic.make(
                        "HVD405",
                        f"Adasum routed through `{event.kind}`: the "
                        "grouped path fuses tensors into buckets, but "
                        "Adasum's scale-invariant combination is "
                        "defined per WHOLE tensor — bucketing changes "
                        "the dot products it is built from and "
                        "silently alters the math",
                        file=fn.module.path, line=event.line,
                        hint="reduce Adasum tensors individually "
                             "(plain allreduce per tensor), or switch "
                             "the group to op=Average; " + _DOC_HINT))
                elif event.from_concat and \
                        event.kind.startswith("allreduce"):
                    diags.append(Diagnostic.make(
                        "HVD405",
                        f"Adasum over a concatenated payload at line "
                        f"{event.line}: concatenation merges tensors "
                        "into one buffer, so Adasum computes ONE "
                        "scale-invariant combination for the whole "
                        "bucket instead of one per tensor — silently "
                        "different updates",
                        file=fn.module.path, line=event.line,
                        hint="reduce each tensor separately under "
                             "Adasum — never concatenate/bucket its "
                             "inputs; " + _DOC_HINT))
            for call in fn.calls:
                inter = call.adasum_params & call.callee.grouped_op_params
                if inter:
                    diags.append(Diagnostic.make(
                        "HVD405",
                        f"Adasum passed as {sorted(inter)} into "
                        f"`{call.callee.qualname}`, which feeds it to "
                        "a grouped/bucketed collective: Adasum's "
                        "per-tensor semantics do not survive "
                        "bucketing",
                        file=fn.module.path, line=call.line,
                        hint="call the per-tensor reduction path for "
                             "Adasum, or pass op=Average/Sum here; "
                             + _DOC_HINT))
        return diags

    # -- schedule extraction ----------------------------------------------
    def schedules(self):
        self._fixpoint()
        out = []
        for mod in self.entries:
            for qual in mod.funcs:
                fn = mod.funcs[qual]
                for event in sorted(fn.events, key=lambda e: e.line):
                    out.append(event.to_dict(f"{_rel(mod.path)}:{qual}"))
        return out


def _rel(path):
    return relative_to_cwd(path)


def _suppress(diags, corpus):
    """Apply the standard ``# hvd-lint: disable=`` comments, grouped by
    the file each finding landed in (interprocedural findings may land
    in an imported module, which carries its own suppressions)."""
    by_file = {}
    for d in diags:
        by_file.setdefault(d.file, []).append(d)
    out = []
    for path, file_diags in by_file.items():
        mod = corpus.modules.get(os.path.abspath(path)) \
            or corpus.modules.get(path)
        if mod is not None:
            src = mod.src
        else:
            try:
                with open(path, encoding="utf-8",
                          errors="replace") as f:
                    src = f.read()
            except OSError:
                src = ""
        out.extend(_apply_suppressions(file_diags, src) if src
                   else file_diags)
    return sorted(out, key=Diagnostic.sort_key)


def verify_source(src, filename="<string>"):
    """Run the interprocedural verifier over one source text."""
    verifier = Verifier()
    try:
        verifier.add_source(src, filename)
    except SyntaxError as exc:
        return [Diagnostic.make(
            "HVD001", f"syntax error: {exc.msg}",
            file=filename, line=exc.lineno or 0)]
    return _suppress(verifier.run(), verifier.corpus)


def verify_paths(paths):
    """Run the interprocedural verifier over every ``.py`` file under
    ``paths``; one shared corpus, so cross-file call chains resolve."""
    verifier = Verifier()
    for path in iter_python_files(paths):
        verifier.add_path(path)
    return _suppress(verifier.run(), verifier.corpus)


def extract_schedule(src, filename="<string>"):
    """Symbolic per-rank collective schedule of one source text: a list
    of ``{function, kind, name, process_set, line, context}`` dicts in
    program order per function."""
    verifier = Verifier()
    verifier.add_source(src, filename)
    return verifier.schedules()

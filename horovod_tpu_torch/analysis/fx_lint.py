"""Layer 1: static collective-correctness analysis of traced torch programs
(port of ``horovod_tpu/analysis/jaxpr_lint.py``).

The JAX package walks a closed jaxpr. The port traces a callable with
``make_fx`` on fake tensors (shapes and dtypes only: no memory is touched,
no kernel is launched and no collective is issued) and walks the fx
graph, ``torch.cond`` and ``while_loop`` subgraphs included. It reports
the same three rules:

- **HVD101** — a collective (``psum``, ``all_gather``, ``ppermute``, …)
  on an axis that is neither bound nor declared by the caller
  (``axis_sizes`` / ``bound_axes``).
- **HVD102** — a collective nested inside ``torch.cond``/``while_loop``
  whose predicate data-flows from ``axis_index`` (the rank): ranks
  disagree on whether or how often the collective runs, and the job
  deadlocks.
- **HVD103** — ``torch.cond`` branches under a rank-dependent predicate
  whose collective sequences disagree in op/axis/shape/dtype: even when
  every rank enters a collective, the pairs exchange mismatched buffers.

**Axes on the port.** The collectives of ``parallel/axis.py`` take an axis
that is a ``ProcessGroup``, a 1-D ``DeviceMesh`` or a name. Under a lint
trace each call becomes one graph node (``hvd_lint::collective``) that
carries the op, the axis's name, the output shape and the caller's source
location. An axis is named and bound thus:

- the world group is ``hvd`` (the name :func:`runtime_axis_sizes
  <horovod_tpu_torch.analysis.runtime_axis_sizes>` gives it), and the
  string ``"hvd"`` names it while ``torch.distributed`` is initialized;
- a 1-D ``DeviceMesh`` is named by its ``mesh_dim_names``; any other
  process group by its ``group_name``;
- a group object binds its own axis: it exists, which is what an
  enclosing ``shard_map`` gives a JAX axis name;
- any other string names an axis only the caller can bind, through
  ``axis_sizes`` (the JAX ``extend_axis_env``) or ``bound_axes``.

``axis_index`` under a lint trace returns a 0-d int64 tensor made by an
``hvd_lint::axis_index`` node, the taint source: whatever it flows into is
rank-dependent, closures of a ``cond``/``while_loop`` body included. Python
control flow on the rank is gone from any trace (``if hvd.rank() == 0:``);
the offline AST rule HVD201 catches it instead. The flash kernels' wrappers
record an ``hvd_lint::kernel`` node in place of the launch.

The trace runs with TorchDynamo disabled, so that ``torch.cond`` and
``while_loop`` trace their branches as plain Python under ``make_fx`` (the
branch bodies then keep their source locations). torch is imported at
module load (the port needs it anyway); the custom ops are registered on
the first trace.
"""

import contextlib
import os
import sys
import sysconfig
import threading

import torch

from .diagnostics import Diagnostic, dedupe

#: The world group's axis name.
WORLD_AXIS = "hvd"

_DOC_HINT = "see docs/lint.md"

_state = threading.local()
_ops_lock = threading.Lock()
_OPS = {}


class UnboundAxisError(NameError):
    """``axis_size``/``axis_index`` of a name no group or caller binds (the
    JAX trace's ``unbound axis name`` NameError)."""


def tracing():
    """True inside a lint trace on this thread."""
    return getattr(_state, "axis_sizes", None) is not None


# ---------------------------------------------------------------------------
# Graph nodes: custom ops that only a lint trace ever calls
# ---------------------------------------------------------------------------

def _never(*_):
    raise RuntimeError("hvd_lint ops exist only inside a lint trace, on "
                       "fake tensors")


def _ops():
    """Register the three ``hvd_lint`` ops (once per process)."""
    with _ops_lock:
        if _OPS:
            return _OPS

        @torch.library.custom_op("hvd_lint::collective", mutates_args=())
        def collective(x: torch.Tensor, op: str, axis: str, bound: bool,
                       out_shape: list[int], sites: str) -> torch.Tensor:
            _never()

        @collective.register_fake
        def _(x, op, axis, bound, out_shape, sites):
            return x.new_empty(out_shape)

        @torch.library.custom_op("hvd_lint::axis_index", mutates_args=())
        def axis_index(axis: str) -> torch.Tensor:
            _never()

        @axis_index.register_fake
        def _(axis):
            return torch.empty((), dtype=torch.int64)

        @torch.library.custom_op("hvd_lint::kernel",
                                 mutates_args=("outputs",))
        def kernel(name: str, inputs: list[torch.Tensor],
                   outputs: list[torch.Tensor]) -> None:
            _never()

        @kernel.register_fake
        def _(name, inputs, outputs):
            return None

        _OPS.update(collective=collective, axis_index=axis_index,
                    kernel=kernel)
        return _OPS


def _is_op(node, name):
    return (node.op == "call_function"
            and str(node.target).startswith(f"hvd_lint.{name}"))


# ---------------------------------------------------------------------------
# Axis names and the caller's source location
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def axis_name(axis):
    """(name, bound by a live group) of an axis: a string, a 1-D
    ``DeviceMesh`` or a ``ProcessGroup``."""
    if isinstance(axis, str):
        return axis, axis == WORLD_AXIS and _dist() is not None
    names = getattr(axis, "mesh_dim_names", None)
    if names is not None or hasattr(axis, "get_group"):
        return (names[0] if names else f"mesh{id(axis):x}"), True
    dist = _dist()
    if dist is not None and axis is dist.group.WORLD:
        return WORLD_AXIS, True
    return f"group:{getattr(axis, 'group_name', id(axis))}", True


def axis_size(axis):
    """Ranks on ``axis`` under a lint trace: a live group's size, else the
    size the caller declared. A name bound nowhere raises
    :class:`UnboundAxisError`, as the JAX trace does."""
    name, live = axis_name(axis)
    declared = getattr(_state, "axis_sizes", None) or {}
    if name in declared:
        return int(declared[name])
    if not live:
        raise UnboundAxisError(f"unbound axis name: {name}")
    dist = _dist()
    if isinstance(axis, str):
        return dist.get_world_size()
    group = axis.get_group() if hasattr(axis, "get_group") else axis
    return dist.get_world_size(group)


_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH_ROOT = os.path.dirname(os.path.abspath(torch.__file__))
_STDLIB = os.path.abspath(sysconfig.get_paths()["stdlib"])
_HOP_FILES = (os.path.join("_higher_order_ops", "cond.py"),
              os.path.join("_higher_order_ops", "while_loop.py"))


def _user_file(path):
    if path.startswith("<"):
        return False
    path = os.path.abspath(path)
    return not (path.startswith(_PKG_ROOT) or path.startswith(_TORCH_ROOT)
                or path.startswith(_STDLIB))


def _sites():
    """The caller's source location, one ``file:line`` per level of
    ``torch.cond``/``while_loop`` nesting, outermost first, joined by
    ``|``: level ``d`` is where the user's code entered the level-``d``
    control-flow op (the last level is the call itself)."""
    frames = []
    f = sys._getframe(1)
    while f is not None:
        frames.append(f)
        f = f.f_back
    levels, last = [], None
    for f in reversed(frames):
        path = f.f_code.co_filename
        if path.endswith(_HOP_FILES):
            if last is not None:
                levels.append(last)
                last = None
        elif _user_file(path):
            last = f"{path}:{f.f_lineno}"
    levels.append(last or "<graph>:0")
    return "|".join(levels)


def _site_at(sites, depth):
    """(file, line) of nesting level ``depth`` of a ``sites`` string."""
    levels = sites.split("|")
    loc = levels[min(depth, len(levels) - 1)]
    file, _, line = loc.rpartition(":")
    return file or loc, int(line or 0)


# ---------------------------------------------------------------------------
# What the port's collectives and kernels record under a lint trace
# ---------------------------------------------------------------------------

def collective(op, x, axis, out_shape=None):
    """The graph node of collective ``op`` of ``x`` over ``axis``, whose
    result has ``out_shape`` (default: ``x``'s)."""
    name, live = axis_name(axis)
    shape = list(x.shape if out_shape is None else out_shape)
    return _ops()["collective"](x, op, name, live, shape, _sites())


def axis_index(axis):
    """The rank on ``axis`` as a traced 0-d int64 tensor."""
    name, _ = axis_name(axis)
    axis_size(axis)   # an unbound name fails the trace, as in JAX
    return _ops()["axis_index"](name)


def kernel(name, inputs, outputs):
    """Record a kernel launch that writes ``outputs`` (no launch)."""
    _ops()["kernel"](name, list(inputs), list(outputs))


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _lint_trace(axis_sizes):
    _ops()
    prev = getattr(_state, "axis_sizes", None)
    _state.axis_sizes = dict(axis_sizes or {})
    compiling = torch.compiler._is_compiling_flag
    try:
        # torch.cond/while_loop compile their branches with TorchDynamo
        # when it is on; off, they trace them as Python under make_fx.
        # torch.compiler.is_compiling() holds, as under torch.export, so
        # that model code skips its host-side checks of tensor values
        # (HF's padding warning), which a fake tensor cannot answer.
        torch.compiler._is_compiling_flag = True
        with torch._dynamo.config.patch(disable=True):
            yield
    finally:
        torch.compiler._is_compiling_flag = compiling
        _state.axis_sizes = prev


def trace(fn, *args, axis_sizes=None, **kwargs):
    """``fn(*args, **kwargs)`` traced to an fx ``GraphModule`` on fake
    tensors (the ``jax.make_jaxpr`` of the port): args may be real tensors
    on any device, nothing is computed, launched or communicated.
    ``axis_sizes`` declares named axes, as JAX's ``extend_axis_env``."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def flat(a, kw):
        return fn(*a, **kw)

    with _lint_trace(axis_sizes):
        return make_fx(flat, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(tuple(args),
                                                    dict(kwargs))


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------

def _fetch(gm, target):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def _subgraph(gm, arg):
    """The GraphModule a ``get_attr`` node names, or None."""
    if isinstance(arg, torch.fx.Node) and arg.op == "get_attr":
        obj = _fetch(gm, arg.target)
        if isinstance(obj, torch.fx.GraphModule):
            return obj
    return None


def _nodes_in(value):
    out = []
    torch.fx.node.map_arg(value, out.append)
    return out


def _storage_key(t):
    try:
        return t.untyped_storage()._cdata
    except Exception:  # noqa: BLE001 - no storage (sparse, opaque): untracked
        return None


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _arity(gm):
    return sum(1 for n in gm.graph.nodes if n.op == "placeholder")


def _collectives_in(gm, _cache=None):
    """Ordered (op, axis, shapes, dtypes, sites) of every collective in the
    graph, recursing into subgraphs."""
    if _cache is None:
        _cache = {}
    if id(gm) in _cache:
        return _cache[id(gm)]
    found = []
    _cache[id(gm)] = found
    for node in gm.graph.nodes:
        if _is_op(node, "collective"):
            x, op, axis, _, _, sites = node.args
            val = x.meta.get("val") if isinstance(x, torch.fx.Node) else x
            found.append((op, (axis,), (tuple(val.shape),),
                          (str(val.dtype),), sites))
        elif node.op == "call_function":
            for arg in _nodes_in((node.args, node.kwargs)):
                sub = _subgraph(gm, arg)
                if sub is not None:
                    found.extend(_collectives_in(sub, _cache))
    return found


class _Walker:
    """Taint-propagating graph walker.

    ``walk`` returns the taint (rank-dependence) of the graph's outputs
    given its placeholders' taint; diagnostics accumulate on
    ``self.diags`` (deduped at the end — ``while``-body fixpoint iteration
    revisits nodes). A tensor a subgraph closes over is lifted into it as
    a constant that shares its storage: tainted storages are remembered,
    so that taint follows closures."""

    def __init__(self, diags):
        self.diags = diags
        self.tainted = set()

    def walk(self, gm, bound, taint_in, depth=0):
        env = {}
        taint_in = list(taint_in)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                taint = bool(taint_in.pop(0)) if taint_in else False
            elif node.op == "get_attr":
                obj = _fetch(gm, node.target)
                taint = isinstance(obj, torch.Tensor) \
                    and _storage_key(obj) in self.tainted
            elif node.op == "output":
                return [env.get(n, False)
                        for n in _nodes_in(node.args[0])]
            else:
                taint = self._node(gm, node, bound, env, depth)
            env[node] = taint
            if taint:
                for t in _tensors(node.meta.get("val")):
                    key = _storage_key(t)
                    if key is not None:
                        self.tainted.add(key)
        return []

    def _taint(self, env, value):
        return any(env.get(n, False) for n in _nodes_in(value))

    def _node(self, gm, node, bound, env, depth):
        in_taint = self._taint(env, (node.args, node.kwargs))
        if _is_op(node, "axis_index"):
            return True
        if _is_op(node, "collective"):
            self._check_axes(node, bound, depth)
            return in_taint
        target = node.target
        if target is torch.ops.higher_order.cond:
            return self._cond(gm, node, bound, env, in_taint, depth)
        if target is torch.ops.higher_order.while_loop:
            return self._while(gm, node, bound, env, in_taint, depth)
        subs = [s for s in (_subgraph(gm, a)
                            for a in _nodes_in((node.args, node.kwargs)))
                if s is not None]
        if subs:
            # checkpoint / wrap / other subgraph ops: axes pass through
            # unchanged, taint maps conservatively from any input.
            out = in_taint
            for sub in subs:
                out = any(self.walk(sub, bound, [in_taint] * _arity(sub),
                                    depth)) or out
            return out
        return in_taint

    def _check_axes(self, node, bound, depth):
        _, op, axis, live, _, sites = node.args
        if live or axis in bound:
            return
        file, line = _site_at(sites, depth)
        bound_desc = ", ".join(sorted(bound)) if bound else "<none>"
        self.diags.append(Diagnostic.make(
            "HVD101",
            f"collective `{op}` uses axis {axis!r} which is not bound by "
            f"any process group or DeviceMesh and was not declared "
            f"(bound axes: {bound_desc})",
            file=file, line=line,
            hint="pass a ProcessGroup or a DeviceMesh dimension named "
                 f"{axis!r}, or declare it via axis_sizes= if an outer "
                 "caller binds it; " + _DOC_HINT))

    def _fit(self, taints, n, in_taint):
        """Map caller-side taints onto a subgraph's ``n`` placeholders;
        when the arity does not line up, fall back to the conservative
        any-input taint."""
        taints = list(taints)
        return taints if len(taints) == n else [in_taint] * n

    def _cond(self, gm, node, bound, env, in_taint, depth):
        pred, true_g, false_g, operands = node.args[:4]
        branches = [_subgraph(gm, true_g), _subgraph(gm, false_g)]
        pred_tainted = self._taint(env, pred)
        op_taints = [env.get(n, False) for n in _nodes_in(operands)]
        out_taint = in_taint
        branch_colls = []
        for br in branches:
            if br is None:
                branch_colls.append([])
                continue
            outs = self.walk(br, bound,
                             self._fit(op_taints, _arity(br), in_taint),
                             depth + 1)
            out_taint = out_taint or any(outs)
            branch_colls.append(_collectives_in(br))

        if pred_tainted and any(branch_colls):
            first = next(c for colls in branch_colls for c in colls)
            file, line = _site_at(first[4], depth)
            ops = sorted({c[0] for colls in branch_colls for c in colls})
            self.diags.append(Diagnostic.make(
                "HVD102",
                "cond predicate depends on axis_index (the rank) and a "
                f"branch contains collective(s) {', '.join(ops)}: ranks "
                "will disagree on which collective program point runs, "
                "and a collective entered by some ranks only never pairs "
                "— this deadlocks or corrupts the exchange",
                file=file, line=line,
                hint="hoist the collective out of the cond (compute both "
                     "sides, select with torch.where), or make the "
                     "predicate rank-invariant; " + _DOC_HINT))
            # The pairing check is only meaningful when ranks take
            # different branches and more than one branch exchanges data.
            with_colls = [c for c in branch_colls if c]
            if len(with_colls) >= 2:
                sigs = {tuple(c[:4] for c in colls) for colls in with_colls}
                if len(sigs) > 1:
                    self.diags.append(Diagnostic.make(
                        "HVD103",
                        "collectives in the branches of this "
                        "rank-dependent cond disagree on "
                        "op/axis/shape/dtype — ranks taking different "
                        "branches would exchange mismatched buffers",
                        file=file, line=line,
                        hint="give every branch an identical collective "
                             "signature, or restructure without "
                             "rank-dependent branching; " + _DOC_HINT))
        return out_taint

    def _while(self, gm, node, bound, env, in_taint, depth):
        cond_g, body_g, carried, additional = node.args[:4]
        cond_j, body_j = _subgraph(gm, cond_g), _subgraph(gm, body_g)
        carry = [env.get(n, False) for n in _nodes_in(carried)]
        extra = [env.get(n, False) for n in _nodes_in(additional)]
        pred_tainted = in_taint
        if cond_j is not None and body_j is not None:
            # Fixpoint over the carry: the body can taint a carried value
            # (e.g. accumulate axis_index) that feeds the next trip's
            # predicate. Converges in <= len(carry)+1 rounds; cap small.
            for _ in range(4):
                pred = self.walk(
                    cond_j, bound,
                    self._fit(carry + extra, _arity(cond_j), in_taint),
                    depth + 1)
                pred_tainted = any(pred)
                body_out = self.walk(
                    body_j, bound,
                    self._fit(carry + extra, _arity(body_j), in_taint),
                    depth + 1)
                body_out = self._fit(body_out, len(carry), any(body_out))
                new_carry = [a or b for a, b in zip(carry, body_out)]
                if new_carry == carry:
                    break
                carry = new_carry
        body_colls = _collectives_in(body_j) if body_j is not None else []
        if pred_tainted and body_colls:
            file, line = _site_at(body_colls[0][4], depth)
            ops = sorted({c[0] for c in body_colls})
            self.diags.append(Diagnostic.make(
                "HVD102",
                "while-loop trip count depends on axis_index (the rank) "
                f"and the body contains collective(s) {', '.join(ops)}: "
                "ranks run the collective a different number of times and "
                "the program deadlocks",
                file=file, line=line,
                hint="make the trip count rank-invariant (e.g. psum/pmax "
                     "the bound first), or mask the extra iterations "
                     "instead of skipping them; " + _DOC_HINT))
        return in_taint or any(carry) or pred_tainted


def check_graph(gm, axis_sizes=None, bound_axes=None):
    """Analyze a traced ``GraphModule``; returns a list of
    :class:`Diagnostic`.

    ``bound_axes`` (or the keys of ``axis_sizes``) are axis names the
    caller promises an enclosing group binds — collectives over them are
    legal though no group object in this graph names them.
    """
    bound = set(bound_axes or ())
    bound |= set(axis_sizes or ())
    diags = []
    _Walker(diags).walk(gm, frozenset(bound), [False] * _arity(gm))
    return dedupe(diags)


def _unbound_cause(exc):
    while exc is not None:
        if isinstance(exc, UnboundAxisError):
            return exc
        exc = exc.__cause__ or exc.__context__
    return None


def check_fn(fn, *args, axis_sizes=None, **kwargs):
    """Trace ``fn(*args, **kwargs)`` and analyze the resulting graph.

    ``axis_sizes`` maps externally-bound axis names to sizes — the axes an
    enclosing caller binds around ``fn``. An axis bound nowhere at all,
    asked for its size or index, surfaces as an HVD101 diagnostic instead
    of an error.

    Accepts tensors on any device (fake copies are traced); nothing is
    computed, launched or communicated.
    """
    axis_sizes = dict(axis_sizes or {})
    try:
        gm = trace(fn, *args, axis_sizes=axis_sizes, **kwargs)
    except Exception as exc:  # noqa: BLE001 - only the unbound axis is ours
        cause = _unbound_cause(exc)
        if cause is None:
            raise
        return [Diagnostic.make(
            "HVD101",
            f"tracing failed with {cause}: the function performs a "
            "collective over an axis bound by no process group or "
            "DeviceMesh and not declared via axis_sizes=",
            hint="pass axis_sizes={'<axis>': <size>} if an outer caller "
                 "binds it, or pass the group itself; " + _DOC_HINT)]
    return check_graph(gm, axis_sizes=axis_sizes)

"""The ``tf.function`` bridge on torch (port of
``horovod_tpu/tensorflow/compile.py``): run TensorFlow-2 model math on the
card.

The JAX package traces a TF callable once with ``tf.function``, walks the
``ConcreteFunction`` graph and rebuilds it as a pure JAX function over a
flat variable dict. The port splits that walk in two, so that the card
needs no TensorFlow:

- **the TF side** (:func:`record_function`, needs tensorflow) turns the
  traced ``ConcreteFunction`` into a *record*: plain data with no TF object
  in it. It holds the ops of the graph and of every function it calls, in
  order, each with its type, name, input and output tensor names, static
  output shapes and attrs decoded to Python values (a ``Const`` keeps its
  numpy value); the variables (name, shape, dtype, trainable, how they
  were initialised, and their values only when asked); the non-resource
  captures as numpy arrays; and the structure of the outputs. The
  binding's rank and size ops are kept as named queries that resolve when
  the record runs, against the runtime of the process that runs it.
  :func:`save_record` writes one ``.npz`` (a JSON graph beside the arrays)
  and :func:`load_record` reads it back with numpy and the standard
  library only.
- **the interpreter** (:class:`_GraphInterpreter`, torch only) runs a
  record. Gradients need no translation: torch autograd differentiates the
  interpreted ops. Its op table (``OPS``: op type -> handler) covers every
  op type the JAX bridge dispatches; an op it lacks raises
  ``NotImplementedError`` naming the node.

:class:`CompiledFunction` is an ``nn.Module`` over a record: the trainable
variables are its parameters (fp32 masters), the others its buffers, on an
explicit device (the runtime's by default).

    compiled = tpu_compile(loss_fn, example_inputs=(x, y))   # TF here
    loss = compiled(x, y)
    opt = torch.optim.SGD(compiled.parameters(), lr=0.1)
    step = compiled.make_train_step(opt)
    loss = step((x, y))
    compiled.copy_params_to_variables()                      # back to TF

    save_record(record_function(loss_fn, example_inputs=(x, y)), "m.npz")
    compiled = CompiledFunction.from_record("m.npz", seed=0)  # no TF

How the interpreter runs a graph:

- **Shapes.** Values that depend on no input's values, no variable and no
  random draw (``tf.shape``-based batch math, shape-derived masks) stay
  host values: numpy arrays, computed by the same handlers on CPU tensors
  outside any trace. So batch math works at any batch size, a lint trace
  (``verify=``) keeps them concrete, and a mask that is a compile-time
  constant is read on the host without waiting for the device. A large
  shape-derived value stays a broadcast view (zero strides), so that a
  ``ones_like`` of the attention scores costs no memory.
- **Only what is needed runs.** The graph's outputs and its variable
  writes are the roots; an op whose outputs nothing needs does not run,
  and an op whose outputs only a ``Shape``-like op reads runs on ``meta``
  tensors. With attention routed to the flash kernels, the dense scores
  and their softmax are computed only if the kernels cannot take a site.
- **Layouts.** NHWC convolutions, pools and batch norms run on the
  channels-last view ``x.permute(0, 3, 1, 2)``, which cuDNN takes without
  a copy.
- **Attention.** ``Einsum -> [scale] -> [mask] -> Softmax -> Einsum`` sites
  whose scale and mask are compile-time constants (a mask that keeps
  everything, or a bottom-right causal one) call the port's
  :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention`; routing
  follows ``bridge_flash_enabled``. Any other site takes the einsum
  lowering and calls ``note_flash_fallback``.
- **Randomness.** Each random op is a site with a number (per call
  prefix, in first-run order); a site draws from a ``torch.Generator``
  seeded from the caller's ``rng=`` (an int) and its number. A graph with
  a random op and no ``rng=`` raises.
- **Dtypes.** int64 and float64 stay whole (the JAX bridge narrows them to
  32 bits under x64-off).

Shapes are those of the actual inputs; data-dependent TF control flow
(``tf.while_loop``/``tf.cond`` on values) is out of scope, as in the JAX
bridge.
"""

import base64
import json
import math
import re

import numpy as np
import torch
import torch.nn.functional as F

from .. import basics
from ..analysis import fx_lint
from ..ops import flash_attention as fa

RECORD_FORMAT = "horovod_tpu_torch.tf_record"
RECORD_VERSION = 1
_RECORD_KEY = "__record__"

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NUMPY_OF_TORCH = {t: np.dtype(n) for n, t in _TORCH_DTYPES.items()
                   if n != "bfloat16"}
_TORCH_OF_NUMPY = {n: t for t, n in _NUMPY_OF_TORCH.items()}


def _tdt(name):
    """TF dtype name -> torch dtype (64-bit types stay 64-bit)."""
    if name not in _TORCH_DTYPES:
        raise NotImplementedError(f"tf dtype {name} has no torch mapping")
    return _TORCH_DTYPES[name]


# ===========================================================================
# The TF side: a traced ConcreteFunction -> a record (needs tensorflow)
# ===========================================================================

def _tf():
    import tensorflow as tf
    return tf


def def_function_type():
    tf = _tf()
    return type(tf.function(lambda: None))


def _concrete_function(fn, example_inputs, input_signature, dynamic_batch):
    """Trace as the JAX bridge does (``compile.py:1332-1350``): with
    ``dynamic_batch`` the leading dim of each example input is None, so
    that ``tf.shape``-based batch math stays symbolic."""
    tf = _tf()
    if not isinstance(fn, def_function_type()):
        fn = tf.function(fn)
    if input_signature is not None:
        return fn.get_concrete_function(*input_signature)
    if example_inputs is None:
        raise ValueError("pass example_inputs or input_signature")
    specs = []
    for a in example_inputs:
        shape = list(np.shape(a))
        if dynamic_batch and shape:
            shape[0] = None
        specs.append(tf.TensorSpec(shape, tf.as_dtype(
            a.dtype if tf.is_tensor(a) else np.asarray(a).dtype)))
    return fn.get_concrete_function(*specs)


def _decode_bytes(b):
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError:
        return {"b64": base64.b64encode(b).decode("ascii")}


class _Arrays:
    """The numpy side of a record being written: each array gets a key."""

    def __init__(self):
        self.arrays = {}

    def add(self, arr, dtype=None):
        key = f"a{len(self.arrays)}"
        if dtype == "bfloat16":       # numpy has no bfloat16: keep the bits
            arr = np.asarray(arr).view(np.uint16)
        self.arrays[key] = np.array(arr, order="C")   # keeps 0-d arrays 0-d
        return {"array": key, **({"dtype": dtype} if dtype else {})}


def _tensor_proto(tp, arrays):
    tf = _tf()
    arr = tf.make_ndarray(tp)
    if arr.dtype == object:         # string constants (asserts, names)
        decoded = np.vectorize(lambda b: b.decode("utf-8", "replace"),
                               otypes=[object])(arr)
        return {"str": decoded.tolist()}
    return arrays.add(arr, "bfloat16" if arr.dtype.name == "bfloat16"
                      else None)


def _shape_proto(sp):
    if sp.unknown_rank:
        return None
    return [None if d.size < 0 else int(d.size) for d in sp.dim]


def _decode_attr(av, arrays):
    tf = _tf()
    kind = av.WhichOneof("value")
    if kind is None:
        return None
    if kind == "s":
        return _decode_bytes(av.s)
    if kind in ("i", "f", "b"):
        return getattr(av, kind)
    if kind == "type":
        return tf.as_dtype(av.type).name
    if kind == "shape":
        return _shape_proto(av.shape)
    if kind == "tensor":
        return _tensor_proto(av.tensor, arrays)
    if kind == "func":
        return {"func": av.func.name}
    if kind == "placeholder":
        return {"placeholder": av.placeholder}
    lv = av.list
    for field, dec in (("s", _decode_bytes), ("i", int), ("f", float),
                       ("b", bool), ("type", lambda t: tf.as_dtype(t).name),
                       ("shape", _shape_proto),
                       ("tensor", lambda t: _tensor_proto(t, arrays)),
                       ("func", lambda f: {"func": f.name})):
        vals = getattr(lv, field)
        if len(vals):
            return [dec(v) for v in vals]
    return []


def _is_hvd_query(op):
    """The binding's rank/size ops: a ``tf.py_function`` in elastic mode,
    else a scalar int32 constant, named by the binding's markers."""
    leaf = op.name.rsplit("/", 1)[-1]
    if not leaf.startswith("horovod_"):
        return False
    if op.type == "EagerPyFunc":
        return True
    return (op.type == "Const" and op.outputs[0].shape.rank == 0
            and op.outputs[0].dtype.name == "int32")


def _record_graph(graph, arrays):
    ops = []
    for op in graph.get_operations():
        attrs = {k: _decode_attr(v, arrays)
                 for k, v in sorted(op.node_def.attr.items())
                 if not k.startswith("_")}
        entry = {"type": op.type, "name": op.name,
                 "inputs": [t.name for t in op.inputs],
                 "outputs": [t.name for t in op.outputs],
                 "shapes": [None if t.shape.rank is None
                            else t.shape.as_list() for t in op.outputs],
                 "attrs": attrs}
        if _is_hvd_query(op):
            # A named query: resolved when the record runs, never here.
            entry.update(type="EagerPyFunc", attrs={})
        ops.append(entry)
    return {"inputs": [t.name for t in graph.inputs],
            "outputs": [t.name for t in graph.outputs], "ops": ops}


def _skeleton(struct, out_names):
    tf = _tf()
    if struct is None:
        return None
    if tf.is_tensor(struct):
        return out_names.index(struct.name)
    if isinstance(struct, dict):
        return {"dict": [[k, _skeleton(v, out_names)]
                         for k, v in struct.items()]}
    if isinstance(struct, (list, tuple)):
        kind = "list" if isinstance(struct, list) else "tuple"
        return {kind: [_skeleton(v, out_names) for v in struct]}
    raise NotImplementedError(
        f"output of type {type(struct).__name__} cannot be recorded")


def _init_stats(value):
    """How a variable was initialised, without its weights: a constant
    fill, or the standard deviation to draw it with."""
    v = np.asarray(value)
    if v.size == 0 or (v == v.flat[0]).all():
        return {"fill": float(v.flat[0]) if v.size else 0.0}
    return {"normal": float(np.std(v.astype(np.float64)))}


def _record(cf, weights):
    """(record, arrays, values) of a ConcreteFunction: ``values`` are the
    variables' current values as numpy (always returned; stored in the
    record only with ``weights``)."""
    tf = _tf()
    from tensorflow.python.framework import function_def_to_graph
    arrays = _Arrays()
    variables, values, handles, seen = [], {}, [], set()
    for v in cf.variables:
        if v.name in seen:
            raise ValueError(f"duplicate variable name {v.name}")
        seen.add(v.name)
        # Match captures by handle identity, holding the pairs alive (an
        # id()-keyed map could alias a collected handle's id).
        handles.append((v.handle, v.name))
        val = v.numpy()
        values[v.name] = val
        entry = {"name": v.name, "shape": list(val.shape),
                 "dtype": v.dtype.name, "trainable": bool(v.trainable),
                 "init": _init_stats(val)}
        if weights:
            entry["value"] = arrays.add(val, v.dtype.name
                                        if v.dtype.name == "bfloat16"
                                        else None)
        variables.append(entry)
    captures = {}
    for ext, internal in cf.graph.captures:
        if ext.dtype == tf.resource:
            name = next((nm for h, nm in handles if h is ext), None)
            if name is None:
                raise NotImplementedError(
                    f"captured resource {internal.name} is not a model "
                    "variable (tables/iterators are out of scope)")
            captures[internal.name] = {"variable": name}
        else:
            captures[internal.name] = arrays.add(ext.numpy())
    args = [t for t in cf.graph.inputs if t.name not in captures]
    functions = {}
    for fdef in cf.graph.as_graph_def().library.function:
        fg = function_def_to_graph.function_def_to_graph(fdef)
        functions[fdef.signature.name] = _record_graph(fg, arrays)
    out_names = [t.name for t in cf.graph.outputs]
    record = {
        "format": RECORD_FORMAT, "version": RECORD_VERSION,
        "graph": _record_graph(cf.graph, arrays), "functions": functions,
        "args": [{"name": t.name, "shape": t.shape.as_list(),
                  "dtype": t.dtype.name} for t in args],
        "variables": variables, "captures": captures,
        "structure": _skeleton(cf.structured_outputs, out_names),
    }
    return record, arrays.arrays, values


def record_function(fn, example_inputs=None, input_signature=None,
                    dynamic_batch=True, weights=False):
    """Trace ``fn`` with ``tf.function`` (as :func:`tpu_compile` does) and
    return its record: ``{"record": <JSON-able dict>, "arrays": {key:
    ndarray}}``. With ``weights`` the variables' values are stored too;
    without, a record carries only how each was initialised (a fill value
    or a standard deviation). Needs tensorflow."""
    cf = _concrete_function(fn, example_inputs, input_signature,
                            dynamic_batch)
    record, arrays, _ = _record(cf, weights)
    return {"record": record, "arrays": arrays}


def save_record(rec, path):
    """Write a record as one compressed ``.npz``: the JSON graph under
    ``__record__`` beside its arrays."""
    blob = np.frombuffer(json.dumps(rec["record"]).encode("utf-8"),
                         np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **{_RECORD_KEY: blob}, **rec["arrays"])


def load_record(path):
    """Read a record written by :func:`save_record` (numpy and the
    standard library only)."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != _RECORD_KEY}
        record = json.loads(z[_RECORD_KEY].tobytes().decode("utf-8"))
    if record.get("format") != RECORD_FORMAT:
        raise ValueError(f"{path}: not a tf.function record")
    if record.get("version") != RECORD_VERSION:
        raise ValueError(f"{path}: record version {record.get('version')}, "
                         f"this bridge reads {RECORD_VERSION}")
    return {"record": record, "arrays": arrays}


# ===========================================================================
# The interpreter (torch only)
# ===========================================================================

class _Var:
    """Resource-handle token flowing through the interpreted graph."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name


class _Op:
    __slots__ = ("type", "name", "inputs", "outputs", "shapes", "attrs")

    def __init__(self, d):
        self.type = d["type"]
        self.name = d["name"]
        self.inputs = d["inputs"]
        self.outputs = d["outputs"]
        self.shapes = d["shapes"]
        self.attrs = d["attrs"]

    def attr(self, key, default=None):
        return self.attrs.get(key, default)


class _Graph:
    """A recorded graph with its producer/consumer maps."""

    def __init__(self, d):
        self.inputs = d["inputs"]
        self.outputs = d["outputs"]
        self.ops = [_Op(o) for o in d["ops"]]
        self.index = {op.name: i for i, op in enumerate(self.ops)}
        self.producer, self.consumers, self._rank = {}, {}, {}
        for op in self.ops:
            for t, shape in zip(op.outputs, op.shapes):
                self.producer[t] = op
                self._rank[t] = None if shape is None else len(shape)
            for t in op.inputs:
                self.consumers.setdefault(t, []).append(op)

    def rank(self, tensor):
        return self._rank.get(tensor)


_SKIP = object()

_RANDOM_OPS = ("RandomUniform", "RandomStandardNormal",
               "StatelessRandomUniformV2", "StatelessRandomNormalV2")
#: Ops that read only the shape (and dtype) of their first input.
_SHAPE_READERS = frozenset({"Shape", "ShapeN", "Size", "Rank", "ZerosLike",
                            "OnesLike"})
#: Ops that run whether or not their outputs are read.
_ROOTS = frozenset({"AssignVariableOp", "AssignAddVariableOp",
                    "AssignSubVariableOp", "StatefulPartitionedCall"})
#: Ops never folded into host values even when every input is one.
_NOT_FOLDED = frozenset({
    "Const", "ReadVariableOp", "ResourceGather", "AssignVariableOp",
    "AssignAddVariableOp", "AssignSubVariableOp", "PartitionedCall",
    "StatefulPartitionedCall", "EagerPyFunc", "StatelessRandomGetKeyCounter",
    "StatelessRandomGetAlg", "Shape", "ShapeN", "Size", "Rank", "ZerosLike",
    "OnesLike", *_RANDOM_OPS})


def _static(x):
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _static_ints(x, what):
    """Shape-like operand -> python int list (must be a host value)."""
    if isinstance(x, torch.Tensor):
        if getattr(x, "hvd_host", False):     # a host value being folded
            return [int(v) for v in x.reshape(-1).tolist()]
        raise NotImplementedError(
            f"{what} must be a compile-time value (shapes come from the "
            "graph's shape math); got a tensor computed on the device")
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _compact(t):
    """A view of ``t`` with its zero-stride (broadcast) dims cut to 1."""
    idx = tuple(slice(0, 1) if st == 0 and n > 1 else slice(None)
                for st, n in zip(t.stride(), t.shape))
    return t[idx]


def _np_compact(a):
    a = np.asarray(a)
    idx = tuple(slice(0, 1) if st == 0 and n > 1 else slice(None)
                for st, n in zip(a.strides, a.shape))
    return a[idx]


def _host_tensor(a):
    """A host value (numpy, possibly a broadcast view) as a CPU tensor of
    the same shape; broadcast dims stay zero-stride."""
    a = np.asarray(a)
    c = np.array(_np_compact(a), copy=True)
    return torch.from_numpy(c).expand(a.shape)


def _host_value(t):
    """A CPU tensor back to a host value (numpy shares its strides)."""
    if isinstance(t, tuple):
        return tuple(_host_value(x) for x in t)
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return t


def _fold(seed, n):
    """A 63-bit seed from (seed, n): a site's generator, or a rank's fold."""
    return int(np.random.SeedSequence([int(seed), int(n)])
               .generate_state(1, np.uint64)[0] >> 1)


def _hvd_query_value(name):
    """Resolve one of the binding's rank/size queries to this process's
    value. Foreign py_functions are host calls no replay can make."""
    from ..process_sets import process_set_by_id
    leaf = name.rsplit("/", 1)[-1]
    if "horovod_local_rank" in leaf:
        return np.int32(basics.local_rank())
    if "horovod_local_size" in leaf:
        return np.int32(basics.local_size())
    if "horovod_rank" in leaf:
        return np.int32(basics.rank())
    m = re.search(r"horovod_process_set_included_ps(\d+)", leaf)
    if m:
        ps = process_set_by_id(int(m.group(1)))
        if ps is None:
            raise ValueError(f"no process set with id {m.group(1)}")
        return np.int32(1 if ps.included() else 0)
    if "horovod_process_set_included" in leaf:
        raise NotImplementedError(
            f"EagerPyFunc {name!r}: process_set_included_op over an "
            "unregistered process set (id None) cannot be resolved in a "
            "compiled program; add the process set before tracing")
    m = re.search(r"horovod_size_ps(\d+)", leaf)
    if m:
        from . import _process_set_size
        return np.int32(_process_set_size(int(m.group(1))))
    if "horovod_size" in leaf:
        return np.int32(basics.size())
    raise NotImplementedError(
        f"EagerPyFunc {name!r}: arbitrary py_function host calls cannot run "
        "inside a compiled program. If this is one of the binding's "
        "rank/size ops created with a custom name=, keep the default name: "
        "the bridge resolves them by their name markers")


# ---------------------------------------------------------------------------
# Flash-attention routing (Einsum -> [scale] -> [mask] -> Softmax -> Einsum)
# ---------------------------------------------------------------------------

def _einsum_labels(op):
    """Parse a 2-operand, rank-4, no-ellipsis einsum equation into (lhs0,
    lhs1, out) label strings; None when it does not qualify."""
    eq = op.attr("equation")
    if not isinstance(eq, str) or "..." in eq or "->" not in eq:
        return None
    lhs, out = eq.split("->")
    parts = lhs.split(",")
    if len(parts) != 2:
        return None
    a, b = parts
    if not (len(a) == len(b) == len(out) == 4):
        return None
    if len(set(a)) != 4 or len(set(b)) != 4 or len(set(out)) != 4:
        return None
    return a, b, out


def _match_attention(g, sm):
    """The JAX bridge's matcher (``compile.py:286``) on a record: the keras
    / HF attention chain around a Softmax op, identified by einsum-label
    bookkeeping. Returns [(combine einsum name, plan)]; a plan names the
    tensors the flash call reads."""
    chain = g.producer[sm.inputs[0]]
    scale_name = scale_kind = mask_name = mask_kind = neg_name = None
    for _ in range(3):
        if chain.type in ("Mul", "RealDiv"):
            if scale_name:
                return None
            i0, i1 = chain.inputs
            if chain.type == "RealDiv":
                if g.rank(i1) == 0:
                    scale_name, scale_kind = i1, "div"
                    chain = g.producer[i0]
                    continue
                return None
            if g.rank(i1) == 0:
                scale_name, scale_kind, chain = i1, "mul", g.producer[i0]
                continue
            if g.rank(i0) == 0:
                scale_name, scale_kind, chain = i0, "mul", g.producer[i1]
                continue
            return None
        if chain.type in ("Add", "AddV2"):
            if mask_name:
                return None
            i0, i1 = chain.inputs
            if g.producer[i0].type in ("Einsum", "Mul", "RealDiv"):
                mask_name, mask_kind, chain = i1, "add", g.producer[i0]
                continue
            if g.producer[i1].type in ("Einsum", "Mul", "RealDiv"):
                mask_name, mask_kind, chain = i0, "add", g.producer[i1]
                continue
            return None
        if chain.type == "SelectV2":
            if mask_name:
                return None
            cond, on_true, on_false = chain.inputs
            mask_name, mask_kind, neg_name = cond, "select", on_false
            chain = g.producer[on_true]
            continue
        break
    if chain.type != "Einsum":
        return None
    e1 = chain
    labels = _einsum_labels(e1)
    if labels is None:
        return None
    a_l, b_l, s_l = labels
    contracted = (set(a_l) & set(b_l)) - set(s_l)
    if len(contracted) != 1:
        return None
    h = contracted.pop()
    sk = s_l[-1]
    in_a, in_b = sk in a_l, sk in b_l
    if in_a == in_b:
        return None
    k_l, k_t = (a_l, e1.inputs[0]) if in_a else (b_l, e1.inputs[1])
    q_l, q_t = (b_l, e1.inputs[1]) if in_a else (a_l, e1.inputs[0])
    shared_bh = [lab for lab in s_l if lab in q_l and lab in k_l]
    if len(shared_bh) != 2:
        return None
    bb, hh = shared_bh
    sq_set = set(q_l) - {bb, hh, h}
    if len(sq_set) != 1:
        return None
    sq = sq_set.pop()
    if set(s_l) != {bb, hh, sq, sk} or set(k_l) != {bb, hh, sk, h}:
        return None
    matches = []
    for e2 in g.consumers.get(sm.outputs[0], []):
        if e2.type != "Einsum":
            continue
        labels2 = _einsum_labels(e2)
        if labels2 is None:
            continue
        l20, l21, o_l = labels2
        if g.producer[e2.inputs[0]] is sm:
            p_l, v_l, v_t = l20, l21, e2.inputs[1]
        elif g.producer[e2.inputs[1]] is sm:
            p_l, v_l, v_t = l21, l20, e2.inputs[0]
        else:
            continue
        trans = {p_l[i]: s_l[i] for i in range(4)}
        c2 = (set(p_l) & set(v_l)) - set(o_l)
        if len(c2) != 1 or trans[next(iter(c2))] != sk:
            continue
        hv = [lab for lab in v_l if lab not in trans]
        if len(hv) != 1:
            continue
        tv = [trans.get(lab, "HV") for lab in v_l]
        if set(tv) != {bb, hh, sk, "HV"}:
            continue
        to = [trans.get(lab, "HV") for lab in o_l]
        if set(to) != {bb, hh, sq, "HV"}:
            continue
        matches.append((e2.name, {
            "q": q_t, "k": k_t, "v": v_t,
            "perm_q": tuple(q_l.index(x) for x in (bb, hh, sq, h)),
            "perm_k": tuple(k_l.index(x) for x in (bb, hh, sk, h)),
            "perm_v": tuple(tv.index(x) for x in (bb, hh, sk, "HV")),
            "out_perm": tuple((bb, hh, sq, "HV").index(x) for x in to),
            "scale": scale_name, "scale_kind": scale_kind,
            "mask": mask_name, "mask_kind": mask_kind, "neg": neg_name,
        }))
    return matches


def _attention_plans(g):
    plans = {}
    for op in g.ops:
        if op.type != "Softmax":
            continue
        for name, plan in _match_attention(g, op) or ():
            plans[name] = plan
    return plans


def _plan_deps(plan):
    return [plan[k] for k in ("q", "k", "v", "scale", "mask", "neg")
            if plan[k] is not None]


def _classify_static_mask(mval, kind, n_q, n_k):
    """('none', 0) for a mask that keeps everything, ('causal', q_offset)
    for a (broadcast) bottom-right-aligned causal pattern, else None. The
    mask is a host value; its broadcast dims are read once."""
    m = _np_compact(mval)
    if kind == "select":
        if m.dtype != np.bool_:
            return None
        keep, blocked = m, ~m
    else:
        m = m.astype(np.float32)
        keep, blocked = m == 0, m <= -1e8
    if not (keep | blocked).all():
        return None
    if keep.all():
        return "none", 0
    if keep.ndim < 2:
        return None
    keep = np.broadcast_to(keep, keep.shape[:-2] + (n_q, n_k)) \
        if keep.shape[-2:] != (n_q, n_k) else keep
    if keep.shape[-2:] != (n_q, n_k):
        return None
    flat = keep.reshape(-1, n_q, n_k)
    if not (flat == flat[0]).all():
        return None
    causal = np.tril(np.ones((n_q, n_k), bool), k=n_k - n_q)
    if (flat[0] == causal).all():
        return "causal", n_k - n_q
    return None


def _try_flash_attention(interp, plan):
    """The recognised attention site on the flash kernels, or None (the
    caller takes the einsum lowering)."""
    q, k, v = (interp.value(plan[n]) for n in ("q", "k", "v"))
    if not all(isinstance(x, torch.Tensor) and x.dim() == 4
               for x in (q, k, v)):
        return None
    qt = q.permute(plan["perm_q"])
    kt = k.permute(plan["perm_k"])
    vt = v.permute(plan["perm_v"])
    if not (qt.shape[-1] == kt.shape[-1] == vt.shape[-1]
            and qt.shape[-1] <= 128
            and qt.shape[:2] == kt.shape[:2] == vt.shape[:2]
            and kt.shape[2] == vt.shape[2]):
        fa.note_flash_fallback(
            f"unsupported attention shapes q{tuple(qt.shape)} "
            f"k{tuple(kt.shape)} v{tuple(vt.shape)}")
        return None
    dtype = torch.promote_types(torch.promote_types(qt.dtype, kt.dtype),
                                vt.dtype)
    if dtype not in (torch.float32, torch.float16, torch.bfloat16):
        fa.note_flash_fallback(f"attention in {dtype}")
        return None
    sm_scale = 1.0
    if plan["scale"] is not None:
        sval = interp.value(plan["scale"])
        if not _static(sval):
            fa.note_flash_fallback("non-constant attention scale")
            return None
        sm_scale = float(np.asarray(sval))
        if plan["scale_kind"] == "div":
            if sm_scale == 0.0:
                return None
            sm_scale = 1.0 / sm_scale
    causal, q_offset = False, 0
    if plan["mask"] is not None:
        mval = interp.value(plan["mask"])
        if not _static(mval):
            fa.note_flash_fallback(
                "attention mask is not a compile-time constant")
            return None
        if plan["mask_kind"] == "select":
            neg = interp.value(plan["neg"])
            if not _static(neg):
                fa.note_flash_fallback("non-constant masked-softmax fill")
                return None
            if not bool((_np_compact(neg) <= -1e8).all()):
                fa.note_flash_fallback(
                    "masked-softmax fill value is not a large negative")
                return None
        key = interp.host_key([mval])
        if key is not None:
            key += (plan["mask_kind"], qt.shape[2], kt.shape[2])
        if key is not None and key in interp.verdicts:
            verdict = interp.verdicts[key]
        else:
            verdict = _classify_static_mask(mval, plan["mask_kind"],
                                            qt.shape[2], kt.shape[2])
            if key is not None:
                interp.verdicts[key] = verdict
        if verdict is None:
            fa.note_flash_fallback(
                "attention mask is neither all-keep nor causal")
            return None
        kind, q_offset = verdict
        causal = kind == "causal"
    out = fa.flash_attention(qt.to(dtype), kt.to(dtype), vt.to(dtype),
                             causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset)
    return out.permute(plan["out_perm"])


# ---------------------------------------------------------------------------
# Op handlers: handler(interp, op, args) -> value | tuple | _SKIP
# ---------------------------------------------------------------------------

def _pool_pads(size, k, s, d=1):
    """TF "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _nhwc_pads(x_nchw, ksize, strides, dilations, padding, explicit=()):
    """(top, bottom, left, right) for an NCHW view of an NHWC op."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    if padding == "EXPLICIT":
        p = list(explicit)
        return (p[2], p[3], p[4], p[5])
    if padding != "SAME":
        raise NotImplementedError(f"padding {padding!r}")
    th, bh = _pool_pads(x_nchw.shape[2], ksize[0], strides[0], dilations[0])
    tw, bw = _pool_pads(x_nchw.shape[3], ksize[1], strides[1], dilations[1])
    return (th, bh, tw, bw)


def _conv(x, w_oihw, strides, dilations, pads, groups):
    th, bh, tw, bw = pads
    if th == bh and tw == bw:
        return F.conv2d(x, w_oihw, stride=strides, padding=(th, tw),
                        dilation=dilations, groups=groups)
    x = F.pad(x, (tw, bw, th, bh))
    return F.conv2d(x, w_oihw, stride=strides, dilation=dilations,
                    groups=groups)


def _h_conv2d(interp, op, args):
    x, w = interp.tensors(args[0], args[1])
    if op.attr("data_format", "NHWC") != "NHWC":
        raise NotImplementedError(
            f"Conv2D data_format {op.attr('data_format')}: the bridge "
            "runs NHWC")
    # Under compute_dtype the weights carry the chosen precision; graph
    # constants can drift activations back to fp32: follow the weight.
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    groups, rem = divmod(x.shape[-1], w.shape[2])
    if rem:
        raise NotImplementedError(
            f"Conv2D input channels {x.shape[-1]} not divisible by kernel "
            f"input channels {w.shape[2]}")
    xc = x.permute(0, 3, 1, 2)          # channels-last view, no copy
    strides = tuple(op.attr("strides")[1:3])
    dil = tuple(op.attr("dilations", [1, 1, 1, 1])[1:3])
    pads = _nhwc_pads(xc, w.shape[:2], strides, dil, op.attr("padding"),
                      op.attr("explicit_paddings", []))
    y = _conv(xc, w.permute(3, 2, 0, 1), strides, dil, pads, groups)
    return y.permute(0, 2, 3, 1)


def _h_depthwise(interp, op, args):
    x, w = interp.tensors(args[0], args[1])
    if op.attr("data_format", "NHWC") != "NHWC":
        raise NotImplementedError("DepthwiseConv2dNative: NHWC only")
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    kh, kw, cin, mult = w.shape
    xc = x.permute(0, 3, 1, 2)
    strides = tuple(op.attr("strides")[1:3])
    dil = tuple(op.attr("dilations", [1, 1, 1, 1])[1:3])
    pads = _nhwc_pads(xc, (kh, kw), strides, dil, op.attr("padding"),
                      op.attr("explicit_paddings", []))
    w_oihw = w.reshape(kh, kw, 1, cin * mult).permute(3, 2, 0, 1)
    y = _conv(xc, w_oihw, strides, dil, pads, cin)
    return y.permute(0, 2, 3, 1)


def _pool(kind):
    def handler(interp, op, args):
        x = args[0]
        ksize, strides = op.attr("ksize"), op.attr("strides")
        if ksize[0] != 1 or ksize[3] != 1 or strides[0] != 1 \
                or strides[3] != 1:
            raise NotImplementedError(
                f"{op.type} (node {op.name}): pooling over the batch or "
                "channel axis")
        if op.attr("data_format", "NHWC") != "NHWC":
            raise NotImplementedError(f"{op.type}: NHWC only")
        k, s = tuple(ksize[1:3]), tuple(strides[1:3])
        xc = x.permute(0, 3, 1, 2)
        th, bh, tw, bw = _nhwc_pads(xc, k, s, (1, 1), op.attr("padding"))
        if kind == "max":
            if th == bh and tw == bw and th <= k[0] // 2 and tw <= k[1] // 2:
                y = F.max_pool2d(xc, k, s, padding=(th, tw))
            else:
                y = F.max_pool2d(F.pad(xc, (tw, bw, th, bh),
                                       value=-math.inf), k, s)
            return y.permute(0, 2, 3, 1)
        if (th, bh, tw, bw) == (0, 0, 0, 0):
            return F.avg_pool2d(xc, k, s).permute(0, 2, 3, 1)
        # TF's SAME average pool counts only the real (unpadded) cells.
        summed = F.avg_pool2d(F.pad(xc, (tw, bw, th, bh)), k, s,
                              divisor_override=1)
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                          device=xc.device)
        count = F.avg_pool2d(F.pad(ones, (tw, bw, th, bh)), k, s,
                             divisor_override=1)
        return (summed / count).permute(0, 2, 3, 1)
    return handler


def _h_fused_batch_norm(interp, op, args):
    x, scale, offset, mean, var = args[:5]
    if op.attr("data_format", "NHWC") != "NHWC":
        raise NotImplementedError("FusedBatchNorm: NHWC only")
    eps = float(op.attr("epsilon"))
    xc = x.permute(0, 3, 1, 2)
    c = xc.shape[1]
    w, b = (interp.tensor(v, xc).float() for v in (scale, offset))
    if op.attr("is_training"):
        # running stats seeded with momentum 1.0 become the batch mean and
        # the unbiased batch variance (what TF emits for the moving
        # update), from the same pass as the normalisation.
        bmean = torch.zeros(c, dtype=torch.float32, device=xc.device)
        uvar = torch.ones(c, dtype=torch.float32, device=xc.device)
        y = F.batch_norm(xc, bmean, uvar, w, b, training=True,
                         momentum=1.0, eps=eps)
        n = xc.numel() // max(c, 1)
        bvar = uvar * ((n - 1) / max(n, 1))
        factor = float(op.attr("exponential_avg_factor", 1.0))
        if factor != 1.0:
            mean_in, var_in = (interp.tensor(v, xc).float()
                               for v in (mean, var))
            bmean = (1.0 - factor) * mean_in + factor * bmean
            uvar = (1.0 - factor) * var_in + factor * uvar
        return (y.permute(0, 2, 3, 1).to(x.dtype), bmean, uvar, bmean,
                bvar, torch.zeros_like(bvar))
    m, v = (interp.tensor(t, xc).float() for t in (mean, var))
    y = F.batch_norm(xc, m, v, w, b, training=False, eps=eps)
    return (y.permute(0, 2, 3, 1).to(x.dtype), m, v, m, v,
            torch.zeros_like(v))


def _loss_dtype(x):
    return x.dtype if x.dtype == torch.float64 else torch.float32


def _h_sparse_ce(interp, op, args):
    logits, labels = interp.tensors(args[0], args[1])
    lf = logits.to(_loss_dtype(logits))
    logp = F.log_softmax(lf, dim=-1)
    idx = labels.long().unsqueeze(-1)
    nll = -logp.gather(-1, idx).squeeze(-1)
    grad = None
    if interp.output_needed(op, 1):
        grad = logp.exp().scatter_add(-1, idx, -torch.ones_like(
            idx, dtype=lf.dtype))
    return nll, grad


def _h_softmax_ce(interp, op, args):
    logits, labels = interp.tensors(args[0], args[1])
    lf = logits.to(_loss_dtype(logits))
    lab = labels.to(lf.dtype)
    logp = F.log_softmax(lf, dim=-1)
    grad = logp.exp() - lab if interp.output_needed(op, 1) else None
    return -(lab * logp).sum(-1), grad


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _h_matmul(interp, op, args):
    a, b = _promote(*interp.tensors(args[0], args[1]))
    if op.type == "MatMul":
        ta, tb, adjoint = op.attr("transpose_a"), op.attr("transpose_b"), \
            False
    else:
        ta, tb, adjoint = op.attr("adj_x"), op.attr("adj_y"), True
    if ta:
        a = (a.conj() if adjoint and a.is_complex() else a).transpose(-1, -2)
    if tb:
        b = (b.conj() if adjoint and b.is_complex() else b).transpose(-1, -2)
    return a @ b


def _h_einsum(interp, op, args):
    plan = interp.plan(op)
    if plan is not None and fa.bridge_flash_enabled(interp.device):
        out = _try_flash_attention(interp, plan)
        if out is not None:
            return out
        args = interp.values(op.inputs)     # the lowering's own inputs
    ts = interp.tensors(*args)
    if len(ts) == 2:
        ts = _promote(*ts)
    return torch.einsum(op.attr("equation"), *ts)


def _h_bias_add(interp, op, args):
    x, b = interp.tensors(args[0], args[1])
    if op.attr("data_format", "NHWC") == "NCHW" and x.dim() == 4:
        return x + b.reshape(1, -1, 1, 1)
    return x + b


def _strided_slice(x, begin, end, strides, bm, em, elm, nam, sam):
    """tf.strided_slice: one basic index, then an index_select per dim
    with a negative step (torch slices take positive steps only)."""
    spec, negative = [], []
    n_dims = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    consumed = sum(1 for i in range(len(begin))
                   if not (elm & (1 << i) or nam & (1 << i)))
    in_dim = out_dim = 0
    for i in range(len(begin)):
        if elm & (1 << i):
            n_ell = n_dims - consumed
            spec.append(Ellipsis)
            in_dim += n_ell
            out_dim += n_ell
        elif nam & (1 << i):
            spec.append(None)
            out_dim += 1
        elif sam & (1 << i):
            spec.append(begin[i])
            in_dim += 1
        else:
            b = None if bm & (1 << i) else begin[i]
            e = None if em & (1 << i) else end[i]
            s = strides[i]
            if s < 0:
                idx = list(range(*slice(b, e, s).indices(x.shape[in_dim])))
                negative.append((out_dim, idx))
                spec.append(slice(None))
            else:
                spec.append(slice(b, e, s))
            in_dim += 1
            out_dim += 1
    y = x[tuple(spec)]
    for d, idx in negative:
        y = y.index_select(d, torch.tensor(idx, dtype=torch.int64,
                                           device=y.device))
    return y


def _h_strided_slice(interp, op, args):
    return _strided_slice(
        args[0], _static_ints(args[1], "StridedSlice begin"),
        _static_ints(args[2], "StridedSlice end"),
        _static_ints(args[3], "StridedSlice strides"),
        op.attr("begin_mask", 0), op.attr("end_mask", 0),
        op.attr("ellipsis_mask", 0), op.attr("new_axis_mask", 0),
        op.attr("shrink_axis_mask", 0))


def _h_slice(interp, op, args):
    begin = _static_ints(args[1], "Slice begin")
    size = _static_ints(args[2], "Slice size")
    return args[0][tuple(slice(b, None if s == -1 else b + s)
                         for b, s in zip(begin, size))]


def _axes(x, axes, what):
    nd = x.dim()
    return sorted({a + nd if a < 0 else a for a in _static_ints(axes, what)})


def _reduction(kind):
    def handler(interp, op, args):
        x = args[0]
        keep = bool(op.attr("keep_dims", False))
        ax = _axes(x, args[1], f"{op.type} axes")
        if not ax:      # an empty axes tensor reduces nothing
            return x
        if kind == "sum":
            y = x.sum(dim=ax, keepdim=keep)
        elif kind == "mean":
            if x.is_floating_point() or x.is_complex():
                y = x.mean(dim=ax, keepdim=keep)
            else:
                count = math.prod(x.shape[a] for a in ax)
                y = torch.div(x.sum(dim=ax, keepdim=keep), count,
                              rounding_mode="trunc")
        elif kind == "max":
            y = x.amax(dim=ax, keepdim=keep)
        elif kind == "min":
            y = x.amin(dim=ax, keepdim=keep)
        else:
            fn = {"prod": torch.prod, "all": torch.all,
                  "any": torch.any}[kind]
            y = x
            for a in reversed(ax):
                y = fn(y, dim=a, keepdim=keep)
        return y.to(x.dtype)
    return handler


def _h_arg_reduce(fn):
    def handler(interp, op, args):
        ax = int(np.asarray(args[1]))
        return fn(args[0], dim=ax).to(_tdt(op.attr("output_type", "int64")))
    return handler


def _h_reshape(interp, op, args):
    return args[0].reshape(_static_ints(args[1], "Reshape shape"))


def _h_squeeze(interp, op, args):
    dims = [int(d) for d in op.attr("squeeze_dims", [])]
    x = args[0]
    if not dims:
        return x.squeeze()
    return x.squeeze(tuple(dims))


def _h_transpose(interp, op, args):
    return args[0].permute(_static_ints(args[1], "Transpose perm"))


def _h_pack(interp, op, args):
    ts = interp.tensors(*args)
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.stack([t.to(dt) for t in ts], dim=int(op.attr("axis", 0)))


def _h_unpack(interp, op, args):
    return tuple(args[0].unbind(int(op.attr("axis", 0))))


def _h_concat(interp, op, args):
    *values, axis = args
    ts = interp.tensors(*values)
    return torch.cat(ts, dim=int(np.asarray(axis)))


def _h_split(interp, op, args):
    ax = int(np.asarray(args[0]))
    n = int(op.attr("num_split"))
    return tuple(args[1].chunk(n, dim=ax))


def _h_splitv(interp, op, args):
    x = args[0]
    sizes = _static_ints(args[1], "SplitV sizes")
    ax = int(np.asarray(args[2]))
    if -1 in sizes:
        known = sum(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = x.shape[ax] - known
    return tuple(x.split(sizes, dim=ax))


def _h_fill(interp, op, args):
    shape = _static_ints(args[0], "Fill dims")
    value = args[1]
    return interp.tensor(value, None).reshape(()).expand(shape)


def _h_like(fill):
    def handler(interp, op, args):
        x = args[0]
        shape = tuple(np.shape(x)) if not isinstance(x, torch.Tensor) \
            else tuple(x.shape)
        dt = x.dtype if isinstance(x, torch.Tensor) else \
            _TORCH_OF_NUMPY[np.asarray(x).dtype]
        npdt = _NUMPY_OF_TORCH.get(dt)
        if npdt is not None:        # a host value: shape-derived
            return np.broadcast_to(np.full((), fill, npdt), shape)
        return torch.full((), fill, dtype=dt, device=interp.device) \
            .expand(shape)
    return handler


def _h_range(interp, op, args):
    device = next((a.device for a in args[:3]
                   if isinstance(a, torch.Tensor)), None)
    s, lim, d = (np.asarray(a).item() if _static(a) else a.item()
                 for a in args[:3])
    return torch.arange(s, lim, d, dtype=_tdt(op.attr("Tidx", "int32")),
                        device=device)


def _h_broadcast_to(interp, op, args):
    return args[0].expand(_static_ints(args[1], "BroadcastTo shape"))


def _h_tile(interp, op, args):
    return args[0].repeat(_static_ints(args[1], "Tile multiples"))


def _h_gather(interp, op, args):
    x, idx = interp.tensors(args[0], args[1])
    ax = int(np.asarray(args[2]))
    if ax < 0:
        ax += x.dim()
    batch_dims = int(op.attr("batch_dims", 0))
    idx = idx.long()
    if batch_dims:
        if idx.dim() != x.dim():
            raise NotImplementedError(
                f"GatherV2 (node {op.name}) with batch_dims={batch_dims} and "
                f"indices rank {idx.dim()} != params rank {x.dim()} has no "
                "torch mapping")
        return torch.take_along_dim(x, idx, dim=ax)
    out = x.index_select(ax, idx.reshape(-1))
    return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])


def _h_resource_gather(interp, op, args):
    table = interp.read_variable(args[0], "ResourceGather")
    idx = interp.tensor(args[1], table).long()
    return table.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def _h_pad(interp, op, args):
    x = args[0]
    pads = np.asarray(args[1], np.int64).reshape(-1, 2).tolist()
    flat = [p for pair in reversed(pads) for p in pair]
    value = 0
    if op.type == "PadV2":
        value = np.asarray(args[2]).item() if _static(args[2]) \
            else args[2].item()
    return F.pad(x, flat, value=value)


def _h_cumsum(interp, op, args):
    x = args[0]
    ax = int(np.asarray(args[1]))
    if op.attr("reverse", False):
        x = x.flip(ax)
    y = x.cumsum(ax, dtype=x.dtype)
    if op.attr("exclusive", False):
        y = torch.cat([torch.zeros_like(y.narrow(ax, 0, 1)),
                       y.narrow(ax, 0, y.shape[ax] - 1)], dim=ax)
    return y.flip(ax) if op.attr("reverse", False) else y


def _h_reverse(interp, op, args):
    return args[0].flip(_static_ints(args[1], "ReverseV2 axis"))


def _h_resize(interp, op, args):
    size = _static_ints(args[1], f"{op.type} size")
    if op.attr("align_corners") or not op.attr("half_pixel_centers"):
        raise NotImplementedError(
            f"{op.type} (node {op.name}) only supports TF2 resize semantics "
            "(half_pixel_centers=True, align_corners=False)")
    x = args[0]
    xc = x.permute(0, 3, 1, 2)
    if op.type == "ResizeBilinear":    # TF outputs float32 whatever x is
        y = F.interpolate(xc.float(), size=size, mode="bilinear",
                          align_corners=False)
    else:
        y = F.interpolate(xc.float(), size=size, mode="nearest-exact") \
            .to(x.dtype)
    return y.permute(0, 2, 3, 1)


def _h_one_hot(interp, op, args):
    idx = interp.tensor(args[0], None)
    depth = int(np.asarray(args[1]))
    ax = int(op.attr("axis", -1))
    dt = _tdt(op.attr("T", "float32"))
    on, off = (interp.tensor(v, idx).to(dt) for v in args[2:4])
    hit = idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)
    if ax != -1:
        hit = hit.movedim(-1, ax)
    return torch.where(hit, on, off)


def _h_select(interp, op, args):
    ref = next((a for a in args if isinstance(a, torch.Tensor)), None)
    cond = interp.tensor(args[0], ref)
    a, b = interp.tensors(args[1], args[2])
    if op.type == "Select" and cond.dim() == 1 and a.dim() > 1:
        # Select (v1): a vector condition picks rows.
        cond = cond.reshape((-1,) + (1,) * (a.dim() - 1))
    return torch.where(cond, a, b)


def _h_cast(interp, op, args):
    return args[0].to(_tdt(op.attr("DstT")))


def _h_identity(interp, op, args):
    return args[0]


def _h_stop_gradient(interp, op, args):
    x = args[0]
    return x.detach() if isinstance(x, torch.Tensor) else x


def _h_shape(interp, op, args):
    dt = _NUMPY_OF_TORCH[_tdt(op.attr("out_type", "int32"))]
    if op.type == "ShapeN":
        return tuple(np.asarray(tuple(np.shape(a) if _static(a)
                                      else a.shape), dt) for a in args)
    x = args[0]
    shape = tuple(np.shape(x)) if _static(x) else tuple(x.shape)
    if op.type == "Shape":
        return np.asarray(shape, dt)
    if op.type == "Size":
        return dt.type(math.prod(shape))
    return np.int32(len(shape))


def _h_expand_dims(interp, op, args):
    return args[0].unsqueeze(int(np.asarray(args[1])))


def _h_l2loss(interp, op, args):
    x = args[0]
    return (x * x).sum() / 2


def _h_random(interp, op, args):
    shape = _static_ints(args[0], f"{op.type} shape")
    dt = _tdt(op.attr("dtype", "float32"))
    if interp.shape_mode:
        return torch.empty(shape, dtype=dt, device="meta")
    g = interp.generator(op)
    fn = torch.rand if "Uniform" in op.type else torch.randn
    if g is None:       # under a lint trace: shapes only
        return fn(shape, dtype=dt, device=interp.device)
    return fn(shape, dtype=dt, device=interp.device, generator=g)


def _h_assign(interp, op, args):
    token, value = args[0], args[1]
    if not isinstance(token, _Var):
        raise NotImplementedError(f"{op.type} on a non-variable resource")
    interp.assign(op, token.name, value)
    return _SKIP


def _h_read(interp, op, args):
    return interp.read_variable(args[0], "ReadVariableOp")


def _h_call(interp, op, args):
    return interp.call_function(op, args)


def _h_py_func(interp, op, args):
    return _hvd_query_value(op.name)


def _h_leaky_relu(interp, op, args):
    return F.leaky_relu(args[0], float(op.attr("alpha", 0.2)))


def _true_div(a, b):
    if not (a.is_floating_point() or a.is_complex()):
        return torch.div(a, b, rounding_mode="trunc")
    return torch.div(a, b)


def _div_no_nan(a, b):
    # Safe-denominator form: a plain where(b == 0, 0, a / b) gives NaN
    # gradients at b == 0.
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a),
                       a / torch.where(zero, torch.ones_like(b), b))


def _softmax(fn):
    def f(x):
        if x.dtype in (torch.float16, torch.bfloat16):
            return fn(x, dim=-1, dtype=torch.float32).to(x.dtype)
        return fn(x, dim=-1)
    return f


#: Elementwise ops: type -> torch function over tensors.
_ELEMENTWISE = {
    "Add": torch.add, "AddV2": torch.add, "Sub": torch.sub,
    "Mul": torch.mul, "RealDiv": torch.div, "Div": _true_div,
    "FloorDiv": lambda a, b: torch.div(a, b, rounding_mode="floor"),
    "FloorMod": torch.remainder, "Pow": torch.pow,
    "Maximum": torch.maximum, "Minimum": torch.minimum,
    "SquaredDifference": lambda a, b: torch.square(a - b),
    "DivNoNan": _div_no_nan, "Atan2": torch.atan2,
    "AddN": lambda *xs: sum(xs[1:], start=xs[0]),
    "Square": torch.square, "Sqrt": torch.sqrt, "Rsqrt": torch.rsqrt,
    "Exp": torch.exp, "Log": torch.log, "Log1p": torch.log1p,
    "Expm1": torch.expm1, "Neg": torch.neg, "Abs": torch.abs,
    "Sign": torch.sign, "Floor": torch.floor, "Ceil": torch.ceil,
    "Round": torch.round, "Rint": torch.round, "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid, "Erf": torch.erf, "Erfc": torch.erfc,
    "Erfinv": torch.erfinv, "Sin": torch.sin, "Cos": torch.cos,
    "Sinh": torch.sinh, "Cosh": torch.cosh, "Relu": torch.relu,
    "Relu6": lambda x: torch.clamp(x, 0, 6), "Elu": F.elu, "Selu": F.selu,
    "Softplus": F.softplus, "Softsign": F.softsign,
    "Softmax": _softmax(F.softmax), "LogSoftmax": _softmax(F.log_softmax),
    "Equal": torch.eq, "NotEqual": torch.ne, "Less": torch.lt,
    "LessEqual": torch.le, "Greater": torch.gt, "GreaterEqual": torch.ge,
    "LogicalAnd": torch.logical_and, "LogicalOr": torch.logical_or,
    "LogicalNot": torch.logical_not, "ClipByValue": torch.clamp,
    "Reciprocal": torch.reciprocal, "IsFinite": torch.isfinite,
    "IsNan": torch.isnan, "IsInf": torch.isinf,
}


def _elementwise(fn):
    def handler(interp, op, args):
        return fn(*interp.tensors(*args))
    return handler


#: The port's op table: op type -> handler(interp, op, args). Every op
#: type the JAX bridge dispatches (``compile.py:788-1156``) is here.
OPS = {
    "Const": lambda interp, op, args: interp.const(op),
    "Identity": _h_identity, "PreventGradient": _h_identity,
    "EnsureShape": _h_identity, "CheckNumerics": _h_identity,
    "Snapshot": _h_identity,
    "IdentityN": lambda interp, op, args: tuple(args),
    "StopGradient": _h_stop_gradient,
    "ReadVariableOp": _h_read, "ResourceGather": _h_resource_gather,
    "AssignVariableOp": _h_assign, "AssignAddVariableOp": _h_assign,
    "AssignSubVariableOp": _h_assign,
    "PartitionedCall": _h_call, "StatefulPartitionedCall": _h_call,
    "EagerPyFunc": _h_py_func,
    # TF's seed -> key/counter derivation; randomness comes from the
    # caller's rng (a generator per site), so these are inert.
    "StatelessRandomGetKeyCounter": lambda interp, op, args: (
        np.zeros([1], np.uint64), np.zeros([2], np.uint64)),
    "StatelessRandomGetAlg": lambda interp, op, args: np.int32(1),
    **{t: _h_random for t in _RANDOM_OPS},
    "Shape": _h_shape, "ShapeN": _h_shape, "Size": _h_shape,
    "Rank": _h_shape, "Reshape": _h_reshape, "Squeeze": _h_squeeze,
    "ExpandDims": _h_expand_dims, "Transpose": _h_transpose,
    "Pack": _h_pack, "Unpack": _h_unpack, "ConcatV2": _h_concat,
    "Split": _h_split, "SplitV": _h_splitv,
    "StridedSlice": _h_strided_slice, "Slice": _h_slice, "Tile": _h_tile,
    "Fill": _h_fill, "ZerosLike": _h_like(0), "OnesLike": _h_like(1),
    "Range": _h_range, "BroadcastTo": _h_broadcast_to,
    "GatherV2": _h_gather, "Pad": _h_pad, "PadV2": _h_pad,
    "Cumsum": _h_cumsum, "ReverseV2": _h_reverse,
    "ResizeNearestNeighbor": _h_resize, "ResizeBilinear": _h_resize,
    "OneHot": _h_one_hot, "Select": _h_select, "SelectV2": _h_select,
    "Cast": _h_cast, "MatMul": _h_matmul, "BatchMatMul": _h_matmul,
    "BatchMatMulV2": _h_matmul, "BatchMatMulV3": _h_matmul,
    "Einsum": _h_einsum, "BiasAdd": _h_bias_add, "Conv2D": _h_conv2d,
    "DepthwiseConv2dNative": _h_depthwise, "MaxPool": _pool("max"),
    "AvgPool": _pool("avg"), "FusedBatchNormV3": _h_fused_batch_norm,
    "SparseSoftmaxCrossEntropyWithLogits": _h_sparse_ce,
    "SoftmaxCrossEntropyWithLogits": _h_softmax_ce, "L2Loss": _h_l2loss,
    "Mean": _reduction("mean"), "Sum": _reduction("sum"),
    "Max": _reduction("max"), "Min": _reduction("min"),
    "Prod": _reduction("prod"), "All": _reduction("all"),
    "Any": _reduction("any"),
    "ArgMax": _h_arg_reduce(torch.argmax),
    "ArgMin": _h_arg_reduce(torch.argmin),
    "LeakyRelu": _h_leaky_relu,
    **{t: _elementwise(fn) for t, fn in _ELEMENTWISE.items()},
}
#: Graph inputs and no-ops: bound by the caller or skipped.
BOUND_OPS = frozenset({"Placeholder", "Arg", "_Arg", "NoOp"})


class _GraphInterpreter:
    """Run a record with torch values.

    Values are keyed by tensor name (``node:idx``). Resource handles flow
    as :class:`_Var` tokens; ``ReadVariableOp``/``ResourceGather`` resolve
    them against the params/buffers dicts and ``Assign*VariableOp`` records
    a functional update instead of mutating."""

    def __init__(self, record, arrays, device):
        self.device = device
        self.graph = _Graph(record["graph"])
        self.functions = {n: _Graph(g)
                          for n, g in record["functions"].items()}
        self.n_args = len(record["args"])
        self.consts = {}      # id(op) -> host value or CPU tensor
        self._device_consts = {}  # (id(value), device) -> device tensor
        for g in (self.graph, *self.functions.values()):
            for op in g.ops:
                if op.type == "Const":
                    self.consts[id(op)] = _decode_value(
                        op.attrs["value"], arrays, op.name)
        self.capture_values = {}
        for name, cap in record["captures"].items():
            self.capture_values[name] = (
                _Var(cap["variable"]) if "variable" in cap
                else _decode_value(cap, arrays, name))
        # The record's own arrays live as long as the interpreter: their
        # device copies are made once.
        self._const_ids = {id(v) for v in (*self.consts.values(),
                                           *self.capture_values.values())
                           if isinstance(v, np.ndarray)}
        # Folded host values, memoised per op: a key is the inputs' small
        # values or the identity of host values this interpreter made (kept
        # alive in _host_objs, so an id is never reused while it is a key).
        self._fold_memo = {}      # id(op) -> {key: host value}
        self._host_objs = {}      # id(value) -> value
        self.verdicts = {}        # attention mask verdicts, same keys
        self.rng_sites = {}
        self._numbered = set()
        self._number_rng_sites(self.graph, "")
        self._plans = {}      # id(graph) -> {einsum name: plan}
        self._modes = {}      # (id(graph), flash) -> (op modes, read set)
        self._frame = None
        self.shape_mode = False

    # -- the call --------------------------------------------------------
    def run(self, params, buffers, inputs, rng=None):
        """inputs: the graph's non-capture inputs, in order. Returns
        (flat_outputs, buffer_updates)."""
        self.params, self.buffers, self.rng = params, buffers, rng
        self.updates = {}
        if len(inputs) != self.n_args:
            raise TypeError(f"the record takes {self.n_args} inputs, got "
                            f"{len(inputs)}")
        env = {}
        for i, t in enumerate(self.graph.inputs):
            if i < self.n_args:
                env[t] = inputs[i]
            elif t in self.capture_values:
                env[t] = self.capture_values[t]
            else:
                raise KeyError(f"graph input {t} has no binding")
        env = self._run_graph(self.graph, env, prefix="")
        return [env[t] for t in self.graph.outputs], self.updates

    def _number_rng_sites(self, g, prefix):
        for op in g.ops:
            if op.type in _RANDOM_OPS:
                self.rng_sites[prefix + op.name] = len(self.rng_sites)

    def _modes_of(self, g, flash):
        """Which ops run, and how: ``value`` (computed), ``shape`` (on
        meta tensors: only a shape reader needs them), absent (nothing
        needs them). Also the set of tensors someone reads as a value."""
        key = (id(g), flash)
        if key in self._modes:
            return self._modes[key]
        plans = self.plans(g) if flash else {}
        need = {t: "value" for t in g.outputs}
        modes = {}
        for op in reversed(g.ops):
            mode = "value" if op.type in _ROOTS else None
            for t in op.outputs:
                n = need.get(t)
                if n == "value" or (n == "shape" and mode is None):
                    mode = n
            if mode is None or op.type in BOUND_OPS:
                continue
            if op.type in ("PartitionedCall", "StatefulPartitionedCall"):
                mode = "value"
            modes[op.name] = mode
            if mode == "value" and op.name in plans:
                deps = [(t, "value") for t in _plan_deps(plans[op.name])]
            elif op.type in _SHAPE_READERS:
                deps = [(t, "shape") for t in op.inputs]
            else:
                deps = [(t, mode) for t in op.inputs]
            for t, m in deps:
                if need.get(t) != "value":
                    need[t] = m
        read = {t for t, m in need.items() if m == "value"}
        self._modes[key] = (modes, read)
        return self._modes[key]

    def plans(self, g):
        if id(g) not in self._plans:
            self._plans[id(g)] = _attention_plans(g)
        return self._plans[id(g)]

    def _run_graph(self, g, env, prefix):
        flash = bool(self.plans(g)) and fa.bridge_flash_enabled(self.device)
        modes, read = self._modes_of(g, flash)
        frame = {"g": g, "env": env, "shapes": {}, "prefix": prefix,
                 "read": read, "flash": flash}
        prev, self._frame = self._frame, frame
        try:
            for op in g.ops:
                mode = modes.get(op.name)
                if mode is not None:
                    self._exec(op, mode)
        finally:
            self._frame = prev
        return env

    def _exec(self, op, mode):
        fr = self._frame
        env, shapes = fr["env"], fr["shapes"]
        if mode == "shape":
            args = [self._meta(env[t]) if t in env else shapes[t]
                    for t in op.inputs]
        else:
            # None only for the inputs of an einsum the routing plan
            # replaced (the dense scores were never computed).
            args = [env[t] if t in env else shapes.get(t) for t in op.inputs]
        self.shape_mode = mode == "shape"
        try:
            outs = self._dispatch(op, args)
        finally:
            self.shape_mode = False
        if outs is _SKIP:
            return
        if not isinstance(outs, tuple):
            outs = (outs,)
        dest = env if mode == "value" else shapes
        for t, v in zip(op.outputs, outs):
            dest[t] = v

    @staticmethod
    def _meta(v):
        if isinstance(v, torch.Tensor) and v.device.type != "meta":
            return torch.empty(v.shape, dtype=v.dtype, device="meta")
        return v

    def _dispatch(self, op, args):
        handler = OPS.get(op.type)
        if handler is None:
            raise NotImplementedError(
                f"tf op {op.type!r} (node {op.name}) has no torch mapping; "
                "add it to horovod_tpu_torch/tensorflow/compile.py")
        if args and op.type not in _NOT_FOLDED \
                and all(_static(a) for a in args):
            return self._fold(handler, op, args)
        return handler(self, op, args)

    def host_key(self, values):
        """A memo key for host values, or None: a value is known by its
        identity when this interpreter made it (or the record holds it),
        else by its bytes when it is small."""
        parts = []
        for a in values:
            if id(a) in self._const_ids or self._host_objs.get(id(a)) is a:
                parts.append(("o", id(a)))
                continue
            if not _static(a):
                return None
            c = _np_compact(a)
            if c.size > 64:
                return None
            parts.append(("v", np.shape(a), c.dtype.str, c.shape,
                          c.tobytes()))
        return tuple(parts)

    def _remember(self, memo, key, out):
        if len(self._host_objs) > 20000:     # bounded: start over
            self._fold_memo.clear()
            self._host_objs.clear()
            self.verdicts.clear()
            return
        for v in (out if isinstance(out, tuple) else (out,)):
            self._host_objs[id(v)] = v
        memo[key] = out

    def _fold(self, handler, op, args):
        """All inputs are host values: run the handler on CPU tensors,
        outside any trace, and keep the result a host value (memoised: the
        shape-derived chains of a graph give the same values every call).
        Elementwise ops run on the broadcast views' compact cores."""
        key = self.host_key(args)
        memo = self._fold_memo.setdefault(id(op), {})
        if key is not None and key in memo:
            return memo[key]
        out = self._fold_now(handler, op, args)
        if key is not None:
            self._remember(memo, key, out)
        return out

    def _fold_now(self, handler, op, args):
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            ts = [_host_tensor(a) for a in args]
            for t in ts:
                t.hvd_host = True
            if op.type in _ELEMENTWISE or op.type in ("Select", "SelectV2"):
                full = torch.broadcast_shapes(*(t.shape for t in ts))
                out = handler(self, op, [_compact(t) for t in ts])
                out = out.expand(full)
            else:
                out = handler(self, op, ts)
            return _host_value(out)

    # -- what handlers call ---------------------------------------------
    def tensor(self, v, ref):
        """``v`` as a tensor on ``ref``'s device (the interpreter's when
        ``ref`` is None); host values keep their dtype."""
        if isinstance(v, torch.Tensor):
            return v
        if not _static(v):
            raise TypeError(f"{type(v).__name__} is not a tensor value")
        device = ref.device if isinstance(ref, torch.Tensor) \
            else self.device
        key = (id(v), device)
        hit = self._device_consts.get(key)
        if hit is not None:
            return hit
        a = np.asarray(v)
        tracing = fx_lint.tracing()
        if a.ndim == 0:         # a fill on the device: no copy, no wait
            t = torch.full((), a.item(), dtype=_TORCH_OF_NUMPY[a.dtype],
                           device=device)
        else:
            core = torch.from_numpy(np.array(_np_compact(a), copy=True))
            if device.type == "cuda" and not tracing:
                # Through pinned memory: the host does not wait.
                core = core.pin_memory().to(device, non_blocking=True)
            t = core.to(device).expand(a.shape)
        if id(v) in self._const_ids and not tracing:
            self._device_consts[key] = t
        return t

    def tensors(self, *vals):
        """The values as tensors on the device of the first tensor among
        them; a 0-d host value next to a tensor stays a 0-d tensor."""
        ref = next((v for v in vals if isinstance(v, torch.Tensor)), None)
        return [self.tensor(v, ref) for v in vals]

    def const(self, op):
        v = self.consts[id(op)]
        if not isinstance(v, torch.Tensor):
            return v
        # A bfloat16 constant (numpy has no bfloat16): cached per device,
        # except under a lint trace, whose tensors are fake.
        key = (id(v), self.device)
        if key not in self._device_consts:
            t = v.to(self.device)
            if fx_lint.tracing():
                return t
            self._device_consts[key] = t
        return self._device_consts[key]

    def plan(self, op):
        fr = self._frame
        if not fr["flash"]:
            return None
        return self.plans(fr["g"]).get(op.name)

    def value(self, tensor):
        return self._frame["env"].get(tensor)

    def values(self, names):
        """The values of ``names``, computing whatever the routing plan
        skipped (the einsum lowering's inputs after a flash fallback)."""
        fr = self._frame
        g, env = fr["g"], fr["env"]
        todo, stack = {}, list(names)
        while stack:
            t = stack.pop()
            if t in env or t in g.inputs:
                continue
            op = g.producer[t]
            if op.name not in todo:
                todo[op.name] = op
                stack.extend(op.inputs)
        for op in sorted(todo.values(), key=lambda o: g.index[o.name]):
            self._exec(op, "value")
        return [env[t] for t in names]

    def output_needed(self, op, i):
        return op.outputs[i] in self._frame["read"]

    def generator(self, op):
        if self.rng is None:
            raise ValueError(
                f"graph contains random op {op.name} ({op.type}); pass rng= "
                "(an int seed) to the compiled call")
        if fx_lint.tracing():
            return None
        site = self.rng_sites[self._frame["prefix"] + op.name]
        g = torch.Generator(device=self.device)
        g.manual_seed(_fold(self.rng, site))
        return g

    def read_variable(self, token, what):
        if not isinstance(token, _Var):
            raise NotImplementedError(f"{what} on a non-variable resource")
        if token.name in self.params:
            return self.params[token.name]
        if token.name in self.buffers:
            # A pending in-graph write is what a later read sees (TF's
            # resource ordering).
            return self.updates.get(token.name, self.buffers[token.name])
        raise KeyError(f"variable {token.name} not found")

    def assign(self, op, name, value):
        if name in self.params:
            raise NotImplementedError(
                f"{op.type} writes trainable variable {name} inside the "
                "compiled function; train through make_train_step instead")
        cur = self.updates.get(name, self.buffers.get(name))
        value = self.tensor(value, cur)
        if op.type == "AssignVariableOp":
            self.updates[name] = value
        elif op.type == "AssignAddVariableOp":
            self.updates[name] = cur + value
        else:
            self.updates[name] = cur - value

    def call_function(self, op, args):
        fname = op.attr("f")["func"]
        g = self.functions.get(fname)
        if g is None:
            raise NotImplementedError(
                f"function {fname!r} called by {op.name} not in the record")
        sub = self._frame["prefix"] + op.name + "/"
        if sub not in self._numbered:
            self._numbered.add(sub)
            self._number_rng_sites(g, sub)
        env = dict(zip(g.inputs, args))
        env = self._run_graph(g, env, sub)
        return tuple(env[t] for t in g.outputs)


def _decode_value(d, arrays, name):
    """A recorded tensor value: a numpy array, a CPU bfloat16 tensor, or a
    Python string."""
    if "str" in d:
        return d["str"]
    arr = arrays[d["array"]]
    if d.get("dtype") == "bfloat16":
        return torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
    if arr.dtype == object:
        raise NotImplementedError(f"{name}: object array in the record")
    return arr


def _unflatten(skeleton, flat):
    if skeleton is None:
        return None
    if isinstance(skeleton, int):
        return flat[skeleton]
    if "dict" in skeleton:
        return {k: _unflatten(v, flat) for k, v in skeleton["dict"]}
    if "list" in skeleton:
        return [_unflatten(v, flat) for v in skeleton["list"]]
    return tuple(_unflatten(v, flat) for v in skeleton["tuple"])


def _flatten(out):
    if isinstance(out, dict):
        return [x for v in out.values() for x in _flatten(v)]
    if isinstance(out, (list, tuple)):
        return [x for v in out for x in _flatten(v)]
    return [out]


# ===========================================================================
# The compiled function
# ===========================================================================

def _default_device():
    if basics.is_initialized():
        return basics.device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_compile: no CUDA device is available and the runtime is "
            "not initialised; call horovod_tpu_torch.init(device='cpu') or "
            "pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def _to_torch(v):
    """A TF tensor or numpy array as a CPU torch tensor (bfloat16 through
    its bits); 64-bit types stay whole."""
    if isinstance(v, torch.Tensor):
        return v
    if hasattr(v, "numpy") and not isinstance(v, np.ndarray):
        v = v.numpy()
    arr = np.array(v, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _initial_value(var, values, gen):
    name = var["name"]
    dt = _tdt(var["dtype"])
    if values is not None and name in values:
        return _to_torch(values[name]).to(dt).reshape(var["shape"])
    init = var["init"]
    if "fill" in init:
        return torch.full(var["shape"], init["fill"], dtype=dt)
    draw = dt if dt in (torch.float64, torch.float32) else torch.float32
    return (torch.randn(var["shape"], generator=gen, dtype=draw)
            * init["normal"]).to(dt)


class CompiledFunction(torch.nn.Module):
    """A recorded ``tf.function`` as an ``nn.Module``.

    The trainable variables are parameters (fp32 masters when the record
    stores float32, as TF does), the others buffers; both live on
    ``device``. ``params`` and ``aux`` map TF variable names to them (an
    ``nn.Module`` keeps ``buffers()`` for its own method)."""

    def __init__(self, record, arrays, device, values=None, seed=0,
                 compute_dtype=None, verify=False, variables=None):
        super().__init__()
        self.record = record
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.verify = verify
        self._tf_variables = variables
        self._interp = _GraphInterpreter(record, arrays, self.device)
        self._param_attr, self._aux_attr = {}, {}
        gen = torch.Generator().manual_seed(int(seed))
        stored = {v["name"]: _decode_value(v["value"], arrays, v["name"])
                  for v in record["variables"] if "value" in v}
        if values is not None:
            stored.update(values)
        for i, var in enumerate(record["variables"]):
            t = _initial_value(var, stored, gen).to(self.device)
            if var["trainable"]:
                attr = f"p{len(self._param_attr)}"
                self.register_parameter(attr, torch.nn.Parameter(t))
                self._param_attr[var["name"]] = attr
            else:
                attr = f"b{len(self._aux_attr)}"
                self.register_buffer(attr, t)
                self._aux_attr[var["name"]] = attr
        self._verified = set()

    @classmethod
    def from_record(cls, path_or_record, device=None, seed=0, weights=None,
                    compute_dtype=None, verify=False):
        """Load a record (a path written by :func:`save_record`, or the
        dict :func:`record_function` returns) without tensorflow.
        Variables without a stored value and not in ``weights`` (name ->
        array) are drawn from a CPU generator seeded with ``seed``, from
        the statistics the record keeps, so that one seed gives the same
        weights on every device."""
        rec = path_or_record
        if not isinstance(rec, dict):
            rec = load_record(rec)
        device = _default_device() if device is None else device
        return cls(rec["record"], rec["arrays"], device, values=weights,
                   seed=seed, compute_dtype=compute_dtype, verify=verify)

    @property
    def params(self):
        """TF name -> parameter."""
        return {n: self._parameters[a] for n, a in self._param_attr.items()}

    @property
    def aux(self):
        """TF name -> buffer (the non-trainable variables)."""
        return {n: self._buffers[a] for n, a in self._aux_attr.items()}

    def _set_aux(self, updates):
        for name, value in updates.items():
            attr = self._aux_attr[name]
            old = self._buffers[attr]
            # Rebound, not written in place: the step's autograd graph
            # may hold the old value.
            self._buffers[attr] = value.detach().to(old.dtype) \
                .reshape(old.shape)

    # -- functional core -------------------------------------------------
    def apply(self, params, inputs, buffers=None, rng=None, training=False):
        """The forward: (structured output, new buffers), differentiable
        with respect to ``params`` (TF name -> tensor). ``training`` is
        accepted for the JAX bridge's signature: the traced graph fixed
        the training mode. With ``compute_dtype`` set, float params and
        float inputs are cast on entry: master weights and gradients stay
        fp32; batch-norm, softmax and cross-entropy compute their
        statistics in fp32."""
        del training
        buffers = self.aux if buffers is None else buffers
        inputs = [self._coerce(v) for v in inputs]
        if self.compute_dtype is not None:
            def cast(v):
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    return v.to(self.compute_dtype)
                return v
            params = {k: cast(v) for k, v in params.items()}
            inputs = [cast(v) for v in inputs]
        flat, updates = self._interp.run(params, buffers, inputs, rng=rng)
        flat = [v if isinstance(v, torch.Tensor) or v is None
                else _host_tensor(v).to(self.device) for v in flat]
        out = _unflatten(self.record["structure"], flat)
        new_buffers = dict(buffers)
        new_buffers.update(updates)
        return out, new_buffers

    def _coerce(self, v):
        return _to_torch(v).to(self.device)

    def _verify(self, inputs, rng, training):
        """The hvd-lint pass over the forward, once per signature, before
        its first run: a trace on fake tensors (no launch, no
        collective)."""
        sig = (training, rng is not None, len(inputs))
        if not self.verify or sig in self._verified:
            return
        from .. import analysis

        def fwd(params, buffers, inputs):
            out, _ = self.apply(params, inputs, buffers=buffers, rng=rng)
            return out

        analysis.verify_traceable(
            fwd, (self.params, self.aux, [self._coerce(v) for v in inputs]),
            mode=self.verify, what="tf-bridge forward")
        self._verified.add(sig)

    def forward(self, *inputs, rng=None, training=False):
        """The forward on the module's own weights, with autograd."""
        self._verify(inputs, rng, training)
        out, _ = self.apply(self.params, inputs, rng=rng)
        return out

    def __call__(self, *inputs, rng=None, training=False):
        """Forward without gradients (``rng``: an int seed for the random
        ops)."""
        with torch.no_grad():
            return self.forward(*inputs, rng=rng, training=training)

    def make_train_step(self, optimizer, process_set=None):
        """``step(batch, rng=None) -> loss`` through the port's
        ``train.make_train_step(..., has_aux=True)``: forward and backward
        on this rank's batch, gradients averaged across ranks, the
        optimizer's update, the graph's buffer writes applied (then
        averaged across ranks, as the JAX step averages its aux state).
        The function's first flat output must be the scalar loss. A bare
        ``torch.optim.Optimizer`` over ``parameters()`` is wrapped in
        ``train.DistributedOptimizer``. The rank is folded into ``rng``
        (each rank draws its own dropout)."""
        from .. import train
        dist_opt = optimizer
        if not hasattr(dist_opt, "inner"):
            dist_opt = train.DistributedOptimizer(
                optimizer, **({"process_set": process_set}
                              if process_set else {}))
        owned = {id(p) for g in dist_opt.inner.param_groups
                 for p in g["params"]}
        if owned != {id(p) for p in self.parameters()}:
            raise ValueError(
                "make_train_step: the optimizer must be built over this "
                "CompiledFunction's parameters()")

        def loss_fn(module, batch):
            inputs, rng = batch
            self._verify(inputs, rng, True)
            out, new_buffers = self.apply(self.params, inputs, rng=rng,
                                          training=True)
            loss = _flatten(out)[0]
            if loss.dim() != 0:
                raise ValueError(
                    "make_train_step needs a scalar loss as the function's "
                    f"(first) output; got shape {tuple(loss.shape)}")
            self._set_aux({k: v for k, v in new_buffers.items()
                           if k in self._interp.updates})
            return loss

        inner = train.make_train_step(loss_fn, dist_opt, has_aux=True)

        def step(batch, rng=None):
            # One process per GPU: the batch is this rank's shard.
            for i, v in enumerate(batch):
                if np.ndim(v) == 0:
                    raise ValueError(
                        f"batch[{i}] has no leading batch axis: the step "
                        "trains on this rank's shard of the batch")
            if rng is not None:
                rng = _fold(rng, basics.rank())
            return inner(self, (tuple(batch), rng))
        return step

    def copy_params_to_variables(self, variables=None):
        """Write the (possibly trained) values back into TF variables
        (the traced function's own by default), so that TF-side
        checkpointing and evaluation see them."""
        variables = self._tf_variables if variables is None else variables
        if variables is None:
            raise ValueError(
                "copy_params_to_variables: a record loaded from disk has "
                "no TF variables; pass variables=")
        state = {**self.params, **self.aux}
        for v in variables:
            src = state.get(v.name)
            if src is not None:
                arr = src.detach().float().cpu().numpy() \
                    if src.dtype == torch.bfloat16 else \
                    src.detach().cpu().numpy()
                v.assign(arr.astype(v.dtype.as_numpy_dtype))


def tpu_compile(fn, example_inputs=None, input_signature=None,
                dynamic_batch=True, compute_dtype=None, verify=False):
    """Compile a TF2 callable for the card: trace it with ``tf.function``,
    record the graph, and return a :class:`CompiledFunction` holding the
    variables' current values on the runtime's device (the current CUDA
    device when the runtime is not initialised).

    Args:
      fn: a python callable using TF ops, or a ``tf.function``; model
        variables are captured (module attributes / closure), the TF2
        idiom.
      example_inputs: concrete example arguments to trace with. With
        ``dynamic_batch`` (default) the leading dim is traced as None, so
        ``tf.shape``-based batch math follows the actual batch.
      input_signature: instead of example_inputs, a list of
        ``tf.TensorSpec`` (None dims allowed).
      compute_dtype: e.g. ``torch.bfloat16``: float params and inputs are
        cast on entry, master weights stay fp32.
      verify: run the hvd-lint traced-program analyzer over each call
        signature at its first call (True: raise on error-severity
        findings; ``"warn"``: log only).
    """
    cf = _concrete_function(fn, example_inputs, input_signature,
                            dynamic_batch)
    record, arrays, values = _record(cf, weights=False)
    return CompiledFunction(record, arrays, _default_device(), values=values,
                            compute_dtype=compute_dtype, verify=verify,
                            variables=list(cf.variables))

"""Parameter/activation sharding rules, and the execution GSPMD gives them
(port of ``horovod_tpu/parallel/sharding.py``).

The rules are the JAX package's: Megatron-style tensor parallelism
expressed as (path-regex → PartitionSpec) pairs matched against the flax
parameter path joined with '/' (first match wins; unmatched parameters
replicate; a spec whose named dimensions do not divide the mesh falls back
to replication). :class:`P` is the port's PartitionSpec: one entry per
tensor dimension, None or a mesh axis name or a tuple of names.

JAX hands the annotated tree to XLA's SPMD partitioner, which inserts the
collectives. Eager PyTorch has no partitioner, so :func:`shard_model`
runs the port's ``TransformerLM`` under the specs itself, one process per
rank over the mesh's process groups (``parallel/axis.py``):

- column-parallel ``qkv`` / ``mlp_in`` (input through ``vary_replicated``
  over ``tp``) and row-parallel ``proj`` / ``mlp_out`` (partial products
  summed by ``psum`` over ``tp``, in float32, then the bias);
- a vocab-parallel ``tok_embed`` (masked lookup, then ``psum``) and a
  column-parallel ``lm_head`` whose logits are gathered over ``tp``
  (``all_gather_invariant``: every rank computes the same loss from
  them);
- FSDP: each weight stored as its ``fsdp`` slice and all-gathered at use
  (``all_gather``, whose backward reduce-scatters the gradient);
- the batch split over ``("dp", "fsdp")``; the loss is the global-batch
  mean (``pmean`` over the data axes), and after the backward the
  gradients of leaves replicated over a data axis are summed over it, so
  every rank holds the exact gradient of the global mean for its shard.

Attention on each rank runs over its ``heads / tp`` heads (the flash
kernels on CUDA tensors). Specs are stated on the flax shapes and mapped
onto the port's parameters with ``params_from_flax``'s transposes: a flax
kernel ``(in, out)`` is ``Linear.weight`` ``(out, in)``, and the fused
``qkv`` weight's rows are laid out ``(3, heads, head_dim)``, so a tp
rank's slice of it is three strided row blocks. An axis of size 1 moves
nothing: at mesh (1, 1, 1) the step runs the unsharded model's
operations.
"""

import re

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.transformer import LN_EPS, attend
from ..utils import tree as _tree
from . import axis as _axis


class P(tuple):
    """PartitionSpec: ``P("fsdp", None, "tp", None)``. A one-name tuple
    entry is the name itself, as ``jax.sharding.PartitionSpec`` keeps it.
    A leaf of a tree (``utils.tree``), not a container."""

    _tree_leaf = True

    def __new__(cls, *names):
        return super().__new__(cls, tuple(
            n[0] if isinstance(n, tuple) and len(n) == 1 else n
            for n in names))

    def __repr__(self):
        return "P(" + ", ".join(repr(n) for n in self) + ")"


def transformer_param_rules(tp_axis="tp", fsdp_axis=None):
    """Sharding rules for the models in horovod_tpu_torch.models (on their
    flax parameter paths).

    Column-parallel (shard output features): qkv projections, mlp_in.
    Row-parallel (shard input features): attention out-proj, mlp_out.
    Embeddings/lm_head: shard the vocab dimension.
    With ``fsdp_axis``, the remaining major dimension is sharded ZeRO-3
    style and gathered at use.
    """
    f = fsdp_axis

    return [
        # DenseGeneral qkv kernel: (hidden, 3, heads, head_dim) — shard heads.
        (r".*attn/qkv/kernel", P(f, None, tp_axis, None)),
        (r".*attn/qkv/bias", P(None, tp_axis, None)),
        # DenseGeneral proj kernel: (heads, head_dim, hidden) — shard heads.
        (r".*attn/proj/kernel", P(tp_axis, None, f)),
        (r".*attn/proj/bias", P()),
        (r".*mlp_in/kernel", P(f, tp_axis)),
        (r".*mlp_in/bias", P(tp_axis)),
        (r".*mlp_out/kernel", P(tp_axis, f)),
        (r".*mlp_out/bias", P()),
        # MoE expert weights: (experts, d, f) — experts over the data axes
        # (expert parallelism), features over tp.
        (r".*moe/w_in", P(("dp",) if f is None else ("dp", f), None,
                          tp_axis)),
        (r".*moe/w_out", P(("dp",) if f is None else ("dp", f), tp_axis,
                           None)),
        (r".*moe/w_gate", P()),
        (r".*embed/embedding", P(tp_axis, f)),
        (r".*lm_head/kernel", P(f, tp_axis)),
        (r".*mlm_head/kernel", P(f, tp_axis)),
    ]


def _path_str(path):
    return _tree.path_str(path)


def mesh_shape(mesh):
    """``{axis name: size}`` of a ``DeviceMesh`` (or of a dict)."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return {name: int(size) for name, size in
            zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def _names(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _spec_fits(spec, shape, mesh):
    """A spec only applies if every named dimension divides evenly."""
    sizes = mesh_shape(mesh)
    if len(spec) > len(shape):
        return False
    for dim, names in zip(shape, spec):
        names = _names(names)
        if not names:
            continue
        if any(n not in sizes for n in names):
            return False  # mesh lacks this axis → fall back to replication
        k = 1
        for n in names:
            k *= sizes[n]
        if dim % k:
            return False
    return True


def make_param_specs(params, mesh, rules=None):
    """Map a parameter tree (flax paths; leaves with a ``shape``) to
    :class:`P` specs via the rules; leaves whose shapes don't divide the
    mesh axes fall back to replication."""
    if rules is None:
        rules = transformer_param_rules(
            fsdp_axis="fsdp" if mesh_shape(mesh).get("fsdp", 1) > 1
            else None)
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def assign(path, leaf):
        name = _path_str(path)
        for pat, spec in compiled:
            if pat.fullmatch(name):
                if _spec_fits(spec, tuple(leaf.shape), mesh):
                    return spec
                return P()
        return P()

    return _tree.map_with_path(assign, params)


def _coords(mesh):
    """This rank's ``{axis: index}`` on ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh "
                         f"{mesh_shape(mesh)}")
    return dict(zip(mesh.mesh_dim_names, coord))


def _block(spec_entry, extent, sizes, coords):
    """(start, length) of this rank's block of a dimension of ``extent``
    sharded over ``spec_entry``'s axes (row-major over their order)."""
    names = _names(spec_entry)
    if not names:
        return 0, extent
    idx, k = 0, 1
    for n in names:
        idx = idx * sizes[n] + coords[n]
        k *= sizes[n]
    return idx * (extent // k), extent // k


def local_slice(x, spec, mesh):
    """This rank's block of the whole tensor ``x`` under ``spec``."""
    sizes, coords = mesh_shape(mesh), _coords(mesh)
    for d, entry in enumerate(spec):
        start, length = _block(entry, x.shape[d], sizes, coords)
        if length != x.shape[d]:
            x = x.narrow(d, start, length)
    return x


def local_shape(shape, spec, mesh):
    """The tensor-local shape of a leaf of ``shape`` under ``spec``."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(tuple(spec)[:len(out)]):
        for n in _names(entry):
            out[d] //= sizes[n]
    return tuple(out)


def shard_params(params, mesh, specs=None):
    """Each rank keeps only its slice of each leaf: the tree of this
    rank's blocks (contiguous copies) of ``params`` under ``specs``."""
    if specs is None:
        specs = make_param_specs(params, mesh)
    return _tree.map_with_path(
        lambda _, x, s: local_slice(torch.as_tensor(x), s, mesh)
        .contiguous().clone(), params, specs)


def constrain(x, mesh, spec):
    """``with_sharding_constraint``'s counterpart: the identity, after
    checking that ``spec`` fits ``x`` on ``mesh``."""
    if not _spec_fits(P(*spec), tuple(x.shape), mesh):
        raise ValueError(f"spec {spec} does not fit a tensor of shape "
                         f"{tuple(x.shape)} on the mesh {mesh_shape(mesh)}")
    return x


def batch_spec(extra_dims=0, data_axes=("dp", "fsdp")):
    """PartitionSpec for a batch-leading array: batch over the data axes."""
    return P(data_axes, *([None] * extra_dims))


# ---------------------------------------------------------------------------
# The port's TransformerLM under the specs
# ---------------------------------------------------------------------------

def _flax_layout(cfg):
    """Per parameter of ``models.TransformerLM``, in ``state_dict`` order:
    (port name, flax path, flax shape, kind). The kind says how the port's
    tensor reads as the flax leaf: ``plain`` (the same), ``dense`` (flax
    ``(in, out)`` = ``weight.T``), ``qkv_w`` / ``qkv_b`` (rows (3, heads,
    head_dim)) and ``proj_w`` (columns (heads, head_dim))."""
    hid, hd, heads = cfg.hidden, cfg.hidden // cfg.heads, cfg.heads
    ff = hid * cfg.mlp_ratio
    bb = ("params", "backbone")
    out = [("backbone.tok_embed.weight", bb + ("tok_embed", "embedding"),
            (cfg.vocab_size, hid), "plain")]
    if not cfg.use_rope:
        out.append(("backbone.pos_embed.weight",
                    bb + ("pos_embed", "embedding"), (cfg.max_len, hid),
                    "plain"))

    def ln(pre, fp):
        return [(pre + ".weight", fp + ("scale",), (hid,), "plain"),
                (pre + ".bias", fp + ("bias",), (hid,), "plain")]

    for i in range(cfg.layers):
        pre, fp = f"backbone.blocks.{i}.", bb + (f"block_{i}",)
        out += ln(pre + "ln1", fp + ("ln1",))
        out += [
            (pre + "attn.qkv.weight", fp + ("attn", "qkv", "kernel"),
             (hid, 3, heads, hd), "qkv_w"),
            (pre + "attn.qkv.bias", fp + ("attn", "qkv", "bias"),
             (3, heads, hd), "qkv_b"),
            (pre + "attn.proj.weight", fp + ("attn", "proj", "kernel"),
             (heads, hd, hid), "proj_w"),
            (pre + "attn.proj.bias", fp + ("attn", "proj", "bias"), (hid,),
             "plain")]
        out += ln(pre + "ln2", fp + ("ln2",))
        out += [
            (pre + "mlp_in.weight", fp + ("mlp_in", "kernel"), (hid, ff),
             "dense"),
            (pre + "mlp_in.bias", fp + ("mlp_in", "bias"), (ff,), "plain"),
            (pre + "mlp_out.weight", fp + ("mlp_out", "kernel"), (ff, hid),
             "dense"),
            (pre + "mlp_out.bias", fp + ("mlp_out", "bias"), (hid,),
             "plain")]
    out += ln("backbone.ln_f", bb + ("ln_f",))
    out += [("lm_head.weight", ("params", "lm_head", "kernel"),
             (hid, cfg.vocab_size), "dense"),
            ("lm_head.bias", ("params", "lm_head", "bias"),
             (cfg.vocab_size,), "plain")]
    return out


def flax_shapes(cfg):
    """The flax parameter tree of a ``TransformerLM`` of ``cfg``, with
    ``torch.Size`` leaves: what :func:`make_param_specs` reads."""
    tree = {}
    for _, path, shape, _ in _flax_layout(cfg):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty(shape, device="meta")
    return tree


def _to_flax(kind, t, hd):
    """The port's tensor viewed as its flax leaf (local shapes too)."""
    if kind == "dense":
        return t.t()
    if kind == "qkv_w":
        return t.t().reshape(t.shape[1], 3, -1, hd)
    if kind == "qkv_b":
        return t.reshape(3, -1, hd)
    if kind == "proj_w":
        return t.t().reshape(-1, hd, t.shape[0])
    return t


def _from_flax(kind, x):
    if kind == "dense":
        return x.t()
    if kind == "qkv_w":
        return x.reshape(x.shape[0], -1).t()
    if kind == "qkv_b":
        return x.reshape(-1)
    if kind == "proj_w":
        return x.reshape(-1, x.shape[-1]).t()
    return x


def _port_dim(kind, flax_dim):
    """The port tensor's dimension that holds flax dimension ``flax_dim``
    whole (the FSDP gathers' dimension)."""
    if kind == "dense":
        return 1 - flax_dim
    if kind == "qkv_w" and flax_dim == 0:
        return 1
    if kind == "proj_w" and flax_dim == 2:
        return 0
    if kind == "plain":
        return flax_dim
    raise ValueError(f"no port dimension holds flax dimension {flax_dim} "
                     f"of a {kind} leaf")


def _norm(spec):
    return tuple(_names(e) for e in spec) if spec else ()


def _same_spec(a, b):
    ea, eb = _norm(a), _norm(b)
    n = max(len(ea), len(eb))
    return ea + ((),) * (n - len(ea)) == eb + ((),) * (n - len(eb))


class ShardedTransformerLM(nn.Module):
    """A ``models.TransformerLM`` run under sharding specs on one rank of a
    mesh: its parameters are this rank's slices (``local_state_dict``,
    keyed by the model's ``state_dict`` names); ``forward`` takes this rank's
    batch slice; :meth:`loss` is the global-batch mean; after
    ``backward``, :meth:`reduce_gradients` sums each gradient over the
    data axes it is replicated on. Build it with :func:`shard_model`."""

    def __init__(self, cfg, mesh, layout, specs, tensors, device):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        sizes = mesh_shape(mesh)
        self.sizes = sizes
        self.coords = _coords(mesh)
        self.groups = {name: mesh.get_group(name) for name in sizes
                       if sizes[name] > 1}
        self.specs = {}          # port name -> P on the flax shape
        self.kinds = {}
        self.fsdp_dim = {}       # port name -> gather dim, or None
        self.names = []
        self._params = nn.ParameterDict()
        hd = cfg.hidden // cfg.heads
        for name, _, _, kind in layout:
            spec = specs[name]
            self.specs[name], self.kinds[name] = spec, kind
            self.fsdp_dim[name] = None
            for d, entry in enumerate(spec):
                if "fsdp" in _names(entry) and sizes.get("fsdp", 1) > 1:
                    self.fsdp_dim[name] = _port_dim(kind, d)
            full = _to_flax(kind, tensors[name].detach(), hd)
            local = _from_flax(kind, local_slice(full, spec, mesh))
            self._params[name.replace(".", "__")] = nn.Parameter(
                local.to(device).contiguous().clone())
            self.names.append(name)
        self.tp_sharded = {name: self._on("tp", name) for name in self.names}
        for i in range(cfg.layers):
            pre = f"backbone.blocks.{i}."
            for group in (("attn.qkv.weight", "attn.qkv.bias",
                           "attn.proj.weight"),
                          ("mlp_in.weight", "mlp_in.bias",
                           "mlp_out.weight")):
                split = {self.tp_sharded[pre + n] for n in group}
                if len(split) > 1:
                    raise ValueError(
                        f"shard_model: {', '.join(pre + n for n in group)} "
                        "must all be sharded over tp or all replicated "
                        "(a column-parallel layer feeds its row-parallel "
                        "partner)")

    # -- parameters --------------------------------------------------------
    def _on(self, axis_name, name):
        """True when ``name`` is sharded over ``axis_name`` (of size > 1)."""
        return self.sizes.get(axis_name, 1) > 1 and any(
            axis_name in _names(e) for e in self.specs[name])

    def param(self, name):
        """This rank's slice of the parameter ``name`` (state_dict name)."""
        return self._params[name.replace(".", "__")]

    def local_state_dict(self):
        return {name: self.param(name) for name in self.names}

    def _w(self, name):
        """The parameter at use: gathered over ``fsdp`` when stored as its
        fsdp slice."""
        p = self.param(name)
        d = self.fsdp_dim[name]
        if d is not None:
            p = _axis.all_gather(p, self.groups["fsdp"], dim=d)
        return p

    # -- forward -----------------------------------------------------------
    def _ln(self, x, pre):
        return F.layer_norm(x.float(), (self.cfg.hidden,),
                            self._w(pre + ".weight"), self._w(pre + ".bias"),
                            LN_EPS).to(self.cfg.dtype)

    def _column(self, x, pre):
        dt = self.cfg.dtype
        if self.tp_sharded[pre + ".weight"]:
            x = _axis.vary_replicated(x, self.groups["tp"])
        return F.linear(x.to(dt), self._w(pre + ".weight").to(dt),
                        self._w(pre + ".bias").to(dt))

    def _row(self, x, pre):
        dt = self.cfg.dtype
        w, b = self._w(pre + ".weight"), self._w(pre + ".bias")
        if not self.tp_sharded[pre + ".weight"]:
            return F.linear(x.to(dt), w.to(dt), b.to(dt))
        part = F.linear(x.to(dt), w.to(dt)).float()
        return (_axis.psum(part, self.groups["tp"]) + b.float()).to(dt)

    def _embed(self, tokens):
        dt = self.cfg.dtype
        name = "backbone.tok_embed.weight"
        w = self._w(name).to(dt)
        if not self.tp_sharded[name]:
            return F.embedding(tokens, w)
        rows = w.shape[0]
        local = tokens - self.coords["tp"] * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(torch.where(inside, local, 0), w)
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=dt,
                                                          device=x.device))
        return _axis.psum(x, self.groups["tp"])

    def _head(self, x):
        dt = self.cfg.dtype
        w, b = self._w("lm_head.weight"), self._w("lm_head.bias")
        if not self.tp_sharded["lm_head.weight"]:
            return F.linear(x.to(dt), w.to(dt), b.to(dt)).float()
        tp = self.groups["tp"]
        rows = w.shape[0]
        b = _axis.vary_replicated(b, tp).narrow(
            0, self.coords["tp"] * rows, rows)
        x = _axis.vary_replicated(x, tp)
        part = F.linear(x.to(dt), w.to(dt), b.to(dt)).float()
        return _axis.all_gather_invariant(part, tp, dim=-1)

    def forward(self, tokens):
        """This rank's batch slice (B / (dp·fsdp), S) → fp32 logits over
        the whole vocabulary."""
        cfg = self.cfg
        hd = cfg.hidden // cfg.heads
        x = self._embed(tokens)
        if not cfg.use_rope:
            pos = self._w("backbone.pos_embed.weight")
            if self.tp_sharded["backbone.pos_embed.weight"]:
                pos = _axis.all_gather_invariant(pos, self.groups["tp"])
            x = x + pos[:tokens.shape[1]].to(cfg.dtype)[None]
        for i in range(cfg.layers):
            pre = f"backbone.blocks.{i}."
            h = self._ln(x, pre + "ln1")
            h = attend(cfg, self._column(h, pre + "attn.qkv"), hd)
            x = x + self._row(h, pre + "attn.proj")
            h = self._column(self._ln(x, pre + "ln2"), pre + "mlp_in")
            x = x + self._row(F.gelu(h, approximate="tanh"),
                              pre + "mlp_out")
        return self._head(self._ln(x, "backbone.ln_f"))

    def _data_axes(self):
        return [a for a in ("dp", "fsdp") if self.sizes.get(a, 1) > 1]

    def loss(self, tokens, labels):
        """The mean token cross-entropy over the GLOBAL batch, from this
        rank's slice of it (a ``pmean`` over the data axes)."""
        logits = self(tokens)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        for a in self._data_axes():
            loss = _axis.pmean(loss, self.groups[a])
        return loss

    def local_batch(self, x):
        """This rank's slice of a global batch (``batch_spec``: the batch
        over ("dp", "fsdp"))."""
        start, length = _block(("dp", "fsdp"), x.shape[0],
                               {a: self.sizes.get(a, 1)
                                for a in ("dp", "fsdp")},
                               {a: self.coords.get(a, 0)
                                for a in ("dp", "fsdp")})
        return x.narrow(0, start, length)

    @torch.no_grad()
    def reduce_gradients(self):
        """Sum every gradient over the data axes its leaf is replicated on
        (``dp``; ``fsdp`` unless the leaf is stored as fsdp slices, whose
        gather's backward already summed it), one all-reduce per axis over
        the gradients flattened together."""
        for a in self._data_axes():
            grads = [self.param(n).grad for n in self.names
                     if self.param(n).grad is not None
                     and not self._on(a, n)]
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.groups[a])
            torch._foreach_copy_(grads, [
                f.view_as(g) for f, g in zip(
                    torch.split(flat, [g.numel() for g in grads]), grads)])

    def train_step(self, optimizer, tokens, labels):
        """One step on this rank's batch slice: the global-mean loss, its
        backward, the data-axis gradient sums and ``optimizer.step()``
        (an optimizer over ``self.parameters()``). Returns the loss."""
        optimizer.zero_grad(set_to_none=True)
        loss = self.loss(tokens, labels)
        loss.backward()
        self.reduce_gradients()
        optimizer.step()
        return loss.detach()

    # -- the whole parameters ----------------------------------------------
    @torch.no_grad()
    def full_state_dict(self):
        """The unsharded ``state_dict`` (every rank gets it): each slice
        gathered over ``fsdp`` and then over ``tp``."""
        hd = self.cfg.hidden // self.cfg.heads
        out = {}
        for name in self.names:
            t = self._w(name).detach()
            kind, spec = self.kinds[name], self.specs[name]
            if self._on("tp", name):
                d = next(d for d, e in enumerate(spec) if "tp" in _names(e))
                t = _from_flax(kind, _axis.all_gather(
                    _to_flax(kind, t, hd), self.groups["tp"], dim=d))
            out[name] = t.contiguous().clone()
        return out


def shard_model(model, mesh, specs=None, device=None):
    """``model`` (a ``models.TransformerLM``, the same weights on every
    rank) as this rank's :class:`ShardedTransformerLM` on ``mesh`` (a
    ``DeviceMesh`` named like ``parallel.make_mesh``'s; axes it lacks count
    as size 1). ``specs``: a tree of :class:`P` on the flax parameter paths
    (``flax_shapes(cfg)``), by default :func:`make_param_specs` with
    :func:`transformer_param_rules`; each leaf's spec must be its rule's
    (with or without ``fsdp``) or replicated. Each rank keeps only its
    slices, on ``device`` (the model's by default)."""
    cfg = model.cfg
    layout = _flax_layout(cfg)
    shapes = flax_shapes(cfg)
    if specs is None:
        specs = make_param_specs(shapes, mesh)
    by_path = {path: spec for path, spec in _tree.flatten_with_path(
        specs) if isinstance(spec, tuple)}
    rules = [(re.compile(pat), spec) for pat, spec in
             transformer_param_rules(fsdp_axis="fsdp")]
    rules_nf = [(re.compile(pat), spec) for pat, spec in
                transformer_param_rules()]
    per_name = {}
    for name, path, shape, _ in layout:
        spec = P(*by_path.get(path, P()))
        allowed = [P()]
        for compiled in (rules, rules_nf):
            for pat, rule in compiled:
                if pat.fullmatch(_path_str(path)):
                    allowed.append(rule)
                    break
        if not any(_same_spec(spec, a) for a in allowed):
            raise ValueError(
                f"shard_model: spec {spec} of {_path_str(path)} is neither "
                f"its Megatron rule ({allowed[1:]}) nor replicated")
        if not _spec_fits(spec, shape, mesh):
            raise ValueError(f"shard_model: spec {spec} does not fit "
                             f"{_path_str(path)} {shape} on the mesh "
                             f"{mesh_shape(mesh)}")
        per_name[name] = spec
    sd = model.state_dict()
    device = device if device is not None else next(
        model.parameters()).device
    return ShardedTransformerLM(cfg, mesh, layout, per_name, sd, device)

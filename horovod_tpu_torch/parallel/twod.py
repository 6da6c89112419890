"""2D (data × tensor) training: ``sharding.py`` layouts + ZeRO legs (port
of ``horovod_tpu/parallel/twod.py``).

One mesh, two axes: parameters shard over ``tp`` per the Megatron-style
rules of :mod:`horovod_tpu_torch.parallel.sharding`, gradients reduce over
``dp`` through ZeRO-1 legs (``reduce_scatter`` over the dp group, an inner
torch optimizer over this rank's flat shard, ``all_gather`` back) — each
(dp, tp) rank owns 1/dp of the optimizer state for ITS tensor slice, so
state memory scales 1/(dp·tp). The composition is the two-stage layout
the redistribution planner speaks (a :class:`ZeroFlat` stage over ``dp``
stacked on :class:`Sharded` tensor stages over ``tp``), so
:func:`reshard_2d` — a dp and/or tp cohort change — is one
``plan_redistribution`` over the composed specs, run by
``resharding.execute_group``.

A process holds its rank's tensor-local slices. ``TwoDZero.shard(params)``
takes them from the global tree (every rank builds it from one seed);
``init_state``, the step of ``make_step`` and ``apply_gradients`` take and
return tensor-local trees, and the step takes this rank's dp batch shard.
``ensure_plan``, ``spec_2d`` and ``reshard_2d`` read only the global
tree's shapes and dtypes. Trees are nested dicts on the flax paths
(``utils.tree``: sorted-key leaf order, as ``jax.tree`` orders them).

Numerics follow the ZeRO contract: with plain fp32 Sum/Average the
sharded update is bit-identical to the same-mesh data-parallel oracle
(all-reduce + a replicated inner optimizer), because the reduce-scatter
sums each element as the all-reduce does (any order at dp ≤ 2) and the
inner optimizer acts per element. Gradients ride fp32; wire codecs do not
compose with the 2D path yet. ``to_serving`` moves the tensor-local
params to the serving plane's layout with one redistribution program: run
in this process on a (1, 1) mesh, over ``resharding.execute_group`` on a
larger one, where every rank holds only its own shard.
"""

import torch
import torch.distributed as dist

from ..ops import reduce_ops
from ..ops.bucketing import _pack, _unpack
from ..ops.zero import DEFAULT_ZERO_BUCKET_BYTES, dtype_name, plan_zero
from ..utils import tree as _tree
from ..utils.logging_util import get_logger
from .axis import _gather_fn, _scatter_fn
from .sharding import (P, _names, local_shape, make_param_specs,
                       mesh_shape, shard_params, transformer_param_rules)


def make_mesh_2d(dp, tp, device_type=None):
    """A ("dp", "tp") ``DeviceMesh`` over the first ``dp*tp`` ranks of the
    world group, row-major (rank = d·tp + t). Every rank of the world calls
    it; a rank past ``dp*tp`` is not on the mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    n = int(dp) * int(tp)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks for a ({dp}, {tp}) mesh, have "
                         f"{world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(int(dp), int(tp)),
                      mesh_dim_names=("dp", "tp"))


def _elementwise_probe(inner, dtype):
    """One step of ``inner`` over a small 1-D tensor: ``{slot: is_vector}``
    of its state; a vector slot must have the parameter's shape (the
    shard-local state contract)."""
    p = torch.zeros(8, dtype=dtype, requires_grad=True)
    opt = inner([p])
    p.grad = torch.ones_like(p)
    opt.step()
    slots = {}
    for slot, v in opt.state[p].items():
        if torch.is_tensor(v) and v.dim() >= 1:
            if v.shape != p.shape:
                raise ValueError(
                    f"2D ZeRO requires elementwise optimizer state; slot "
                    f"{slot!r} has shape {tuple(v.shape)} for a parameter "
                    f"of {tuple(p.shape)}")
            slots[slot] = True
        else:
            slots[slot] = False
    return slots


class TwoDState:
    """The sharded optimizer state of one rank: ``shards[k]`` is its flat
    ``(shard_len,)`` parameter window of bucket ``k`` (refreshed from the
    parameters at every step) and ``optimizer`` the inner optimizer over
    them, whose ``state[shards[k]]`` holds the moments."""

    __slots__ = ("shards", "optimizer")

    def __init__(self, shards, optimizer):
        self.shards = shards
        self.optimizer = optimizer

    def moments(self, k):
        """``{slot: tensor}`` of bucket ``k``."""
        return self.optimizer.state.get(self.shards[k], {})


def _pack_padded(leaves, bucket, padded):
    """The bucket's leaves flattened, concatenated and zero-padded to
    ``padded`` elements."""
    buf = _pack(leaves, bucket)
    if padded != buf.numel():
        buf = torch.cat([buf, buf.new_zeros(padded - buf.numel())])
    return buf


class TwoDZero:
    """One bound instance of (inner optimizer × 2D mesh × shard plan).

    ``inner`` builds the inner optimizer from a list of tensors (an
    elementwise torch optimizer, e.g. ``functools.partial(torch.optim.Adam,
    lr=1e-2)``: the counterpart of an optax transformation). The ZeRO plan
    is derived from the TENSOR-LOCAL leaf shapes (every tp rank's slice is
    the same shape — even division is the ``sharding._spec_fits``
    contract), so all (dp, tp) ranks agree on the identical pad-and-split
    geometry: the buffers the planner's ``("bucket", k)`` keys address."""

    def __init__(self, inner, mesh, dp_axis="dp", tp_axis="tp",
                 op=reduce_ops.Average,
                 bucket_bytes=DEFAULT_ZERO_BUCKET_BYTES, rules=None):
        if op not in (reduce_ops.Average, reduce_ops.Sum):
            raise ValueError(
                "2D ZeRO supports Average/Sum gradient reductions "
                f"only (got {reduce_ops.op_name(op)})")
        self.inner = inner
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.tp_axis = tp_axis
        self.op = op
        sizes = mesh_shape(mesh)
        self.dp = sizes[dp_axis]
        self.tp = sizes[tp_axis]
        self.bucket_bytes = int(bucket_bytes)
        self.rules = rules
        self.plan = None
        self.param_specs = None
        self.treedef = None
        self._global_meta = None
        self._slots = None

    # -- mesh --------------------------------------------------------------
    def _coord(self, name):
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not on the "
                             f"({self.dp}, {self.tp}) mesh")
        return coord[list(self.mesh.mesh_dim_names).index(name)]

    def _group(self, name):
        return self.mesh.get_group(name)

    def _device(self):
        return torch.device(self.mesh.device_type,
                            torch.cuda.current_device()) \
            if self.mesh.device_type == "cuda" else torch.device("cpu")

    # -- plan --------------------------------------------------------------
    def _local_shape(self, shape, spec):
        return local_shape(shape, spec, self.mesh)

    def ensure_plan(self, params):
        """The shard plan over the tensor-local shapes of ``params`` (the
        global tree; only shapes and dtypes are read)."""
        leaves = _tree.leaves(params)
        if self.plan is None:
            self.param_specs = make_param_specs(
                params, self.mesh,
                self.rules if self.rules is not None
                else transformer_param_rules(tp_axis=self.tp_axis))
            local = [torch.empty(self._local_shape(tuple(leaf.shape), spec),
                                 dtype=_torch_dtype(leaf.dtype),
                                 device="meta")
                     for leaf, spec in zip(leaves, self._spec_leaves())]
            self.plan = plan_zero(local, self.dp, self.bucket_bytes)
            self.treedef = _tree.structure(params)
            self._global_meta = [(tuple(int(d) for d in leaf.shape),
                                  dtype_name(_torch_dtype(leaf.dtype)))
                                 for leaf in leaves]
            dtypes = {b.dtype for b in self.plan.buckets}
            self._slots = {dt: _elementwise_probe(self.inner, dt)
                           for dt in dtypes}
        return self.plan

    def _spec_leaves(self):
        return [s for _, s in _tree.flatten_with_path(self.param_specs)]

    def shard(self, params):
        """This rank's tensor-local slices of the global tree ``params``."""
        self.ensure_plan(params)
        return shard_params(params, self.mesh, self.param_specs)

    # -- resharding specs --------------------------------------------------
    def tensor_layouts(self):
        """Per-leaf :class:`resharding.Sharded`/``Replicated`` tensor
        stages mirroring the param specs (first tp-named dim wins; the
        rules shard at most one dim over tp)."""
        from .. import resharding
        out = []
        for spec in self._spec_leaves():
            lay = resharding.Replicated()
            for d, names in enumerate(tuple(spec)):
                if self.tp_axis in _names(names):
                    lay = resharding.Sharded(self.tp_axis, d)
                    break
            out.append(lay)
        return out

    def spec_2d(self, params):
        """The composed (ZeroFlat over dp) × (Sharded over tp) layout
        of this runtime's optimizer state, as a planner Spec."""
        from .. import resharding
        self.ensure_plan(params)
        return resharding.Spec(
            {self.dp_axis: self.dp, self.tp_axis: self.tp},
            self.tensor_layouts(),
            zero=resharding.ZeroFlat(self.dp_axis, self.plan))

    # -- state -------------------------------------------------------------
    def state_specs(self):
        """Per bucket, ``{slot: P}`` of the inner state: vector slots
        sharded over (dp, tp) — each rank holds a ``(shard_len,)`` window
        — and scalar slots replicated."""
        return tuple(
            {slot: P((self.dp_axis, self.tp_axis)) if vec else P()
             for slot, vec in self._slots[b.dtype].items()}
            for b in self.plan.buckets)

    def _empty_state(self, device):
        shards = [torch.zeros(s.shard_len, dtype=b.dtype, device=device)
                  for b, s in zip(self.plan.buckets, self.plan.shards)]
        return TwoDState(shards, self.inner(shards))

    @torch.no_grad()
    def init_state(self, params):
        """The optimizer state born (dp × tp)-sharded from this rank's
        tensor-local ``params``: its dp window of every bucket and the
        inner optimizer over them — the replicated footprint never
        exists (``ZeroRuntime.init_state``'s contract). Needs the plan
        (``ensure_plan`` or ``shard`` of the global tree)."""
        if self.plan is None:
            raise ValueError("TwoDZero.init_state: build the plan from the "
                             "global tree first (ensure_plan or shard)")
        leaves = _tree.leaves(params)
        d = self._coord(self.dp_axis)
        shards = []
        for b, s in zip(self.plan.buckets, self.plan.shards):
            buf = _pack_padded(leaves, b, s.padded)
            shards.append(buf[d * s.shard_len:(d + 1) * s.shard_len]
                          .clone())
        return TwoDState(shards, self.inner(shards))

    # -- the 2D sharded update --------------------------------------------
    def _tp_replicated(self, spec):
        return all(self.tp_axis not in _names(n) for n in tuple(spec))

    @torch.no_grad()
    def _update_body(self, grads, state, params):
        """tp-local, dp-replicated leaves in; ZeRO legs over dp.

        Gradients arrive as raw autodiff of the rank's LOCAL partial
        loss: tp-sharded leaves carry their exact slice gradient, but
        tp-REPLICATED leaves (norms, embeddings the rules leave whole)
        carry only this tp slice's contribution — sum those over tp
        first, or the shared parameter silently diverges across the
        tensor dimension."""
        plan = self.plan
        g_leaves = [g.detach() for g in _tree.leaves(grads)]
        if self.tp > 1:
            tp_group = self._group(self.tp_axis)
            for idx, spec in enumerate(self._spec_leaves()):
                if self._tp_replicated(spec):
                    g = g_leaves[idx].clone()
                    dist.all_reduce(g, group=tp_group)
                    g_leaves[idx] = g
        p_leaves = [p.detach() for p in _tree.leaves(params)]
        d = self._coord(self.dp_axis)
        average = self.op == reduce_ops.Average
        dp_group = self._group(self.dp_axis) if self.dp > 1 else None
        for k, (b, s) in enumerate(zip(plan.buckets, plan.shards)):
            g = _pack_padded(g_leaves, b, s.padded)
            if dp_group is not None:
                g_shard = torch.empty(s.shard_len, dtype=g.dtype,
                                      device=g.device)
                _scatter_fn()(g_shard, g, op=dist.ReduceOp.SUM,
                              group=dp_group)
            else:
                g_shard = g.clone()
            if average:
                g_shard = g_shard / self.dp
            p = _pack_padded(p_leaves, b, s.padded)
            state.shards[k].copy_(p[d * s.shard_len:(d + 1) * s.shard_len])
            state.shards[k].grad = g_shard
        state.optimizer.step()
        out = [None] * len(p_leaves)
        for k, (b, s) in enumerate(zip(plan.buckets, plan.shards)):
            state.shards[k].grad = None
            if dp_group is not None:
                full = torch.empty(s.padded, dtype=b.dtype,
                                   device=state.shards[k].device)
                _gather_fn()(full, state.shards[k], group=dp_group)
            else:
                full = state.shards[k].clone()
            _unpack(full[:s.size], p_leaves, b, out)
        return _tree.unflatten(self.treedef, out), state

    def make_step(self, loss_fn):
        """The 2D train step: ``step(params, state, batch) -> (new_params,
        state, loss)`` over this rank's tensor-local ``params`` and dp
        batch shard. ``loss_fn(params, batch)`` sees the TENSOR-LOCAL
        params and returns this rank's partial loss; the returned loss is
        the sum over both axes."""
        def step(params, state, batch):
            leaves = [p.detach().requires_grad_() for p in
                      _tree.leaves(params)]
            tree = _tree.unflatten(self.treedef, leaves)
            loss = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)]
            new_p, state = self._update_body(
                _tree.unflatten(self.treedef, grads), state, tree)
            total = loss.detach().clone()
            for name in (self.dp_axis, self.tp_axis):
                dist.all_reduce(total, group=self._group(name))
            return new_p, state, total

        return step

    def apply_gradients(self, params, state, grads):
        """ZeRO-leg update from already-computed gradients (grads laid
        out exactly like params: tp-local, dp-replicated)."""
        return self._update_body(grads, state, params)

    # -- train -> serve ----------------------------------------------------
    @torch.no_grad()
    def to_serving(self, params, serving_world=1, serving_rank=None,
                   layout="replicated", group=None):
        """The planner-emitted train→serve transform: this rank's
        tensor-local ``params`` (what ``shard`` and the step return) move
        to the serving plane's layout (``serving.state.REPLICATED`` /
        ``ROWS`` over ``serving_world`` hosts) through one redistribution
        program — never a gather of the whole tree to the host. Leaves
        stay on the params' device. Needs the plan (``shard`` or
        ``ensure_plan`` of the global tree).

        On a (1, 1) mesh the program runs in this process and returns
        serving host ``serving_rank``'s tree (default 0). On a larger
        mesh every rank holds only its own shard, so every rank of
        ``group`` (default: the world; the mesh's ranks first) calls
        together and the program runs through
        ``resharding.execute_group``: group rank r receives serving host
        r's tree (None past ``serving_world``), and ``serving_rank``, if
        given, must be this rank's."""
        from .. import resharding
        from ..resharding.spec import torch_dtype
        from ..serving.state import leaf_shape, serving_spec
        if self.plan is None:
            raise ValueError("TwoDZero.to_serving: build the plan from the "
                             "global tree first (ensure_plan or shard)")
        serving_world = int(serving_world)
        meta = self._global_meta
        src = resharding.Spec({self.dp_axis: self.dp,
                               self.tp_axis: self.tp},
                              self.tensor_layouts())
        dst = serving_spec(len(meta), serving_world, layout)
        program = resharding.plan_redistribution(src, dst, meta)
        program.verify_consistency()
        local = _tree.leaves(params) if params is not None else []
        device = local[0].device if local else None

        def read_window(rank, buf, start, length):
            _, i = buf
            return local[i].reshape(-1)[start:start + length]

        if self.dp * self.tp == 1:
            rank = 0 if serving_rank is None else int(serving_rank)
            results, _ = resharding.execute_host(
                program, read_window, ranks=[rank], device=device)
            bufs = results[rank]
        else:
            group = group if group is not None else dist.group.WORLD
            rank = dist.get_rank(group)
            if serving_rank is not None and int(serving_rank) != rank:
                raise ValueError(
                    f"to_serving: group rank {rank} receives serving host "
                    f"{rank}'s leaves, not {serving_rank}'s")
            bufs, _ = resharding.execute_group(program, read_window,
                                               group=group, device=device)
            if rank >= serving_world:
                return None
        leaves = []
        for i, (shape, dtype) in enumerate(meta):
            flat = bufs.get(("leaf", i))
            if flat is None:
                flat = torch.zeros(0, dtype=torch_dtype(dtype),
                                   device=device)
            leaves.append(flat.reshape(
                leaf_shape(shape, layout, serving_world, rank)))
        return _tree.unflatten(self.treedef, leaves)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    from ..resharding.spec import torch_dtype
    return torch_dtype(str(dtype))


def reshard_2d(state, old, new, params, group=None):
    """Planner-emitted elastic reshard of the 2D optimizer state: ``old`` /
    ``new`` are :class:`TwoDZero` runtimes (dp and/or tp cohort sizes may
    differ; the new tp slicing must keep leaf shapes even) on meshes over
    the first ranks of ``group`` (default: the world), ``params`` the
    global tree (shapes). One redistribution program moves every moment
    slot through ``resharding.execute_group``: each old rank reads its own
    shards, each new rank receives its windows. Every rank of the group
    calls it; ``state`` is this rank's old state (None off the old mesh).
    Returns this rank's new state (None off the new mesh). Mirrors
    ``ops.zero.reshard_state`` (residual-free state, pure data movement —
    moments survive bit-exactly)."""
    from .. import resharding
    group = group if group is not None else dist.group.WORLD
    me = dist.get_rank(group)
    old.ensure_plan(params)
    new.ensure_plan(params)
    meta = resharding.tree_meta_of(params)
    src_spec = old.spec_2d(params)
    dst_spec = new.spec_2d(params)
    program = resharding.plan_redistribution(src_spec, dst_spec, meta)
    program.verify_consistency()
    on_old = me < old.dp * old.tp
    if on_old and state is None:
        raise ValueError(f"reshard_2d: rank {me} is on the old mesh but "
                         "passed no state")
    # The slots (vector ones with their dtype, scalar ones with their
    # value) as rank 0 of the old mesh holds them in bucket 0.
    info = [None]
    if me == 0:
        info = [{slot: (str(v.dtype).replace("torch.", ""), v.dim() >= 1,
                        None if v.dim() >= 1 else v.detach().cpu().clone(),
                        str(v.device))
                 for slot, v in state.moments(0).items()
                 if torch.is_tensor(v)}]
    dist.broadcast_object_list(info, src=dist.get_global_rank(group, 0),
                               group=group)
    slots = info[0]
    on_new = me < new.dp * new.tp
    device = new._device() if on_new else old._device()
    new_state = new._empty_state(device) if on_new else None
    for slot, (dtype, vector, value, dev) in slots.items():
        if not vector:
            if on_new:
                for shard in new_state.shards:
                    new_state.optimizer.state[shard][slot] = \
                        value.clone().to(device if "cuda" in dev else dev)
            continue

        def read_window(rank, buf, start, length, slot=slot):
            _, k = buf
            return state.moments(k)[slot][start:start + length]

        bufs, _ = resharding.execute_group(
            program, read_window, group=group, dtype_override=dtype,
            device=device)
        if on_new:
            for k, shard in enumerate(new_state.shards):
                new_state.optimizer.state[shard][slot] = bufs[("bucket", k)]
    get_logger().warning(
        "twod: optimizer state resharded (dp=%d, tp=%d) -> "
        "(dp=%d, tp=%d) via %s program (%d step(s), %d wire bytes)",
        old.dp, old.tp, new.dp, new.tp, program.strategy,
        len(program.steps), program.bytes_moved())
    return new_state

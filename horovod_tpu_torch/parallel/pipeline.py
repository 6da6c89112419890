"""Pipeline parallelism: microbatch streaming over a pipeline axis (port of
``horovod_tpu/parallel/pipeline.py``).

GPipe-style schedule: a Python loop over the ``M + n - 1`` ticks takes the
place of ``lax.scan``. Every tick each rank applies its stage and
``ppermute``s the activation to the next rank, so after the n-1 warm-up
ticks every stage is busy; autograd's backward mirrors the schedule.

- **Input lives with its owner.** ``microbatches`` is the rank-local shard
  of the global microbatch queue (batch m on rank m // per_rank). A
  one-hop-per-tick ``ppermute`` shift register streams each batch so that
  it reaches stage 0 exactly on its tick; no rank holds the full queue.
- **Heterogeneous ends.** ``first_fn`` (e.g. token embedding) runs where
  the queue feeds stage 0 and may change shape and dtype; ``last_fn``
  (e.g. the LM head) runs on the last stage's output. The ring carries one
  fixed hidden shape. ``first_params`` and ``last_params`` are replicated:
  they go through ``vary_replicated``, so that their gradients come out
  summed over the axis on every rank (JAX's auto-inserted ``pvary``).
- **More stages than ranks** via ``rounds``: rank j holds ``rounds`` slots
  and logical stage ro*n + j lives at rank j, slot ro (the interleaved
  placement). Circuits run back to back with a drain between them: the
  circuit's outputs are replicated (a psum from the last rank) and each
  rank slices its block as the next circuit's queue. Bubble:
  rounds*(n-1) ticks.

Every mask that differs between ranks is a ``torch.where`` on a device
scalar, never a Python branch: each rank's graph holds the same
collectives, so the backward issues the same ones in the same order.
"""

import torch

from .axis import axis_rank, axis_size, ppermute, psum, vary_replicated


def _tree_map(fn, *trees):
    """``jax.tree.map`` over tensors, dicts, lists and tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _flag(value, device):
    """A boolean device scalar for ``torch.where``; a fill, no host copy."""
    return torch.full((), bool(value), dtype=torch.bool, device=device)


def _circuit(stage_fn, params_ro, queue, axis, *, first=None, last=None):
    """One full pass of every microbatch through the n ranks.

    queue: (per_rank, ...) rank-local input shard, batch m on rank
      m // per_rank.
    Returns the (M, ...) outputs of ticks n-1 .. M+n-2 (meaningful on the
    last rank; the caller masks and replicates).
    """
    n = axis_size(axis)
    idx = axis_rank(axis)
    per = queue.shape[0]
    m = per * n
    ticks = m + n - 1
    perm_fwd = [(i, (i + 1) % n) for i in range(n)]
    perm_feed = [(i, (i - 1) % n) for i in range(n)]
    dev = queue.device
    is_first = _flag(idx == 0, dev)

    state = None
    feed = torch.zeros_like(queue[0])
    ys = []
    for s in range(ticks):
        # Shift-register slot invariant: at tick s, rank j's slot holds
        # global batch s+j. A batch is loaded from the local queue at its
        # origin rank and then rides the feed permute one hop per tick,
        # reaching rank 0 exactly at its tick.
        tgt = s + idx
        load = tgt // per == idx and tgt < m
        li = min(max(tgt - idx * per, 0), per - 1)
        feed = torch.where(_flag(load, dev), queue[li], feed)
        x0 = first(feed) if first is not None else feed
        prev = torch.zeros_like(x0) if state is None else state
        y = stage_fn(params_ro, torch.where(is_first, x0, prev))
        if s >= n - 1:
            # On the last rank, tick s produced microbatch s-(n-1); on the
            # others this window is their stage's activations (discarded).
            ys.append(last(y) if last is not None else y)
        if s < ticks - 1:
            state = ppermute(y, perm_fwd, axis)
            feed = ppermute(feed, perm_feed, axis)
    return torch.stack(ys)


def _replicate_from_last(outputs, axis):
    is_last = _flag(axis_rank(axis) == axis_size(axis) - 1, outputs.device)
    return psum(torch.where(is_last, outputs, torch.zeros_like(outputs)),
                axis)


def pipeline_apply(stage_fn, stage_params, microbatches, axis, *,
                   first_fn=None, first_params=None,
                   last_fn=None, last_params=None,
                   rounds=1, replicate_out=True):
    """Run microbatches through the pipeline over ``axis`` (a process group
    or 1-D ``DeviceMesh``).

    Args:
      stage_fn: ``stage_fn(stage_params, x) -> y`` with y.shape == x.shape
        (a transformer stage: hidden states in, hidden states out);
        :func:`module_stage` makes one from a module.
      stage_params: THIS rank's stage-parameter block (tensors, or dicts and
        lists of them) with a leading ``rounds`` axis: rows
        [j*rounds, (j+1)*rounds) of the tree :func:`stack_stage_params`
        builds, on rank j.
      microbatches: (M/n, mb, ...) rank-local input shard (global batch m on
        rank m // (M/n)): rows [j*M/n, (j+1)*M/n) of the global queue. Only
        stage 0 consumes values; they stream there through the feed
        register.
      first_fn / first_params: optional entry adapter applied where the
        queue feeds stage 0 (``first_fn(first_params, batch) -> hidden``,
        e.g. embedding). May change shape/dtype. Replicated on every rank.
      last_fn / last_params: optional exit adapter applied to the last
        stage's output (e.g. LM head). Replicated on every rank.
      rounds: circuits around the ring; total logical stages =
        rounds * n, stage ro*n+j living at rank j slot ro.
      replicate_out: psum the final outputs so every rank returns the full
        (M, mb, ...) result (its backward is the identity: a loss computed
        from it on every rank counts once); if False, only the last rank's
        values are meaningful.
    """
    leaves = _leaves(stage_params)
    if leaves and any(leaf.shape[0] != rounds for leaf in leaves):
        raise ValueError(
            f"stage_params leaves must carry a leading rounds={rounds} "
            f"axis (local slot block); got shapes "
            f"{[tuple(leaf.shape) for leaf in leaves]}. Build the global "
            "tree with stack_stage_params(stages, n_ranks) and take this "
            "rank's rows of axis 0.")
    idx = axis_rank(axis)
    per = microbatches.shape[0]

    first = last = None
    if first_fn is not None:
        fp = _tree_map(lambda p: vary_replicated(p, axis), first_params)
        first = lambda x: first_fn(fp, x)   # noqa: E731
    if last_fn is not None:
        lp = _tree_map(lambda p: vary_replicated(p, axis), last_params)
        last = lambda y: last_fn(lp, y)   # noqa: E731

    queue = microbatches
    for ro in range(rounds):
        params_ro = _tree_map(lambda a: a[ro], stage_params)
        outputs = _circuit(stage_fn, params_ro, queue, axis,
                           first=first if ro == 0 else None,
                           last=last if ro == rounds - 1 else None)
        if ro < rounds - 1:
            # Drain: replicate the circuit's outputs, then each rank takes
            # its block (a rank-dependent use of a replicated value, whose
            # gradient vary_replicated sums back over the ranks).
            full = vary_replicated(_replicate_from_last(outputs, axis), axis)
            queue = full[idx * per:(idx + 1) * per]

    if replicate_out:
        outputs = _replicate_from_last(outputs, axis)
    return outputs


def stack_stage_params(per_stage_params, n_ranks=None):
    """Stack per-stage param trees (sequential order) into the pipeline's
    global layout.

    With ``n_ranks=None`` (or len(stages) == n_ranks): plain stacking —
    axis 0 index j = stage j.

    With rounds = len(stages) / n_ranks > 1: interleaved placement —
    logical stage ro*n + j must land at rank j, slot ro, so axis 0 index
    j*rounds + ro holds stage ro*n + j. Rank j takes rows
    [j*rounds, (j+1)*rounds) and passes rounds= to :func:`pipeline_apply`.
    """
    stages = list(per_stage_params)
    if n_ranks is None or len(stages) == n_ranks:
        return _tree_map(lambda *xs: torch.stack(xs), *stages)
    if len(stages) % n_ranks:
        raise ValueError(
            f"{len(stages)} stages not divisible by n_ranks={n_ranks}")
    rounds = len(stages) // n_ranks
    order = [ro * n_ranks + j
             for j in range(n_ranks) for ro in range(rounds)]
    arranged = [stages[i] for i in order]
    return _tree_map(lambda *xs: torch.stack(xs), *arranged)


def module_stage(module):
    """``stage_fn`` running ``module`` (e.g. an ``nn.Sequential`` of the
    port's ``Block``s, one stage's worth) on the parameters it is given, by
    ``torch.func.functional_call``: ``stage_fn(params, x)`` with ``params``
    a dict shaped like ``dict(module.named_parameters())``."""
    from torch.func import functional_call

    def stage_fn(params, x):
        return functional_call(module, params, (x,))
    return stage_fn

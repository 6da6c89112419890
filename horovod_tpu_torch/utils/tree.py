"""Nested containers of tensors (the port's stand-in for ``jax.tree``).

A tree is a dict, list or tuple of trees, or a leaf (anything else, and
a tuple whose class sets ``_tree_leaf``, as ``parallel.sharding.P``
does: a spec is one leaf, as ``PartitionSpec`` is in ``jax.tree``).
Dicts flatten in sorted-key order, as ``jax.tree.leaves`` orders them, so
that a flax-style parameter tree flattens to the same leaf order in both
packages and a plan built over it has the same signature.
"""


def _children(tree):
    if getattr(tree, "_tree_leaf", False):
        return None
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten_with_path(tree, path=()):
    """``[(path, leaf), ...]``: ``path`` is the tuple of keys and indices
    from the root."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, sub in kids:
        out += flatten_with_path(sub, path + (key,))
    return out


def leaves(tree):
    return [leaf for _, leaf in flatten_with_path(tree)]


def structure(tree):
    """The tree with every leaf replaced by None (its definition)."""
    if getattr(tree, "_tree_leaf", False):
        return None
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(structure(v) for v in tree)
    return None


def unflatten(treedef, flat):
    """The tree of ``treedef`` (``structure``) holding ``flat`` in leaf
    order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(treedef)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over for the tree")
    return out


def map_with_path(fn, tree, *rest):
    """``fn(path, leaf, *leaves_of_rest)`` over every leaf, keeping the
    structure of ``tree``."""
    pairs = flatten_with_path(tree)
    others = [leaves(r) for r in rest]
    return unflatten(structure(tree), [
        fn(path, leaf, *(o[i] for o in others))
        for i, (path, leaf) in enumerate(pairs)])


def path_str(path):
    """``params/backbone/block_0/attn/qkv/kernel``: the path's keys joined
    by '/' (``parallel.sharding._path_str``)."""
    return "/".join(str(p) for p in path)

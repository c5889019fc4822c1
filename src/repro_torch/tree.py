"""Walkers over the nested dicts of tensors that hold a model's weights,
their gradients and an optimizer state's fields (the reference's pytrees
of dicts): anything but a dict is a leaf.  ``cache_items`` and
``cache_build`` walk a serving cache, whose nodes are dicts and
NamedTuples."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of the nested dicts ``tree`` (and of the trees
    ``rest`` of the same structure), the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts in JAX's flattening order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_items(tree, path: str = ""):
    """(path, leaf) of every leaf of nested dicts in JAX's flattening
    order, the path as ``jax.tree_util.keystr`` writes it
    (``['layers']['wq']``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_items(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def cache_items(tree, path: str = ""):
    """(path, leaf) of a tree of nested dicts (keys sorted) and NamedTuples
    (fields in order), the path as ``jax.tree_util.keystr`` writes it
    (``['local'].k``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in cache_items(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in cache_items(getattr(tree, f), f"{path}.{f}")]
    return [(path, tree)]


def cache_build(tree, by_path, path: str = ""):
    """``tree``'s structure (nested dicts and NamedTuples) with the leaf at
    each ``cache_items`` path taken from ``by_path``."""
    if isinstance(tree, dict):
        return {k: cache_build(v, by_path, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cache_build(getattr(tree, f), by_path,
                                        f"{path}.{f}")
                            for f in tree._fields))
    return by_path[path]


def tree_unflatten(tree, leaves):
    """``tree``'s structure (nested dicts) holding ``leaves``, given in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)
    return build(tree)

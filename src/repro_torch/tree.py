"""Walkers over the nested dicts of tensors that hold a model's weights,
their gradients and an optimizer state's fields (the reference's pytrees
of dicts).  Anything but a dict is a leaf."""
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

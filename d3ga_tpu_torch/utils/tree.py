"""Nested parameter trees (dicts and lists of tensors), flattened in the
order of `jax.tree_util` (dict keys sorted), so a tree carried across
from the JAX package lines up leaf by leaf with the port's."""


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    if tree is None:
        return None
    return fn(tree)

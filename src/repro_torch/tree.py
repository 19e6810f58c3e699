"""Nested containers of tensors ("trees"), walked in the JAX package's order.

A tree is a dict, list or tuple of subtrees; ``None`` is an empty subtree
and anything else is a leaf.  Dict keys are visited sorted, as
``jax.tree_util`` orders them, so a leaf's path and position are the ones
the JAX package gives the same tree — what makes checkpoints cross between
the two packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in the JAX package's order; a path is the tuple of
    dict keys and sequence indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in flatten_with_paths(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in flatten_with_paths(sub, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def path_name(path: Tuple) -> str:
    """The checkpoint name of a leaf: its path joined by ``/``."""
    return "/".join(str(key) for key in path)


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure (dict keys sorted) with its leaves replaced, in
    order, by ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    return build(tree)


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])

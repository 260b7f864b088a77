"""Nested dicts, lists, tuples and NamedTuples of tensors: the port's pytrees.

The JAX package's solvers thread pytrees (parameter dicts, ``OptState``,
``AgentState``) through ``jax.tree_util``. These functions are the part of it
the port needs. Dict keys are flattened in sorted order, as JAX flattens them,
so a sum over the leaves runs in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        children = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):
            return type(tree)(*children)
        return type(tree)(children)
    return fn(tree, *rest)


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    """The leaves in JAX's order (sorted dict keys, sequence order); a node
    that ``is_leaf`` accepts is kept whole, as ``jax.tree_util``'s ``is_leaf``."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [x for c in tree for x in tree_leaves(c, is_leaf)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s tree with its leaves, in ``tree_leaves`` order, replaced
    by ``leaves``; a dict keeps its own key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (tuple, list)):
            children = [build(c) for c in t]
            return type(t)(*children) if hasattr(t, "_fields") else type(t)(children)
        return next(it)

    return build(template)

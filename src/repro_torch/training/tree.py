"""Nested dict/list/tuple parameter trees, flattened in JAX's order.

``jax.tree_util`` visits a dict's keys sorted and a list's items in order;
these helpers do the same, so a checkpoint's ``leaf_i`` means the same leaf
in the port and in the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(template: Any, flat: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``flat``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the template's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def describe(tree: Any) -> str:
    """A readable structure string (the checkpoint's ``treedef`` field)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__ + "[" + ", ".join(
            describe(v) for v in tree) + "]"
    return "*"

"""Nested parameter trees: dicts, lists and tuples of tensors.

The port's parameter and optimizer-state trees are plain containers
(``{"inp", "layers": [...], "cls"}``, ``AdamState(step, mu, nu)``),
flattened in ``jax.tree_util`` order: dict keys sorted, lists, tuples and
NamedTuples in order, ``None`` holds no leaf. The reference's checkpoint
layout depends on that order.
"""
from __future__ import annotations


def _rebuild(t, children):
    """A list, tuple or NamedTuple of ``t``'s type holding ``children``."""
    return type(t)(*children) if hasattr(t, "_fields") \
        else type(t)(children)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` flatten order (sorted dict keys)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over every leaf, keeping the structure of ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, t) for t in tree])
    return fn(tree)


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    return _build(like, iter(leaves))


def _build(t, it):
    """``t``'s structure filled from ``it``. A module-level function: a
    nested one calling itself is a reference cycle, and its cell for ``it``
    would hold the leaves (parameters, gradients) until the garbage
    collector ran."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return _rebuild(t, [_build(x, it) for x in t])
    return next(it)

"""Nested-container helpers in ``jax.tree_util`` order.

Parameter trees are nested dicts of tensors; optimizer states add tuples
and NamedTuples.  ``torch.utils._pytree`` flattens dicts in insertion
order, but the reference package flattens them in *sorted key* order, and
the flat (N, D) update matrix, the per-leaf error-feedback stores and the
leaf-by-leaf parity checks only line up with it in that order.  These
helpers therefore walk dicts by sorted keys; lists, tuples and NamedTuples
keep their positional order; anything else is a leaf.

For ``femnist_cnn`` the leaf order is ``conv1/b, conv1/w, conv2/b,
conv2/w, fc1/b, fc1/w, fc2/b, fc2/w``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the structure."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if _is_namedtuple(node):
            return ("namedtuple", type(node), [walk(c) for c in node])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, None, [walk(c) for c in node])
        leaves.append(node)
        return ("leaf", None, None)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> PyTree:
    it = iter(leaves)

    def build(node):
        kind, meta, children = node
        if kind == "leaf":
            return next(it)
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(meta, built))
        if kind == "namedtuple":
            return meta(*built)
        return tuple(built) if kind == "tuple" else list(built)

    return build(treedef)


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leaf-wise across trees of identical structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(
                f"tree_map: trees differ in leaf count ({len(leaves)} vs "
                f"{len(o)})")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_paths(tree: PyTree, sep: str = "/") -> List[str]:
    """``sep``-joined key paths of the leaves, in flatten order."""
    out: List[str] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, prefix + [str(i)])
        else:
            out.append(sep.join(prefix))

    walk(tree, [])
    return out

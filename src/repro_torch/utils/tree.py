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


def _walk(node, leaves: List[Any]):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if _is_namedtuple(node):
        return ("namedtuple", type(node), [_walk(c, leaves) for c in node])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None, [_walk(c, leaves) for c in node])
    leaves.append(node)
    return ("leaf", None, None)


def tree_flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the structure.

    The recursion is a module-level function: a nested one that calls
    itself is a reference cycle (the function and its own closure cell),
    which would keep every leaf it saw alive until Python's cycle
    collector ran — on the card, whole parameter trees a train step."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(node, it):
    kind, meta, children = node
    if kind == "leaf":
        return next(it)
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(meta, built))
    if kind == "namedtuple":
        return meta(*built)
    return tuple(built) if kind == "tuple" else list(built)


def tree_unflatten(treedef, leaves) -> PyTree:
    return _build(treedef, iter(leaves))


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


def _paths(node, prefix, sep, out):
    if isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], prefix + [str(k)], sep, out)
    elif isinstance(node, (list, tuple)):
        for i, c in enumerate(node):
            _paths(c, prefix + [str(i)], sep, out)
    else:
        out.append(sep.join(prefix))


def tree_paths(tree: PyTree, sep: str = "/") -> List[str]:
    """``sep``-joined key paths of the leaves, in flatten order."""
    out: List[str] = []
    _paths(tree, [], sep, out)
    return out

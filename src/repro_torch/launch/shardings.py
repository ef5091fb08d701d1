"""Sharding rule presets, spec resolution and per-device bytes.

A *rule table* maps logical axis names (the ``axes`` of every
``models.layers.ParamDef``) to mesh axes; the presets are the reference's
(``repro.launch.shardings``), word for word.  Resolution needs only the
mesh's axis names and sizes (``repro_torch.models.sharding.Mesh``), so the
specs of a 512-chip mesh resolve on one card or on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.sharding import Mesh, P
from repro_torch.utils.tree import tree_flatten, tree_unflatten

# logical -> tuple of mesh axes (applied where divisible, else replicated)
PRESETS: Dict[str, Dict[str, Optional[Tuple[str, ...]]]] = {
    # 2D "FSDP x TP": weights shard d_model over data AND the wide dim over
    # model. Required to fit nemotron-340b. Baseline preset.
    "fsdp_tp": {
        "vocab": ("model",), "embed": ("data",), "heads": ("model",),
        "kv": ("model",), "mlp": ("model",), "expert": ("model",),
        "layers": None, "batch": ("pod", "data"),
    },
    # plain tensor parallel + pure data parallel (params replicated over data)
    "dp_tp": {
        "vocab": ("model",), "embed": None, "heads": ("model",),
        "kv": ("model",), "mlp": ("model",), "expert": ("model",),
        "layers": None, "batch": ("pod", "data"),
    },
    # pure data parallel (every "client" replica holds the full model)
    "dp_only": {
        "vocab": None, "embed": None, "heads": None, "kv": None,
        "mlp": None, "expert": None, "layers": None,
        "batch": ("pod", "data", "model"),
    },
    # fully-sharded incl. pod axis (ZeRO-3-ish across the whole fleet;
    # breaks per-pod FL semantics — perf comparison only)
    "fsdp_all": {
        "vocab": ("model",), "embed": ("pod", "data"), "heads": ("model",),
        "kv": ("model",), "mlp": ("model",), "expert": ("model",),
        "layers": None, "batch": ("pod", "data"),
    },
}


def resolve(logical: Tuple[Optional[str], ...], shape: Tuple[int, ...],
            rules: Dict, mesh: Mesh) -> P:
    """Logical axes -> PartitionSpec with divisibility fallback."""
    sizes = mesh.shape
    parts = []
    used: set = set()
    for dim, name in zip(shape, logical):
        target = rules.get(name) if name else None
        if not target:
            parts.append(None)
            continue
        axes = tuple(a for a in target if a in sizes and a not in used)
        total = 1
        for a in axes:
            total *= sizes[a]
        if not axes or total <= 1 or dim % total != 0:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return P(*parts)


def partition_specs(defs, rules: Dict, mesh_shape: Dict[str, int]):
    """A ParamDef tree -> a PartitionSpec tree (the reference's
    ``models.layers.partition_specs``: a mapping is dropped, the dim
    replicated, when the dim does not divide by the product of the mapped
    axes' sizes; an entry keeps the rule's axis tuple as written)."""
    def one(d):
        parts = []
        used: set = set()
        for dim, ax in zip(d.shape, d.axes):
            mesh_ax = rules.get(ax)
            if mesh_ax is None:
                parts.append(None)
                continue
            axes_tuple = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
            axes_tuple = tuple(a for a in axes_tuple if a not in used)
            size = 1
            for a in axes_tuple:
                size *= mesh_shape.get(a, 1)
            if size <= 1 or dim % size != 0:
                parts.append(None)
                continue
            used.update(axes_tuple)
            parts.append(mesh_ax)
        return P(*parts)

    leaves, treedef = tree_flatten(defs)
    for d in leaves:
        if len(d.axes) != len(d.shape):
            raise ValueError(f"ParamDef of shape {d.shape} names axes "
                             f"{d.axes}: one logical axis a dim is needed")
    return tree_unflatten(treedef, [one(d) for d in leaves])


def shard_shape(shape, spec, mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """The per-device block of a ``shape`` array under ``spec``: each dim
    divided by the product of the sizes of its mesh axes (axes the mesh
    lacks count 1, as an absent axis shards nothing)."""
    out = []
    for i, dim in enumerate(shape):
        part = spec[i] if i < len(spec) else None
        axes = () if part is None else (part if isinstance(part, tuple)
                                         else (part,))
        n = 1
        for a in axes:
            n *= mesh_shape.get(a, 1)
        out.append(dim // n)
    return tuple(out)


def nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


def _flat(tree, leaf_type):
    """Leaves of ``tree`` in ``tree_flatten`` order, where an instance of
    ``leaf_type`` (a PartitionSpec, an axes tuple) is one leaf."""
    if isinstance(tree, leaf_type):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], leaf_type)]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in _flat(c, leaf_type)]
    return [tree]


def bytes_per_device(tensors, specs, mesh_shape: Dict[str, int]) -> int:
    """Sum of every leaf's per-device block in bytes (``tensors``: any
    tree of tensors with shape and dtype, meta or fake; ``specs``: the
    matching PartitionSpec tree)."""
    ts = tree_flatten(tensors)[0]
    ss = _flat(specs, P)
    if len(ts) != len(ss):
        raise ValueError(f"{len(ts)} tensors against {len(ss)} specs")
    return sum(nbytes(shard_shape(tuple(t.shape), s, mesh_shape), t.dtype)
               for t, s in zip(ts, ss))


# ---------------------------------------------------------------------------
# Batch / cache logical-axis assignment
# ---------------------------------------------------------------------------


def _map_with_name(fn, tree, name=None):
    if isinstance(tree, dict):
        return {k: _map_with_name(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_name(fn, v, name) for v in tree)
    return fn(name, tree)


def batch_axes_for(spec_tree):
    """Logical axes for input-batch leaves by leaf name and rank."""
    def leaf_axes(name, leaf):
        r = leaf.dim()
        if name == "tokens":
            return ("batch",) + (None,) * (r - 1)
        if name == "frames":
            return ("batch", None, "embed")[:r]
        if name == "pos":
            return ()
        return ("batch",) + (None,) * (r - 1)
    return _map_with_name(leaf_axes, spec_tree)


def cache_axes_for(cache_specs, cfg):
    """Logical axes for KV-cache/state leaves (matched by leaf name and
    rank)."""
    del cfg

    def leaf_axes(name, leaf):
        r = leaf.dim()
        if name in ("k", "v"):           # (L, B, len, KV, hd) or enc (L,B,T,H,hd)
            return (None, "batch", None, "kv", None)[:r]
        if name == "c":                   # MLA latent (L, B, len, r)
            return (None, "batch", None, None)[:r]
        if name == "kr":                  # (L, B, len, rope)
            return (None, "batch", None, None)[:r]
        if name == "wkv":                 # (L, B, H, hd, hd)
            return (None, "batch", "heads", None, None)[:r]
        if name in ("att_x", "ffn_x"):    # (L, B, D)
            return (None, "batch", "embed")[:r]
        if name == "h":                   # (L, B, W)
            return (None, "batch", "heads")[:r]
        if name == "conv":                # (L, B, K-1, W)
            return (None, "batch", None, "heads")[:r]
        return (None,) * r
    return _map_with_name(leaf_axes, cache_specs)


def specs_for(spec_tree, axes_tree, rules, mesh: Mesh):
    """Tensor tree + logical-axes tree -> PartitionSpec tree."""
    ts, treedef = tree_flatten(spec_tree)
    axes = _flat(axes_tree, tuple)
    return tree_unflatten(treedef, [
        resolve(tuple(a), tuple(t.shape), rules, mesh)
        for t, a in zip(ts, axes)])

"""LoRA adapters over any :class:`FLModel` (``client.finetune = "lora"``).

The wrapper freezes the base parameters and exposes a new ``FLModel``
whose parameter tree holds only the low-rank adapter factors:

* for every targeted base leaf ``W`` — matricized as ``(L?, d_in, d_out)``
  at the balanced axis split (:func:`adapter_defs`) — ``A`` of shape
  ``(L?, d_in, r)`` (normal with std ``1/sqrt(d_in)``) and ``B`` of shape
  ``(L?, r, d_out)`` initialized to zero, so a fresh adapter model computes
  the base forward exactly;
* the forward merges on the fly:
  ``W_eff = W + (alpha/rank) * (A @ B).reshape(W.shape)``;
* the frozen base tree is closed over: under the cohort's ``vmap`` it is one
  set of tensors shared by every client (only the merged leaves are per
  client), never a per-client copy; under the sharded cohort each further
  card gets one copy, at its first use.

The adapter tree is ``{path: {"a": A, "b": B}}`` with the "/"-joined base
path as key (``"segments/0/attn/wq"``), in ``jax.tree_util`` order (dict
keys sorted, list entries by index), as in the reference.  A leaf is
eligible when it has >= 2 dims beyond a leading stacked ``"layers"`` axis;
``targets`` are substring patterns matched against the path, ``()``
selects every eligible leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.models.layers import ParamDef, zeros_init
from repro_torch.models.small import FLModel
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), c) for i, c in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in items:
        out.extend(_flatten_with_paths(child,
                                       f"{prefix}/{key}" if prefix else key))
    return out


def _lead(d: ParamDef) -> int:
    """Leading stacked-segment dims ("layers" axis) to batch adapters over."""
    return 1 if (d.axes and d.axes[0] == "layers") else 0


def _eligible(d: ParamDef) -> bool:
    return len(d.shape) - _lead(d) >= 2


def target_paths(defs: PyTree, targets: Sequence[str] = ()) -> Tuple[str, ...]:
    """The "/"-joined paths of the base leaves LoRA adapts."""
    return tuple(p for p, d in _flatten_with_paths(defs)
                 if _eligible(d) and (not targets
                                      or any(t in p for t in targets)))


def adapter_defs(defs: PyTree, rank: int,
                 targets: Sequence[str] = ()) -> Dict[str, Dict[str, ParamDef]]:
    """ParamDef tree of the A/B factors: ``{path: {"a": ..., "b": ...}}``."""
    if rank < 0:
        raise ValueError(f"lora rank must be >= 0, got {rank}")
    out: Dict[str, Dict[str, ParamDef]] = {}
    if rank == 0:
        return out
    by_path = dict(_flatten_with_paths(defs))
    for p in target_paths(defs, targets):
        d = by_path[p]
        lead = _lead(d)
        lead_shape = tuple(d.shape[:lead])
        dims = d.shape[lead:]
        # balanced matricization: split at the axis boundary minimizing
        # d_in + d_out — (d | H*hd) for wq-like (d, H, hd) leaves, (H*hd | d)
        # for wo-like (H, hd, d) leaves
        split = min(range(1, len(dims)),
                    key=lambda i: math.prod(dims[:i]) + math.prod(dims[i:]))
        d_in, d_out = math.prod(dims[:split]), math.prod(dims[split:])
        axes = ("layers",) * lead
        out[p] = {
            "a": ParamDef(lead_shape + (d_in, rank), d.dtype, axes=axes),
            "b": ParamDef(lead_shape + (rank, d_out), d.dtype, zeros_init,
                          axes=axes),
        }
    return out


def merge_lora(base_params: PyTree, adapters: Dict[str, Dict[str, Any]],
               scale: float) -> PyTree:
    """``W + scale * (A @ B).reshape(W.shape)`` on every adapted leaf (in
    float32, cast back); with no adapters the base tree itself."""
    if not adapters:
        return base_params

    def merge(node, prefix):
        if isinstance(node, dict):
            return {k: merge(node[k], f"{prefix}/{k}" if prefix else str(k))
                    for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(merge(c, f"{prefix}/{i}" if prefix else str(i))
                              for i, c in enumerate(node))
        ab = adapters.get(prefix)
        if ab is None:
            return node
        delta = torch.matmul(ab["a"], ab["b"])       # batches leading dims
        return (node.to(torch.float32)
                + float(scale) * delta.reshape(node.shape)).to(node.dtype)

    return merge(base_params, "")


def lora_wrap(model: FLModel, base_params: PyTree, rank: int,
              alpha: float = 16.0, targets: Sequence[str] = ()) -> FLModel:
    """Wrap ``model`` so its trainable params are LoRA adapters only; the
    frozen ``base_params`` are closed over."""
    defs = adapter_defs(model.defs, rank, targets)
    scale = float(alpha) / rank if rank else 0.0
    base_apply = model.apply
    # one copy of the base a device: a shard of the sharded cohort on
    # another card than the base's merges with its own copy, made once
    leaves = tree_leaves(base_params)
    copies = {leaves[0].device: base_params} if leaves else {}

    def base_on(device):
        if device not in copies:
            copies[device] = tree_map(lambda t: t.to(device), base_params)
        return copies[device]

    def apply(adapters, x):
        base = base_on(x.device) if copies else base_params
        return base_apply(merge_lora(base, adapters, scale), x)

    return FLModel(f"{model.name}+lora{rank}", defs, apply,
                   model.num_classes, model.input_shape,
                   is_sequence=model.is_sequence)


def adapter_param_count(model: FLModel, rank: int,
                        targets: Sequence[str] = ()) -> int:
    """Total adapter elements: ``sum(rank * (d_in + d_out))`` over targets."""
    return sum(math.prod(d.shape)
               for ab in adapter_defs(model.defs, rank, targets).values()
               for d in ab.values())


def base_param_count(model: FLModel) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(model.defs))

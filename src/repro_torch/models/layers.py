"""Parameter definitions and initializers.

Models are pure functions over nested dicts of tensors.  Each model builds
a tree of :class:`ParamDef` (shape, dtype, init); :func:`init_params`
materializes it with one ``torch.Generator``, drawing the leaves in
flatten order (sorted keys).  The draws differ from the reference's
threefry keys, so parity tests inject the reference's initial parameters
(``repro_torch.convert.params_from_jax``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten

Params = Dict[str, Any]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    # init: (generator, shape, dtype) -> CPU tensor
    init: Callable = None  # default: normal / sqrt(fan_in) on the last-2 dims


def _default_init(gen, shape, dtype):
    if len(shape) <= 1:
        return torch.zeros(shape, dtype=dtype)
    scale = 1.0 / math.sqrt(shape[-2])
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def zeros_init(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype)


def init_params(defs, gen: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    """Materialize a ParamDef tree: leaves drawn in flatten order from the
    CPU generator ``gen`` (so a seed gives the same values on any device),
    then moved to ``device``."""
    leaves, treedef = tree_flatten(defs)
    arrs = [(d.init or _default_init)(gen, d.shape, d.dtype).to(device)
            for d in leaves]
    return tree_unflatten(treedef, arrs)

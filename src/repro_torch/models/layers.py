"""Parameter definitions, initializers and the basic transformer layers.

Models are pure functions over nested dicts of tensors.  Each model builds
a tree of :class:`ParamDef` (shape, dtype, init, axes);
:func:`init_params` materializes it with one ``torch.Generator``, drawing
the leaves in flatten order (sorted keys).  The draws differ from the
reference's threefry keys, so parity tests inject the reference's initial
parameters (``repro_torch.convert.params_from_jax``).

A leaf's ``axes`` is ``("layers",)`` when it is stacked over a
transformer segment's layers (:func:`stack_defs`); LoRA adapts such a leaf
with one adapter per layer.  (The reference names every axis for its
sharding rules; the port reads only this one.)

The norms and RoPE compute in float32 and cast back to the input dtype, as
the reference does (``repro.models.layers``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

Params = Dict[str, Any]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    # init: (generator, shape, dtype) -> CPU tensor
    init: Callable = None  # default: normal / sqrt(fan_in) on the last-2 dims
    axes: Tuple[Optional[str], ...] = ()


def _default_init(gen, shape, dtype):
    if len(shape) <= 1:
        return torch.zeros(shape, dtype=dtype)
    scale = 1.0 / math.sqrt(shape[-2])
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def normal_init(stddev: float):
    return lambda gen, shape, dtype: (
        torch.randn(shape, generator=gen) * stddev).to(dtype)


def zeros_init(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype)


def ones_init(gen, shape, dtype):
    return torch.ones(shape, dtype=dtype)


def uniform_init(lo: float, hi: float):
    return lambda gen, shape, dtype: (
        torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dtype)


def init_params(defs, gen: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    """Materialize a ParamDef tree: leaves drawn in flatten order from the
    CPU generator ``gen`` (so a seed gives the same values on any device),
    then moved to ``device``."""
    leaves, treedef = tree_flatten(defs)
    arrs = [(d.init or _default_init)(gen, d.shape, d.dtype).to(device)
            for d in leaves]
    return tree_unflatten(treedef, arrs)


def stack_defs(defs, n: int):
    """Stack every ParamDef of ``defs`` over a leading ``"layers"`` axis of
    ``n``; each layer's slice is drawn with the leaf's own init."""
    def stack_one(pd: ParamDef) -> ParamDef:
        fn = pd.init or _default_init

        def stacked_init(gen, shape, dtype, _fn=fn):
            return torch.stack([_fn(gen, shape[1:], dtype)
                                for _ in range(shape[0])])
        return ParamDef((n,) + tuple(pd.shape), pd.dtype, stacked_init,
                        ("layers",))
    return tree_map(stack_one, defs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(dtype)


def norm_defs(cfg):
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDef((cfg.d_model,), init=zeros_init)}
    return {
        "scale": ParamDef((cfg.d_model,), init=ones_init),
        "bias": ParamDef((cfg.d_model,), init=zeros_init),
    }


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Rotary position embedding (half-split, float32)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim)
    return 1.0 / (theta ** exponent)  # (head_dim//2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, d/2)
    angles = angles[..., None, :]          # (..., S, 1, d/2): over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

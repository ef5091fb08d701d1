"""Parameter definitions, initializers and the basic transformer layers.

Models are pure functions over nested dicts of tensors.  Each model builds
a tree of :class:`ParamDef` (shape, dtype, init, axes);
:func:`init_params` materializes it with one ``torch.Generator``, drawing
the leaves in flatten order (sorted keys).  The draws differ from the
reference's threefry keys, so parity tests inject the reference's initial
parameters (``repro_torch.convert.params_from_jax``).

A leaf's ``axes`` are the reference's *logical* axis names, one a dim
(``"embed"``, ``"heads"``, ``"mlp"``, ...); they begin with ``"layers"``
when the leaf is stacked over a transformer segment's layers
(:func:`stack_defs`), and LoRA adapts such a leaf with one adapter per
layer.  The dry run resolves them to per-device shards through a rule
table (``repro_torch.launch.shardings``).

The norms and RoPE compute in float32 and cast back to the input dtype, as
the reference does (``repro.models.layers``).  :func:`einsum_f32` is the
reference's ``einsum(..., preferred_element_type=float32)``: a product of
bf16 operands accumulated and returned in float32, never rounded to bf16
on the way.
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
    # init: (generator, shape, dtype) -> a tensor on the generator's device
    init: Callable = None  # default: normal / sqrt(fan_in) on the last-2 dims
    axes: Tuple[Optional[str], ...] = ()


def _default_init(gen, shape, dtype):
    if len(shape) <= 1:
        return torch.zeros(shape, dtype=dtype, device=gen.device)
    scale = 1.0 / math.sqrt(shape[-2])
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def normal_init(stddev: float):
    return lambda gen, shape, dtype: (
        torch.randn(shape, generator=gen, device=gen.device)
        * stddev).to(dtype)


def zeros_init(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def ones_init(gen, shape, dtype):
    return torch.ones(shape, dtype=dtype, device=gen.device)


def uniform_init(lo: float, hi: float):
    return lambda gen, shape, dtype: (
        torch.rand(shape, generator=gen, device=gen.device) * (hi - lo)
        + lo).to(dtype)


def init_params(defs, gen: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    """Materialize a ParamDef tree: leaves drawn in flatten order from
    ``gen`` on the generator's own device (a CPU generator gives the same
    values on any device), then moved to ``device``.  A CUDA generator
    draws on the card: the full-width LLM drivers draw their ~2 B
    parameters there instead of on the host."""
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
                        ("layers",) + tuple(pd.axes))
    return tree_map(stack_one, defs)


# ---------------------------------------------------------------------------
# Products with a float32 result
# ---------------------------------------------------------------------------


def _bmm_f32(eq: str, a, b):
    """``einsum(eq, a, b)`` of two bf16 CUDA tensors as ONE batched bf16
    GEMM with a float32 output (``aten::bmm.dtype``).  Indices in both
    operands and the output batch the product, indices in both operands
    only are contracted, the rest are free; each operand is permuted to
    (batch, free, contracted) and the result back to ``eq``'s output."""
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    batch = [c for c in la if c in lb and c in out]
    con = [c for c in la if c in lb and c not in out]
    fa = [c for c in la if c not in lb]
    fb = [c for c in lb if c not in la]
    size = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))

    def n(cs):
        return math.prod(size[c] for c in cs)

    a3 = a.permute([la.index(c) for c in batch + fa + con]).reshape(
        n(batch), n(fa), n(con))
    b3 = b.permute([lb.index(c) for c in batch + con + fb]).reshape(
        n(batch), n(con), n(fb))
    c = torch.bmm(a3, b3, out_dtype=torch.float32)
    order = batch + fa + fb
    return c.reshape([size[x] for x in order]).permute(
        [order.index(x) for x in out])


def _swap(eq: str, which: int) -> str:
    """The equation of ``eq``'s gradient with respect to operand
    ``which``: (output, other operand) -> that operand."""
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    return f"{out},{lb}->{la}" if which == 0 else f"{out},{la}->{lb}"


class _BF16ProductF32(torch.autograd.Function):
    """bf16 x bf16 -> float32 on the card: the forward is one bf16 GEMM
    with a float32 output; the backward (``aten::bmm.dtype`` has none) is
    the reference's transpose of a float32-preferred product: float32
    products of the upcast operands and the float32 cotangent, each
    gradient rounded to its operand's dtype."""

    @staticmethod
    def forward(eq, a, b):
        return _bmm_f32(eq, a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.eq = inputs[0]
        ctx.save_for_backward(inputs[1], inputs[2])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = torch.einsum(_swap(ctx.eq, 0), g, b.float()).to(a.dtype)
        if ctx.needs_input_grad[2]:
            gb = torch.einsum(_swap(ctx.eq, 1), g, a.float()).to(b.dtype)
        return None, ga, gb


def einsum_f32(eq: str, a, b):
    """``einsum(eq, a, b)`` accumulated and returned in float32, as the
    reference's ``preferred_element_type=jnp.float32``.

    float32 operands: a plain einsum (bit for bit what the port computed
    before).  bf16 operands on the card: one bf16 GEMM with a float32
    output (:class:`_BF16ProductF32`).  Otherwise (the CPU, which has no
    kernel for ``bmm.dtype``, mixed dtypes, or operands under a
    ``torch.func`` transform): the operands upcast to float32 first, which
    is exact, so this is the same product up to summation order."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.einsum(eq, a, b)
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    if (a.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and not wrapped(a) and not wrapped(b)):
        return _BF16ProductF32.apply(eq, a, b)
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


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
        return {"scale": ParamDef((cfg.d_model,), init=zeros_init,
                                  axes=("embed",))}
    return {
        "scale": ParamDef((cfg.d_model,), init=ones_init, axes=("embed",)),
        "bias": ParamDef((cfg.d_model,), init=zeros_init, axes=("embed",)),
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

"""RG-LRU recurrent block (Griffin, arXiv:2402.19427; RecurrentGemma).

Block structure per Griffin Fig. 2:
    x -> [linear -> causal depthwise conv1d(4) -> RG-LRU] * [linear -> GeLU] -> linear

RG-LRU recurrence (per channel):
    r_t = sigmoid(gate_r(xi_t));  i_t = sigmoid(gate_i(xi_t))
    a_t = exp(-c * softplus(Lambda) * r_t)           (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

A full sequence evaluates the linear recurrence with a log-depth scan
(:func:`linear_scan`: ceil(log2 S) doubling steps of whole-tensor ops, the
counterpart of the reference's ``jax.lax.associative_scan``; neither is a
kernel).  The two scans combine the same pairs in another order, so they
agree to float32 rounding, not bit for bit.  Decode is the O(1)
per-step update.

Adaptation note (as in the reference): Griffin's input and recurrence
gates are block-diagonal linear maps; here they are per-channel (diagonal)
gates — the same recurrence family and state size, fewer gate parameters,
and the published lru_width / d_model are kept.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig
from repro_torch.models.layers import ParamDef, normal_init, zeros_init

RGLRU_C = 8.0


def _lambda_init(gen, shape, dtype):
    # init so that a^c = exp(-8 softplus(Lambda)) spreads decays in
    # (0.9, 0.999)
    u = torch.rand(shape, generator=gen, device=gen.device) * 0.099 + 0.9
    # softplus(Lambda) = -log(a)/c  =>  Lambda = log(expm1(-log(a)/c))
    sp = -torch.log(u) / RGLRU_C
    return torch.log(torch.expm1(sp)).to(dtype)


def rglru_defs(cfg: ArchConfig):
    D = cfg.d_model
    W = cfg.lru_width or D
    K = cfg.conv1d_width
    return {
        "w_x": ParamDef((D, W), axes=("embed", "heads")),
        "w_gate": ParamDef((D, W), axes=("embed", "heads")),
        "conv_w": ParamDef((K, W), init=normal_init(0.1),
                           axes=(None, "heads")),
        "conv_b": ParamDef((W,), init=zeros_init, axes=("heads",)),
        # diagonal RG-LRU gates
        "gate_r_w": ParamDef((W,), init=normal_init(0.1), axes=("heads",)),
        "gate_r_b": ParamDef((W,), init=zeros_init, axes=("heads",)),
        "gate_i_w": ParamDef((W,), init=normal_init(0.1), axes=("heads",)),
        "gate_i_b": ParamDef((W,), init=zeros_init, axes=("heads",)),
        # Lambda parameterizes the stable decay a = exp(-c softplus(L) r)
        "lam": ParamDef((W,), init=_lambda_init, axes=("heads",)),
        "w_out": ParamDef((W, D), axes=("heads", "embed")),
    }


def _causal_conv(x, conv_w, conv_b, conv_state):
    """Depthwise causal conv1d.  x: (B, S, W); conv_state: (B, K-1, W)."""
    K = conv_w.shape[0]
    S = x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)      # (B, S+K-1, W)
    out = sum(xp[:, i:i + S] * conv_w[i].to(x.dtype) for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else conv_state
    return out + conv_b.to(x.dtype), new_state


def _gates(p, xi):
    f32 = torch.float32
    x = xi.to(f32)
    r = torch.sigmoid(x * p["gate_r_w"].to(f32) + p["gate_r_b"].to(f32))
    i = torch.sigmoid(x * p["gate_i_w"].to(f32) + p["gate_i_b"].to(f32))
    lam = p["lam"].to(f32)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax's softplus
    log_a = -RGLRU_C * softplus * r
    a = torch.exp(log_a)
    # sqrt(1-a^2) computed stably via log: 0.5*log1p(-exp(2 log_a))
    mult = torch.exp(0.5 * torch.log1p(
        -torch.exp(torch.clamp_max(2.0 * log_a, -1e-6))))
    b = mult * i * x
    return a, b


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over dim 1 in
    ceil(log2 S) doubling steps (Hillis-Steele): after the step of offset
    d, position t holds the composition of steps (t - 2d, t].  -> (A, B)
    with h_t = A_t h_{-1} + B_t for any start h_{-1}."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rglru_block(cfg: ArchConfig, p, x, state):
    """x: (B, S, D); state: {"h": (B, W), "conv": (B, K-1, W)} ->
    (out, state')."""
    dt = x.dtype
    xi = torch.einsum("bsd,dw->bsw", x, p["w_x"].to(dt))
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate"].to(dt)),
                  approximate="tanh")
    xi, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                  state["conv"])
    a, b = _gates(p, xi)
    # h_t = a_t h_{t-1} + b_t by the scan; fold in h0 afterwards
    A, B = linear_scan(a, b)
    h = A * state["h"].to(torch.float32)[:, None, :] + B
    new_state = {"h": h[:, -1, :], "conv": conv_state}
    out = h.to(dt) * gate
    return torch.einsum("bsw,wd->bsd", out, p["w_out"].to(dt)), new_state


def rglru_decode(cfg: ArchConfig, p, x, state):
    """One-token decode.  x: (B, 1, D) -> (out, {"h", "conv"})."""
    dt = x.dtype
    xi = torch.einsum("bsd,dw->bsw", x, p["w_x"].to(dt))
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate"].to(dt)),
                  approximate="tanh")
    xi, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                  state["conv"])
    a, b = _gates(p, xi)
    h = a[:, 0] * state["h"].to(torch.float32) + b[:, 0]
    out = h[:, None, :].to(dt) * gate
    out = torch.einsum("bsw,wd->bsd", out, p["w_out"].to(dt))
    return out, {"h": h, "conv": conv_state}


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None):
    W = cfg.lru_width or cfg.d_model
    K = cfg.conv1d_width
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, K - 1, W), dtype=dtype, device=device),
    }

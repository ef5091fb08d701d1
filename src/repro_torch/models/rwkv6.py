"""RWKV-6 "Finch" layer (arXiv:2404.05892): attention-free time-mix with
data-dependent decay + token-shift channel-mix.

Recurrence per head (key dim i, value dim j):
    y_t[j]     = sum_i r_t[i] * (S_t[i,j] + u[i] * k_t[i] * v_t[j])
    S_{t+1}    = diag(w_t) S_t + k_t v_t^T
with per-channel, *data-dependent* decay w_t = exp(-exp(w0 + lora(x_t))).

The full-sequence path is chunked (a loop over chunks of CHUNK tokens):
cross-chunk terms go through the carried state S; intra-chunk terms use
*log-space pairwise exponent differences* ``exp(cw[t-1] - cw[s])``, which
are always <= 0 for s < t, so the chunked path is exact — no decay
clamping (the ``exp(-cw_s)`` overflow of the rescaled matmul form is
avoided).  :func:`wkv6_chunked` is the model's own recurrence (the one the
reference trains through); ``time_mix(..., use_kernel=True)`` takes the
WKV6 kernel instead (``repro_torch.kernels.ops.wkv6``: the hand-written
CUDA kernel for a CUDA tensor, its plain PyTorch version for a CPU one).

Decode is the O(1) recurrence (:func:`time_mix_decode`).  The recurrence
runs in float32; ``g`` and the output projection in the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig
from repro_torch.models.layers import (
    ParamDef, normal_init, ones_init, uniform_init, zeros_init,
)

CHUNK = 64
DECAY_LORA = 64


def rwkv_defs(cfg: ArchConfig):
    D = cfg.d_model
    H = D // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    ff = cfg.d_ff
    return {
        "time": {
            # static token-shift lerp coefficients for r,k,v,g,w
            "mu": ParamDef((5, D), init=uniform_init(0.0, 1.0),
                           axes=(None, "embed")),
            # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
            "w0": ParamDef((D,), init=constant_like_decay, axes=("embed",)),
            "wA": ParamDef((D, DECAY_LORA), init=normal_init(0.01),
                           axes=("embed", None)),
            "wB": ParamDef((DECAY_LORA, D), init=normal_init(0.01),
                           axes=(None, "embed")),
            "wr": ParamDef((D, D), axes=("embed", "heads")),
            "wk": ParamDef((D, D), axes=("embed", "heads")),
            "wv": ParamDef((D, D), axes=("embed", "heads")),
            "wg": ParamDef((D, D), axes=("embed", "heads")),
            "wo": ParamDef((D, D), axes=("heads", "embed")),
            "u": ParamDef((H, hd), init=normal_init(0.3),
                          axes=("heads", None)),
            # per-head group-norm on the wkv output
            "ln_scale": ParamDef((D,), init=ones_init, axes=("embed",)),
            "ln_bias": ParamDef((D,), init=zeros_init, axes=("embed",)),
        },
        "channel": {
            "mu_k": ParamDef((D,), init=uniform_init(0.0, 1.0),
                             axes=("embed",)),
            "mu_r": ParamDef((D,), init=uniform_init(0.0, 1.0),
                             axes=("embed",)),
            "wk": ParamDef((D, ff), axes=("embed", "mlp")),
            "wv": ParamDef((ff, D), axes=("mlp", "embed")),
            "wr": ParamDef((D, D), axes=("embed", "heads")),
        },
    }


def constant_like_decay(gen, shape, dtype):
    # w0 ~ log(decay rate); exp(-exp(-0.6)) ~ 0.58 initial decay
    return torch.full(shape, -0.6, dtype=dtype, device=gen.device)


def _shift(x, x_prev):
    """Token shift: value of the previous token; x: (B,S,D), x_prev: (B,D)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(x, shifted, mu):
    return x + (shifted - x) * mu.to(x.dtype)


def _group_norm(x, scale, bias, H, eps=1e-5):
    """Per-head layernorm on (B,S,D) viewed as (B,S,H,hd)."""
    B, S, D = x.shape
    xh = x.reshape(B, S, H, D // H).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)     # population variance
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, D) * scale.to(torch.float32)
            + bias.to(torch.float32))


def decay_logw(p, xw):
    """Per-step log decay (negative): -exp(w0 + tanh(x A) B)."""
    f32 = torch.float32
    lora = torch.tanh(xw.to(f32) @ p["wA"].to(f32)) @ p["wB"].to(f32)
    return -torch.exp(torch.clamp(p["w0"].to(f32) + lora, -8.0, 6.0))


def wkv6_chunked(r, k, v, logw, u, s0):
    """Chunked WKV6 recurrence.

    r,k,v,logw: (B, T, H, hd) fp32; u: (H, hd); s0: (B, H, hd, hd).
    Returns y (B,T,H,hd), sT.  T must be a multiple of CHUNK (callers pad).
    """
    B, T, H, hd = r.shape
    n = T // CHUNK
    L = CHUNK

    def chunks(a):                                           # (n,B,H,L,hd)
        return a.reshape(B, n, L, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(chunks, (r, k, v, logw))
    tri_strict = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=r.device), diagonal=-1)
    S = s0
    ys = []
    for c in range(n):
        rb, kb, vb, wb = rc[c], kc[c], vc[c], wc[c]         # (B,H,L,hd)
        cw = torch.cumsum(wb, dim=2)                        # inclusive
        cw_excl = cw - wb                                   # cw[t-1]
        # cross-chunk: y_inter[t] = (r_t * exp(cw_excl_t)) @ S
        y_inter = (rb * torch.exp(cw_excl)) @ S
        # intra-chunk, exact log-space pairwise: exp(cw_excl[t] - cw[s]) <= 1
        diff = cw_excl[:, :, :, None, :] - cw[:, :, None, :, :]  # (B,H,L,L,hd)
        # mask BEFORE exp: future positions have diff > 0 (inf * 0 = nan)
        gate = torch.exp(torch.where(tri_strict[:, :, None], diff,
                                     -torch.inf))
        scores = torch.einsum("bhti,bhtsi->bhts", rb,
                              gate * kb[:, :, None, :, :])
        y_intra = scores @ vb
        # diagonal "bonus" term
        y_diag = (rb * (u[None, :, None, :] * kb)).sum(-1, keepdim=True) * vb
        # state to chunk end: S' = exp(cw_L) S + sum_s exp(cw_L - cw_s) k_s v_s^T
        decay_all = torch.exp(cw[:, :, -1, :])              # (B,H,hd)
        k_dec = kb * torch.exp(cw[:, :, -1:, :] - cw)        # <= 1, safe
        S = decay_all[..., None] * S + k_dec.transpose(-1, -2) @ vb
        ys.append(y_inter + y_intra + y_diag)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, H, hd)
    return y, S


def time_mix(cfg: ArchConfig, p, x, x_prev, s0, use_kernel: bool = False):
    """RWKV6 attention replacement. x: (B,S,D). Returns (out, x_last, sT)."""
    D = cfg.d_model
    H = D // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    B, S, _ = x.shape
    dt = x.dtype
    shifted = _shift(x, x_prev)
    mu = p["mu"]
    xr = _ddlerp(x, shifted, mu[0])
    xk = _ddlerp(x, shifted, mu[1])
    xv = _ddlerp(x, shifted, mu[2])
    xg = _ddlerp(x, shifted, mu[3])
    xw = _ddlerp(x, shifted, mu[4])

    r = (xr @ p["wr"].to(dt)).reshape(B, S, H, hd)
    k = (xk @ p["wk"].to(dt)).reshape(B, S, H, hd)
    v = (xv @ p["wv"].to(dt)).reshape(B, S, H, hd)
    g = F.silu(xg @ p["wg"].to(dt))
    logw = decay_logw(p, xw).reshape(B, S, H, hd)

    f32 = torch.float32
    recurrence = wkv6_chunked
    if use_kernel:
        from repro_torch.kernels import ops as kops
        recurrence = kops.wkv6
    r_, k_, v_, w_ = r.to(f32), k.to(f32), v.to(f32), logw
    pad = (-S) % CHUNK
    if pad:
        # padded steps: w=0 (no decay), k=0 (no contribution)
        r_, k_, v_, w_ = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r_, k_, v_, w_))
    y, sT = recurrence(r_, k_, v_, w_, p["u"].to(f32), s0)
    y = y[:, :S]

    y = _group_norm(y.reshape(B, S, D), p["ln_scale"], p["ln_bias"], H)
    out = (y.to(dt) * g) @ p["wo"].to(dt)
    return out, x[:, -1, :], sT


def time_mix_decode(cfg: ArchConfig, p, x, x_prev, S0):
    """One-token decode. x: (B,1,D); S0: (B,H,hd,hd)."""
    D = cfg.d_model
    H = D // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    B = x.shape[0]
    dt = x.dtype
    shifted = x_prev[:, None, :]
    mu = p["mu"]
    xr = _ddlerp(x, shifted, mu[0])[:, 0]
    xk = _ddlerp(x, shifted, mu[1])[:, 0]
    xv = _ddlerp(x, shifted, mu[2])[:, 0]
    xg = _ddlerp(x, shifted, mu[3])[:, 0]
    xw = _ddlerp(x, shifted, mu[4])[:, 0]

    f32 = torch.float32
    r = (xr @ p["wr"].to(dt)).reshape(B, H, hd).to(f32)
    k = (xk @ p["wk"].to(dt)).reshape(B, H, hd).to(f32)
    v = (xv @ p["wv"].to(dt)).reshape(B, H, hd).to(f32)
    g = F.silu(xg @ p["wg"].to(dt))
    w = torch.exp(decay_logw(p, xw).reshape(B, H, hd))
    u = p["u"].to(f32)

    kv = k[..., :, None] * v[..., None, :]                 # (B,H,hd,hd)
    y = torch.einsum("bhi,bhij->bhj", r, S0 + u[None, :, :, None] * kv)
    S_new = w[..., None] * S0 + kv
    y = _group_norm(y.reshape(B, 1, D), p["ln_scale"], p["ln_bias"], H)
    out = (y.to(dt) * g[:, None, :]) @ p["wo"].to(dt)
    return out, x[:, 0, :], S_new


def channel_mix(cfg: ArchConfig, p, x, x_prev):
    """RWKV channel-mix with token shift. Returns (out, x_last)."""
    dt = x.dtype
    shifted = _shift(x, x_prev)
    xk = _ddlerp(x, shifted, p["mu_k"])
    xr = _ddlerp(x, shifted, p["mu_r"])
    kk = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    rr = torch.sigmoid(xr @ p["wr"].to(dt))
    return rr * (kk @ p["wv"].to(dt)), x[:, -1, :]


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None):
    """Per-layer decode/train-carry state."""
    D = cfg.d_model
    H = D // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    return {
        "att_x": torch.zeros((batch, D), dtype=dtype, device=device),
        "ffn_x": torch.zeros((batch, D), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                           device=device),
    }

"""Grouped-query attention (GQA) with RoPE, for training and prefill.

Attention over a full sequence is chunked over query blocks: each query
block attends to exactly the key prefix it needs, so activation memory is
O(S * chunk) instead of O(S^2).  With the flash flag on
(:func:`set_flash_attention` / ``REPRO_FLASH_ATTN=1``), un-windowed causal
attention instead goes through the hand-written flash-attention kernels
(``repro_torch.kernels.attention``): kv heads are repeated per group and the
MHA layout goes into the kernel.  The flag defaults to off, as in the
reference; it is read at every call (the port has no compiled programs to
invalidate).

MLA, cross-attention, bidirectional (encoder) attention and one-token decode
belong to model families not ported yet: ``models/transformer`` raises
``NotImplementedError`` naming ROADMAP M9 for them.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.models.layers import (
    ParamDef, apply_rope, einsum_f32, zeros_init,
)

NEG_INF = -1e30

_FLASH_OVERRIDE: Optional[bool] = None


def set_flash_attention(mode: Optional[bool]) -> None:
    """Force the flash-attention kernels on/off; None -> env flag."""
    global _FLASH_OVERRIDE
    _FLASH_OVERRIDE = mode


def use_flash_attention() -> bool:
    if _FLASH_OVERRIDE is not None:
        return _FLASH_OVERRIDE
    return os.environ.get("REPRO_FLASH_ATTN", "0") == "1"


def attn_defs(cfg: ArchConfig):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, cfg.n_heads, hd)),
        "wk": ParamDef((d, cfg.n_kv_heads, hd)),
        "wv": ParamDef((d, cfg.n_kv_heads, hd)),
        "wo": ParamDef((cfg.n_heads, hd, d)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), init=zeros_init)
        defs["k_norm"] = ParamDef((hd,), init=zeros_init)
    return defs


def _rms_head_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def _plain_attention(q, k, v, mask):
    """Full-materialization attention.  q: (B, Sq, K, G, D); k, v:
    (B, Sk, K, D); mask: (Sq, Sk) bool -> (B, Sq, K, G, D)."""
    scores = einsum_f32("bqkgd,bskd->bkgqs", q, k)
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def _causal_mask(sq: int, sk: int, q_offset: int, device=None):
    # query i (absolute q_offset + i) may see key j iff j <= q_offset + i
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    return torch.arange(sk, device=device)[None, :] <= qi


def _flash_gqa(q, k, v):
    """Grouped causal attention through the flash kernels.

    q: (B, S, K, G, D); k, v: (B, S, K, D).  The kernels take MHA layout
    (B, H, S, D), so kv heads are repeated per group (query head h = k*G + g
    reads kv head k) and the output is folded back to the grouped layout."""
    from repro_torch.kernels import ops
    B, S, K, G, D = q.shape
    qh = q.reshape(B, S, K * G, D).transpose(1, 2)
    kh = torch.repeat_interleave(k, G, dim=2).transpose(1, 2)
    vh = torch.repeat_interleave(v, G, dim=2).transpose(1, 2)
    out = ops.flash_attention(qh, kh, vh, causal=True)
    return out.transpose(1, 2).reshape(B, S, K, G, D)


def chunked_causal_attention(q, k, v, *, q_chunk: int = 1024):
    """Causal attention, chunked over query blocks.

    q: (B, S, K, G, D); k, v: (B, S, K, D).  Block i attends keys
    [0, (i+1)*q_chunk).  With the flash flag on, the flash kernels take the
    whole sequence instead.  (The reference's banded ``window`` serves local
    attention, which is not ported: ROADMAP M9.)"""
    S = q.shape[1]
    if use_flash_attention():
        return _flash_gqa(q, k, v)
    if S <= q_chunk:
        return _plain_attention(q, k, v, _causal_mask(S, S, 0, q.device))
    assert S % q_chunk == 0, (S, q_chunk)
    outs = []
    for i in range(S // q_chunk):
        q_lo, q_hi = i * q_chunk, (i + 1) * q_chunk
        outs.append(_plain_attention(
            q[:, q_lo:q_hi], k[:, :q_hi], v[:, :q_hi],
            _causal_mask(q_chunk, q_hi, q_lo, q.device)))
    return torch.cat(outs, dim=1)


def _project_qkv(cfg, p, x, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhf->bshf", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dkf->bskf", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dkf->bskf", x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = _rms_head_norm(q, p["q_norm"])
        k = _rms_head_norm(k, p["k_norm"])
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(cfg: ArchConfig, p, x, positions):
    """Training/prefill self-attention.  x: (B, S, d) -> (B, S, d), plus
    the projected (k, v)."""
    B, S, _ = x.shape
    K = cfg.n_kv_heads
    G = cfg.n_heads // K
    q, k, v = _project_qkv(cfg, p, x, positions)
    qg = q.reshape(B, S, K, G, q.shape[-1])
    ctx = chunked_causal_attention(qg, k, v)
    ctx = ctx.reshape(B, S, cfg.n_heads, -1)
    out = torch.einsum("bshf,hfd->bsd", ctx, p["wo"].to(x.dtype))
    return out, (k, v)


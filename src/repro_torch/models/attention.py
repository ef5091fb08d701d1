"""Attention mixers: GQA (with RoPE and an optional sliding window), MLA and
encoder-decoder cross-attention, for training, prefill and decode.

Attention over a full sequence is chunked over query blocks: each query
block attends to exactly the key prefix (causal) or band (windowed) it
needs, so activation memory is O(S * chunk) instead of O(S^2) and windowed
attention does no out-of-band work.  With the flash flag on
(:func:`set_flash_attention` / ``REPRO_FLASH_ATTN=1``), un-windowed causal
attention whose v has q's head dim instead goes through the hand-written
flash-attention kernels (``repro_torch.kernels.attention``): kv heads are
repeated per group and the MHA layout goes into the kernel.  Windowed
attention and MLA (qk dim 192, v dim 128) keep the chunked path, as in the
reference.  The flag defaults to off, as in the reference; it is read at
every call (the port has no compiled programs to invalidate).

MLA (DeepSeek-V2) trains in the decompressed form and decodes in the
*absorbed* form: the cache holds only the compressed latent and the shared
RoPE key, and W_uk / W_uv fold into the query and output projections.
One-token GQA decode is ``models/transformer``'s (its cache layouts:
``models/kvcache``).
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.models.layers import (
    ParamDef, apply_rope, einsum_f32, rmsnorm, zeros_init,
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


def cross_attn_defs(cfg: ArchConfig):
    # encoder-decoder cross attention (whisper): full MHA, kv from encoder
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, cfg.n_heads, hd)),
        "wk": ParamDef((d, cfg.n_heads, hd)),
        "wv": ParamDef((d, cfg.n_heads, hd)),
        "wo": ParamDef((cfg.n_heads, hd, d)),
    }


def mla_defs(cfg: ArchConfig):
    m = cfg.mla
    d = cfg.d_model
    H = cfg.n_heads
    defs = {
        "w_dkv": ParamDef((d, m.kv_lora_rank)),
        "w_kr": ParamDef((d, m.qk_rope_head_dim)),
        "kv_norm": ParamDef((m.kv_lora_rank,), init=zeros_init),
        "w_uk": ParamDef((m.kv_lora_rank, H, m.qk_nope_head_dim)),
        "w_uv": ParamDef((m.kv_lora_rank, H, m.v_head_dim)),
        "w_o": ParamDef((H, m.v_head_dim, d)),
    }
    if m.q_lora_rank:
        defs["w_dq"] = ParamDef((d, m.q_lora_rank))
        defs["q_norm"] = ParamDef((m.q_lora_rank,), init=zeros_init)
        defs["w_uq"] = ParamDef(
            (m.q_lora_rank, H, m.qk_nope_head_dim + m.qk_rope_head_dim))
    else:
        defs["w_q"] = ParamDef(
            (d, H, m.qk_nope_head_dim + m.qk_rope_head_dim))
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


def _causal_mask(sq: int, sk: int, q_offset: int, window: int = 0,
                 device=None):
    # query i (absolute q_offset + i) may see key j iff j <= q_offset + i
    # and, windowed, j > q_offset + i - window
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= kj > qi - window
    return m


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


def chunked_causal_attention(q, k, v, *, window: int = 0,
                             q_chunk: int = 1024):
    """Causal (optionally banded) attention, chunked over query blocks.

    q: (B, S, K, G, D); k, v: (B, S, K, Dv).  Block i attends keys
    [lo_i, (i+1)*q_chunk) with lo_i = 0, or, windowed, the chunk boundary
    at or below i*q_chunk - window: static key ranges, no out-of-band work.
    With the flash flag on, un-windowed attention with Dv = D takes the
    flash kernels over the whole sequence instead."""
    B, S, K, G, D = q.shape
    if window == 0 and v.shape[-1] == D and use_flash_attention():
        return _flash_gqa(q, k, v)
    if S <= q_chunk:
        return _plain_attention(q, k, v, _causal_mask(S, S, 0, window,
                                                      q.device))
    assert S % q_chunk == 0, (S, q_chunk)
    outs = []
    for i in range(S // q_chunk):
        q_lo, q_hi = i * q_chunk, (i + 1) * q_chunk
        k_lo = max(0, (q_lo - window) // q_chunk * q_chunk) if window else 0
        outs.append(_plain_attention(
            q[:, q_lo:q_hi], k[:, k_lo:q_hi], v[:, k_lo:q_hi],
            _causal_mask(q_chunk, q_hi - k_lo, q_lo - k_lo, window,
                         q.device)))
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


def gqa_attention(cfg: ArchConfig, p, x, positions, *, window: int = 0):
    """Training/prefill self-attention.  x: (B, S, d) -> (B, S, d), plus
    the projected (k, v)."""
    B, S, _ = x.shape
    K = cfg.n_kv_heads
    G = cfg.n_heads // K
    q, k, v = _project_qkv(cfg, p, x, positions)
    qg = q.reshape(B, S, K, G, q.shape[-1])
    ctx = chunked_causal_attention(qg, k, v, window=window)
    ctx = ctx.reshape(B, S, cfg.n_heads, -1)
    out = torch.einsum("bshf,hfd->bsd", ctx, p["wo"].to(x.dtype))
    return out, (k, v)


def gqa_bidirectional(cfg: ArchConfig, p, x, positions):
    """Bidirectional self-attention (encoder side of enc-dec models)."""
    B, S, _ = x.shape
    K = cfg.n_kv_heads
    G = cfg.n_heads // K
    q, k, v = _project_qkv(cfg, p, x, positions)
    qg = q.reshape(B, S, K, G, q.shape[-1])
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
    ctx = _plain_attention(qg, k, v, mask)
    ctx = ctx.reshape(B, S, cfg.n_heads, -1)
    return torch.einsum("bshf,hfd->bsd", ctx, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attention(cfg: ArchConfig, p, x, enc_kv):
    """x: (B, S, d); enc_kv: (k, v) each (B, T, H, D) precomputed from the
    encoder."""
    k, v = enc_kv
    dt = x.dtype
    q = torch.einsum("bsd,dhf->bshf", x, p["wq"].to(dt))
    scores = einsum_f32("bshf,bthf->bhst", q, k)
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,bthf->bshf", probs.to(dt), v)
    return torch.einsum("bshf,hfd->bsd", ctx, p["wo"].to(dt))


def encode_cross_kv(cfg: ArchConfig, p, enc_out):
    dt = enc_out.dtype
    k = torch.einsum("btd,dhf->bthf", enc_out, p["wk"].to(dt))
    v = torch.einsum("btd,dhf->bthf", enc_out, p["wv"].to(dt))
    return k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_q(cfg, p, x, positions):
    m = cfg.mla
    dt = x.dtype
    if m.q_lora_rank:
        cq = rmsnorm(torch.einsum("bsd,dr->bsr", x, p["w_dq"].to(dt)),
                     p["q_norm"])
        q = torch.einsum("bsr,rhf->bshf", cq, p["w_uq"].to(dt))
    else:
        q = torch.einsum("bsd,dhf->bshf", x, p["w_q"].to(dt))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(cfg, p, x, positions):
    dt = x.dtype
    c = rmsnorm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(dt)),
                p["kv_norm"])
    k_rope = torch.einsum("bsd,df->bsf", x, p["w_kr"].to(dt))
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c, k_rope


def mla_attention(cfg: ArchConfig, p, x, positions, *, window: int = 0):
    """Training/prefill MLA in decompressed form; returns (out, (c,
    k_rope))."""
    m = cfg.mla
    B, S, _ = x.shape
    dt = x.dtype
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhf->bshf", c, p["w_uk"].to(dt))
    v = torch.einsum("bsr,rhf->bshf", c, p["w_uv"].to(dt))
    # fold rope part in by concatenation (k_rope shared across heads)
    k_rope_h = k_rope[:, :, None, :].expand(B, S, cfg.n_heads,
                                            m.qk_rope_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h], dim=-1)
    # scale uses the full qk dim (nope+rope), matching DeepSeek-V2
    qg = q_full.reshape(B, S, cfg.n_heads, 1, q_full.shape[-1])
    ctx = chunked_causal_attention(qg, k_full, v, window=window)
    ctx = ctx.reshape(B, S, cfg.n_heads, m.v_head_dim)
    out = torch.einsum("bshf,hfd->bsd", ctx, p["w_o"].to(dt))
    return out, (c, k_rope)


def mla_decode(cfg: ArchConfig, p, x, c_cache, kr_cache, cache_mask,
               positions):
    """Absorbed-form decode: the cache holds (latent c, shared rope key)
    only.

    scores = q_nope . (c @ W_uk) + q_rope . k_rope
           = (q_nope @ W_uk^T) . c + q_rope . k_rope     (absorb W_uk)
    out    = (probs . c) @ W_uv @ W_o                     (absorb W_uv)
    """
    m = cfg.mla
    dt = x.dtype
    q_nope, q_rope = _mla_q(cfg, p, x, positions)          # (B,1,H,*)
    c_new, kr_new = _mla_latent(cfg, p, x, positions)      # (B,1,r), (B,1,f)
    # absorb W_uk into the query: (B,1,H,r)
    q_lat = torch.einsum("bshf,rhf->bshr", q_nope, p["w_uk"].to(dt))
    scores = einsum_f32("bhr,btr->bht", q_lat[:, 0], c_cache)
    scores = scores + einsum_f32("bhf,btf->bht", q_rope[:, 0], kr_cache)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = torch.where(cache_mask[:, None, :], scores * scale, NEG_INF)
    probs = torch.softmax(scores, dim=-1)                  # (B,H,L)
    ctx_lat = torch.einsum("bht,btr->bhr", probs.to(dt), c_cache)
    ctx = torch.einsum("bhr,rhf->bhf", ctx_lat, p["w_uv"].to(dt))
    out = torch.einsum("bhf,hfd->bd", ctx, p["w_o"].to(dt))[:, None, :]
    return out, (c_new, kr_new)

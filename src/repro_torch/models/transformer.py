"""Decoder-only stack: GQA attention + dense FFN layers, and RWKV6 layers.

A model is described by ``ArchConfig.layer_pattern`` (one mixer name per
layer).  Consecutive layers of the same (mixer, ffn) kind form a *segment*
whose parameters are stacked on a leading "layers" axis — the reference's
tree layout (``params["segments"][i]`` is a dict of stacked leaves), so the
same numpy arrays load into both packages.  The reference scans a segment
with ``jax.lax.scan``; here a Python loop runs its layers one by one, with
no rematerialization (the reference's ``transformer_lm`` turns remat off
too).

Entry points: ``forward`` (full sequence -> ``(logits, aux)``) and
``decode_step`` (one token against the caches of ``init_cache``; it
updates the cache tensors in place and returns the cache).

Ported: the ``attn`` mixer with the ``dense`` FFN (RoPE or no positional
embedding), and the ``rwkv6`` mixer with its channel-mix; linear and ring
attention caches and the RWKV6 recurrent state.  Other mixers (MLA, RG-LRU,
local attention), MoE FFNs, encoders and learned positions raise
``NotImplementedError`` naming ROADMAP M9.

**WKV6 routing.**  Inside an ``rwkv6`` layer the full-sequence recurrence
takes the WKV6 kernel (``time_mix(..., use_kernel=True)``: the CUDA kernel
on the card, its plain version on the CPU) whenever autograd is not
recording — ``use_kernel = not torch.is_grad_enabled()`` — so prefill,
serving and evaluation under ``torch.no_grad()`` run the kernel, and a
forward that autograd records takes the model's own ``wkv6_chunked``, the
path the reference trains through (the kernel has no backward, in the
reference as here).  This is the one place the port routes differently
from the reference, whose full-sequence forward always takes
``wkv6_chunked``; the two agree up to summation order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (
    ParamDef, apply_norm, norm_defs, normal_init, stack_defs,
)
from repro_torch.utils.tree import tree_map

@dataclasses.dataclass(frozen=True)
class Segment:
    mixer: str          # attn, rwkv6 (ported) | local_attn | mla | rglru
    ffn: str            # dense, rwkv (ported) | dense0 | moe
    count: int


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP M9); ported: "
        f"decoder-only 'attn' layers with a dense FFN and 'rwkv6' layers")


def segments(cfg: ArchConfig) -> List[Segment]:
    kinds = []
    for li, mixer in enumerate(cfg.layer_pattern):
        if cfg.family == "ssm":
            ffn = "rwkv"
        elif cfg.moe is not None:
            ffn = "dense0" if li < cfg.moe.first_dense_layers else "moe"
        else:
            ffn = "dense"
        kinds.append((mixer, ffn))
    segs: List[Segment] = []
    for kind in kinds:
        if segs and (segs[-1].mixer, segs[-1].ffn) == kind:
            segs[-1] = dataclasses.replace(segs[-1], count=segs[-1].count + 1)
        else:
            segs.append(Segment(kind[0], kind[1], 1))
    return segs


def _layer_defs(cfg: ArchConfig, seg: Segment):
    if seg.mixer == "rwkv6":
        defs = rwkv_mod.rwkv_defs(cfg)
        return {"norm1": norm_defs(cfg), "time": defs["time"],
                "norm2": norm_defs(cfg), "channel": defs["channel"]}
    if seg.mixer != "attn" or seg.ffn != "dense":
        raise _unported(f"a {seg.mixer!r} layer with a {seg.ffn!r} FFN")
    return {"norm1": norm_defs(cfg), "attn": attn.attn_defs(cfg),
            "norm2": norm_defs(cfg), "mlp": mlp_mod.mlp_defs(cfg)}


def model_defs(cfg: ArchConfig):
    if cfg.encoder_layers:
        raise _unported("an encoder-decoder model")
    if cfg.pos_embedding not in ("rope", "none"):
        raise _unported(f"pos_embedding={cfg.pos_embedding!r}")
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), init=normal_init(0.02)),
        "final_norm": norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab),
                                   init=normal_init(0.02))
    defs["segments"] = [stack_defs(_layer_defs(cfg, s), s.count)
                        for s in segments(cfg)]
    return defs


def _apply_layer(cfg: ArchConfig, seg: Segment, p, x, positions):
    """One layer over the full sequence."""
    h = apply_norm(cfg, p["norm1"], x)
    if seg.mixer == "rwkv6":
        B = x.shape[0]
        hd = cfg.rwkv_head_dim
        s0 = torch.zeros((B, cfg.d_model // hd, hd, hd), dtype=torch.float32,
                         device=x.device)
        x_prev = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
        out, _, _ = rwkv_mod.time_mix(cfg, p["time"], h, x_prev, s0,
                                      use_kernel=not torch.is_grad_enabled())
        x = x + out
        h2 = apply_norm(cfg, p["norm2"], x)
        out2, _ = rwkv_mod.channel_mix(cfg, p["channel"], h2, x_prev)
        return x + out2
    out, _ = attn.gqa_attention(cfg, p["attn"], h, positions)
    x = x + out
    h = apply_norm(cfg, p["norm2"], x)
    return x + mlp_mod.mlp(cfg, p["mlp"], h)


def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def forward(cfg: ArchConfig, params, tokens):
    """Full-sequence forward.  tokens: (B, S) int -> ``(logits (B, S, V)
    f32, aux)``; ``aux`` (the reference's MoE loss slot) is 0."""
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][tokens].to(dt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for seg, seg_params in zip(segments(cfg), params["segments"]):
        for li in range(seg.count):
            x = _apply_layer(cfg, seg, _layer(seg_params, li), x, positions)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x), torch.zeros((), device=x.device)


def unembed(cfg: ArchConfig, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype)).to(torch.float32)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _seg_cache_specs(cfg: ArchConfig, seg: Segment, batch: int, length: int,
                     ring: bool, dtype):
    if seg.mixer == "attn":
        L = cfg.decode_window if ring else length
        base = kvc.attn_cache_defs(cfg, batch, L, dtype)
    elif seg.mixer == "rwkv6":
        H = cfg.d_model // cfg.rwkv_head_dim
        hd = cfg.rwkv_head_dim
        base = {
            "att_x": kvc.spec((batch, cfg.d_model), dtype),
            "ffn_x": kvc.spec((batch, cfg.d_model), dtype),
            "wkv": kvc.spec((batch, H, hd, hd), torch.float32),
        }
    else:
        raise _unported(f"a {seg.mixer!r} decode cache")
    # stack over the segment's layers
    return tree_map(lambda s: kvc.spec((seg.count,) + tuple(s.shape),
                                       s.dtype), base)


def cache_specs(cfg: ArchConfig, batch: int, length: int, ring: bool):
    """The cache tree as meta tensors (shapes and dtypes, no storage)."""
    dtype = getattr(torch, cfg.dtype)
    return {"segments": [_seg_cache_specs(cfg, s, batch, length, ring, dtype)
                         for s in segments(cfg)]}


def init_cache(cfg: ArchConfig, batch: int, length: int, ring: bool,
               device=None):
    return kvc.zeros_like_specs(cache_specs(cfg, batch, length, ring), device)


def _decode_attn(cfg: ArchConfig, p, h, cache, pos: int, ring: bool):
    """One-token GQA against the layer's cache (written in place)."""
    length = cache["k"].shape[1]
    slot = kvc.cache_slot(pos, length, ring)
    B = h.shape[0]
    positions = torch.full((B, 1), pos, device=h.device)
    # project q,k,v (rope applied with absolute position), write cache
    q, k, v = attn._project_qkv(cfg, p, h, positions)
    k_cache = kvc.write_slot(cache["k"], k, slot)
    v_cache = kvc.write_slot(cache["v"], v, slot)
    mask = kvc.cache_mask(B, pos, length, ring, h.device)
    K = cfg.n_kv_heads
    G = cfg.n_heads // K
    qg = q.reshape(B, 1, K, G, q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).to(torch.float32)
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.where(mask[:, None, None, None, :], scores, attn.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v_cache.dtype), v_cache)
    ctx = ctx.reshape(B, 1, cfg.n_heads, -1)
    return torch.einsum("bshf,hfd->bsd", ctx, p["wo"].to(h.dtype))


def _decode_layer(cfg: ArchConfig, seg: Segment, p, x, cache, pos: int,
                  ring: bool):
    """One-layer one-token decode; updates the layer's ``cache`` (views
    into the segment's stacked cache) in place and returns x."""
    h = apply_norm(cfg, p["norm1"], x)
    if seg.mixer == "rwkv6":
        out, att_x, wkv = rwkv_mod.time_mix_decode(cfg, p["time"], h,
                                                   cache["att_x"],
                                                   cache["wkv"])
        x = x + out
        h2 = apply_norm(cfg, p["norm2"], x)
        out2, ffn_x = rwkv_mod.channel_mix(cfg, p["channel"], h2,
                                           cache["ffn_x"])
        for key, new in (("att_x", att_x), ("ffn_x", ffn_x), ("wkv", wkv)):
            cache[key].copy_(new)
        return x + out2
    if seg.mixer != "attn":
        raise _unported(f"one-token decode of a {seg.mixer!r} layer")
    x = x + _decode_attn(cfg, p["attn"], h, cache, pos, ring)
    h = apply_norm(cfg, p["norm2"], x)
    return x + mlp_mod.mlp(cfg, p["mlp"], h)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos,
                ring: bool = False):
    """One decode step.  tokens: (B,1) int; pos: int (position of this
    token).  Returns (logits (B,1,V) f32, cache) — the cache updated in
    place."""
    pos = int(pos)
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][tokens].to(dt)
    for seg, seg_params, seg_cache in zip(segments(cfg), params["segments"],
                                          cache["segments"]):
        for li in range(seg.count):
            x = _decode_layer(cfg, seg, _layer(seg_params, li), x,
                              _layer(seg_cache, li), pos, ring)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x), cache

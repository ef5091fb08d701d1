"""Composable decoder / encoder-decoder stack covering every family of the
reference: GQA attention (global or windowed), MLA, RWKV6 and RG-LRU
mixers, dense / MoE FFNs, the VLM's frame prefix and the audio family's
encoder with cross-attention.

A model is described by ``ArchConfig.layer_pattern`` (one mixer name per
layer).  Consecutive layers of the same (mixer, ffn) kind form a *segment*
whose parameters are stacked on a leading "layers" axis — the reference's
tree layout (``params["segments"][i]`` is a dict of stacked leaves), so the
same numpy arrays load into both packages; RecurrentGemma's (rglru,
rglru, local_attn) pattern becomes alternating short segments.  The
reference scans a segment with ``jax.lax.scan``; here a Python loop runs
its layers one by one.  With ``remat`` each layer runs under
``torch.utils.checkpoint`` (the reference's per-layer ``jax.checkpoint``):
its activations are recomputed in the backward instead of kept.

Entry points: ``forward`` (full sequence -> ``(logits, aux)``, ``aux`` the
MoE load-balance loss summed over layers), ``loss_fn`` (next-token
cross-entropy, over the text region for the VLM, plus the weighted
``aux``) and ``decode_step`` (one token against the caches of
``init_cache``; it updates the cache tensors in place and returns the
cache).  The VLM (``family="vlm"``) prepends ``frames`` to the token
embeddings under plain causal attention; the audio family
(``encoder_layers > 0``) runs a bidirectional encoder over ``frames``
with its own learned positions and feeds every decoder layer's
cross-attention.  Decode reads the cross-attention K/V of each decoder
layer from ``cache["enc_kv"]`` (zeros from ``init_cache`` unless the
caller fills it, as the reference's serve path leaves them).

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
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (
    ParamDef, apply_norm, einsum_f32, norm_defs, normal_init, stack_defs,
)
from repro_torch.utils.tree import tree_map

@dataclasses.dataclass(frozen=True)
class Segment:
    mixer: str          # attn | local_attn | mla | rwkv6 | rglru
    ffn: str            # dense | dense0 | moe | rwkv (fused channel-mix)
    count: int
    first_layer: int


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
    for li, kind in enumerate(kinds):
        if segs and (segs[-1].mixer, segs[-1].ffn) == kind:
            segs[-1] = dataclasses.replace(segs[-1], count=segs[-1].count + 1)
        else:
            segs.append(Segment(kind[0], kind[1], 1, li))
    return segs


def _layer_defs(cfg: ArchConfig, seg: Segment, cross: bool):
    d: Dict[str, Any] = {"norm1": norm_defs(cfg)}
    if seg.mixer in ("attn", "local_attn"):
        d["attn"] = attn.attn_defs(cfg)
    elif seg.mixer == "mla":
        d["mla"] = attn.mla_defs(cfg)
    elif seg.mixer == "rwkv6":
        if cross:
            raise ValueError("rwkv6 decoder with cross attention unsupported")
        defs = rwkv_mod.rwkv_defs(cfg)
        return {"norm1": norm_defs(cfg), "time": defs["time"],
                "norm2": norm_defs(cfg), "channel": defs["channel"]}
    elif seg.mixer == "rglru":
        d["rglru"] = rglru_mod.rglru_defs(cfg)
    else:
        raise ValueError(seg.mixer)
    if cross:
        d["norm_cross"] = norm_defs(cfg)
        d["cross"] = attn.cross_attn_defs(cfg)
    d["norm2"] = norm_defs(cfg)
    if seg.ffn == "dense":
        d["mlp"] = mlp_mod.mlp_defs(cfg)
    elif seg.ffn == "dense0":
        d["mlp"] = mlp_mod.mlp_defs(cfg, d_ff=cfg.moe.dense_d_ff or cfg.d_ff)
    elif seg.ffn == "moe":
        d["moe"] = moe_mod.moe_defs(cfg)
    return d


def model_defs(cfg: ArchConfig):
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), init=normal_init(0.02),
                          axes=("vocab", "embed")),
        "final_norm": norm_defs(cfg),
    }
    if cfg.pos_embedding == "learned":
        defs["pos_embed"] = ParamDef((cfg.max_seq_len, cfg.d_model),
                                     init=normal_init(0.02),
                                     axes=(None, "embed"))
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab),
                                   init=normal_init(0.02),
                                   axes=("embed", "vocab"))
    cross = cfg.encoder_layers > 0
    defs["segments"] = [stack_defs(_layer_defs(cfg, s, cross), s.count)
                        for s in segments(cfg)]
    if cross:
        enc_seg = Segment("attn", "dense", cfg.encoder_layers, 0)
        defs["encoder"] = {
            "pos_embed": ParamDef((cfg.n_frames, cfg.d_model),
                                  init=normal_init(0.02),
                                  axes=(None, "embed")),
            "layers": stack_defs(_layer_defs(cfg, enc_seg, cross=False),
                                 cfg.encoder_layers),
            "final_norm": norm_defs(cfg),
        }
    return defs


def _ffn(cfg: ArchConfig, seg: Segment, p, h):
    """The layer's FFN on the normed h -> (out, aux)."""
    if seg.ffn == "moe":
        return moe_mod.moe_apply(cfg, p["moe"], h)
    return mlp_mod.mlp(cfg, p["mlp"], h), None


def _apply_layer(cfg: ArchConfig, seg: Segment, p, x, positions,
                 enc_kv=None):
    """One layer over the full sequence -> (x, aux); aux is None unless
    the layer's FFN is MoE.  ``enc_kv``: the layer's cross-attention K/V
    (encoder-decoder models)."""
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
        return x + out2, None
    if seg.mixer == "attn":
        out, _ = attn.gqa_attention(cfg, p["attn"], h, positions)
    elif seg.mixer == "local_attn":
        out, _ = attn.gqa_attention(cfg, p["attn"], h, positions,
                                    window=cfg.window)
    elif seg.mixer == "mla":
        out, _ = attn.mla_attention(cfg, p["mla"], h, positions)
    elif seg.mixer == "rglru":
        state = rglru_mod.init_state(cfg, x.shape[0], x.dtype, x.device)
        out, _ = rglru_mod.rglru_block(cfg, p["rglru"], h, state)
    else:
        raise ValueError(seg.mixer)
    x = x + out
    if enc_kv is not None:
        hc = apply_norm(cfg, p["norm_cross"], x)
        x = x + attn.cross_attention(cfg, p["cross"], hc, enc_kv)
    out, aux = _ffn(cfg, seg, p, apply_norm(cfg, p["norm2"], x))
    return x + out, aux


def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def _encoder_layer(cfg: ArchConfig, p, x, positions):
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn.gqa_bidirectional(cfg, p["attn"], h, positions)
    h = apply_norm(cfg, p["norm2"], x)
    return x + mlp_mod.mlp(cfg, p["mlp"], h)


def _remat(fn, p, x):
    """``fn(p, x)`` under non-reentrant ``torch.utils.checkpoint``.  No
    op of a layer draws from a generator, so the recompute needs no saved
    RNG state (``preserve_rng_state=False``: the same values, bit for bit,
    and no save or restore of the CUDA generator's state inside a
    CUDA-graph capture of the train step)."""
    return checkpoint(fn, p, x, use_reentrant=False,
                      preserve_rng_state=False)


def _encoder_forward(cfg: ArchConfig, params, frames, remat: bool):
    enc = params["encoder"]
    x = frames + enc["pos_embed"][None, :frames.shape[1]].to(frames.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None]

    def fn(p, xx):
        return _encoder_layer(cfg, p, xx, positions)
    for li in range(cfg.encoder_layers):
        p = _layer(enc["layers"], li)
        x = (_remat(fn, p, x) if remat else fn(p, x))
    return apply_norm(cfg, enc["final_norm"], x)


def forward(cfg: ArchConfig, params, tokens, frames=None,
            remat: bool = False):
    """Full-sequence forward.  tokens: (B, S_text) int; frames: (B, F,
    d_model) for the VLM (a prefix of the sequence) and audio (the
    encoder's input) families.  -> ``(logits (B, S, V) f32, aux)``;
    ``aux`` is the MoE load-balance loss summed over layers (0 without
    MoE).  ``remat``: each layer under ``torch.utils.checkpoint``
    (non-reentrant)."""
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][tokens].to(dt)
    if cfg.family == "vlm":
        assert frames is not None
        x = torch.cat([frames.to(dt), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"][None, :S].to(dt)
    enc_out = None
    if cfg.encoder_layers:
        assert frames is not None
        enc_out = _encoder_forward(cfg, params, frames.to(dt), remat)
    aux = torch.zeros((), device=x.device)
    for seg, seg_params in zip(segments(cfg), params["segments"]):
        def fn(p, xx, seg=seg):
            # cross-attention K/V are computed per layer inside the
            # (checkpointed) layer, as the reference's scan body does
            kv = (None if enc_out is None
                  else attn.encode_cross_kv(cfg, p["cross"], enc_out))
            return _apply_layer(cfg, seg, p, xx, positions, kv)
        for li in range(seg.count):
            p = _layer(seg_params, li)
            if remat:
                x, layer_aux = _remat(fn, p, x)
            else:
                x, layer_aux = fn(p, x)
            if layer_aux is not None:
                aux = aux + layer_aux
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x), aux


def unembed(cfg: ArchConfig, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return einsum_f32("bsd,dv->bsv", x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_fn(cfg: ArchConfig, params, batch, remat: bool = True):
    """Next-token cross-entropy in float32 (over the text region for the
    VLM), plus ``aux_loss_weight * aux`` for MoE.  batch: {"tokens": (B,
    S)[, "frames": (B, F, d_model)]} -> ``(loss, {"nll", "aux"})``."""
    tokens = batch["tokens"]
    frames = batch.get("frames")
    logits, aux = forward(cfg, params, tokens, frames=frames, remat=remat)
    if cfg.family == "vlm":
        logits = logits[:, frames.shape[1]:]     # text region only
    # predict token t+1 from position t
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    labels = tokens[:, 1:].to(torch.int64)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss = nll.mean()
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss, {"nll": nll.mean(), "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _seg_cache_specs(cfg: ArchConfig, seg: Segment, batch: int, length: int,
                     ring: bool, dtype):
    if seg.mixer == "attn":
        L = cfg.decode_window if ring else length
        base = kvc.attn_cache_defs(cfg, batch, L, dtype)
    elif seg.mixer == "local_attn":
        base = kvc.attn_cache_defs(cfg, batch, min(cfg.window, length), dtype)
    elif seg.mixer == "mla":
        L = cfg.decode_window if ring else length
        base = kvc.mla_cache_defs(cfg, batch, L, dtype)
    elif seg.mixer == "rwkv6":
        H = cfg.d_model // cfg.rwkv_head_dim
        hd = cfg.rwkv_head_dim
        base = {
            "att_x": kvc.spec((batch, cfg.d_model), dtype),
            "ffn_x": kvc.spec((batch, cfg.d_model), dtype),
            "wkv": kvc.spec((batch, H, hd, hd), torch.float32),
        }
    elif seg.mixer == "rglru":
        W = cfg.lru_width or cfg.d_model
        base = {
            "h": kvc.spec((batch, W), torch.float32),
            "conv": kvc.spec((batch, cfg.conv1d_width - 1, W), dtype),
        }
    else:
        raise ValueError(seg.mixer)
    # stack over the segment's layers
    return tree_map(lambda s: kvc.spec((seg.count,) + tuple(s.shape),
                                       s.dtype), base)


def cache_specs(cfg: ArchConfig, batch: int, length: int, ring: bool):
    """The cache tree as meta tensors (shapes and dtypes, no storage)."""
    dtype = getattr(torch, cfg.dtype)
    spec: Dict[str, Any] = {
        "segments": [_seg_cache_specs(cfg, s, batch, length, ring, dtype)
                     for s in segments(cfg)]}
    if cfg.encoder_layers:
        shape = (cfg.n_layers, batch, cfg.n_frames, cfg.n_heads,
                 cfg.resolved_head_dim)
        spec["enc_kv"] = {"k": kvc.spec(shape, dtype),
                          "v": kvc.spec(shape, dtype)}
    return spec


def init_cache(cfg: ArchConfig, batch: int, length: int, ring: bool,
               device=None):
    return kvc.zeros_like_specs(cache_specs(cfg, batch, length, ring), device)


def _positions(pos, batch: int):
    """(B, 1) int64 positions of the one decoded token, a view of the 0-d
    device ``pos`` (the dtype ``torch.full((B, 1), int)`` gives, so RoPE
    rounds as it did from a host int)."""
    return pos.reshape(1, 1).expand(batch, 1)


def _decode_attn(cfg: ArchConfig, p, h, cache, pos, ring: bool):
    """One-token GQA against the layer's cache (written in place); ``pos``
    a 0-d tensor (or an int) on ``h``'s device."""
    length = cache["k"].shape[1]
    pos = kvc.as_pos(pos, h.device)
    slot = kvc.cache_slot(pos, length, ring)
    B = h.shape[0]
    positions = _positions(pos, B)
    # project q,k,v (rope applied with absolute position), write cache
    q, k, v = attn._project_qkv(cfg, p, h, positions)
    k_cache = kvc.write_slot(cache["k"], k, slot)
    v_cache = kvc.write_slot(cache["v"], v, slot)
    mask = kvc.cache_mask(B, pos, length, ring, h.device)
    K = cfg.n_kv_heads
    G = cfg.n_heads // K
    qg = q.reshape(B, 1, K, G, q.shape[-1])
    scores = einsum_f32("bqkgd,bskd->bkgqs", qg, k_cache)
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.where(mask[:, None, None, None, :], scores, attn.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v_cache.dtype), v_cache)
    ctx = ctx.reshape(B, 1, cfg.n_heads, -1)
    return torch.einsum("bshf,hfd->bsd", ctx, p["wo"].to(h.dtype))


def _decode_mla(cfg: ArchConfig, p, h, cache, pos, ring: bool):
    """One-token absorbed MLA against the layer's latent cache (written in
    place)."""
    length = cache["c"].shape[1]
    pos = kvc.as_pos(pos, h.device)
    slot = kvc.cache_slot(pos, length, ring)
    B = h.shape[0]
    positions = _positions(pos, B)
    c_new, kr_new = attn._mla_latent(cfg, p, h, positions)
    c_cache = kvc.write_slot(cache["c"], c_new, slot)
    kr_cache = kvc.write_slot(cache["kr"], kr_new, slot)
    mask = kvc.cache_mask(B, pos, length, ring, h.device)
    out, _ = attn.mla_decode(cfg, p, h, c_cache, kr_cache, mask, positions)
    return out


def _copy_state(cache, new):
    for key, t in new.items():
        cache[key].copy_(t)


def _decode_layer(cfg: ArchConfig, seg: Segment, p, x, cache, pos,
                  ring: bool, enc_kv=None):
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
        _copy_state(cache, {"att_x": att_x, "ffn_x": ffn_x, "wkv": wkv})
        return x + out2
    if seg.mixer in ("attn", "local_attn"):
        out = _decode_attn(cfg, p["attn"], h, cache, pos,
                           ring or seg.mixer == "local_attn")
    elif seg.mixer == "mla":
        out = _decode_mla(cfg, p["mla"], h, cache, pos, ring)
    elif seg.mixer == "rglru":
        out, new_state = rglru_mod.rglru_decode(cfg, p["rglru"], h, cache)
        _copy_state(cache, new_state)
    else:
        raise ValueError(seg.mixer)
    x = x + out
    if enc_kv is not None:
        hc = apply_norm(cfg, p["norm_cross"], x)
        x = x + attn.cross_attention(cfg, p["cross"], hc, enc_kv)
    out, _ = _ffn(cfg, seg, p, apply_norm(cfg, p["norm2"], x))
    return x + out


def decode_step(cfg: ArchConfig, params, cache, tokens, pos,
                ring: bool = False):
    """One decode step.  tokens: (B,1) int; pos: the position of this
    token, a 0-d integer tensor (or a Python int, filled into one on
    ``tokens``' device).  Returns (logits (B,1,V) f32, cache) — the cache
    updated in place.  Nothing here reads ``pos`` on the host or makes a
    shape from it, so one CUDA graph of this step serves every position
    (``models/model.py::make_serve_step``).  An encoder-decoder model's
    layer l reads its cross-attention K/V from ``cache["enc_kv"]`` at l
    (views: segments carry ``first_layer``)."""
    pos = kvc.as_pos(pos, tokens.device)
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][tokens].to(dt)
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"].index_select(
            0, pos.reshape(1))[None].to(dt)
    for seg, seg_params, seg_cache in zip(segments(cfg), params["segments"],
                                          cache["segments"]):
        for li in range(seg.count):
            enc_kv = None
            if cfg.encoder_layers:
                layer = seg.first_layer + li
                enc_kv = (cache["enc_kv"]["k"][layer],
                          cache["enc_kv"]["v"][layer])
            x = _decode_layer(cfg, seg, _layer(seg_params, li), x,
                              _layer(seg_cache, li), pos, ring, enc_kv)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x), cache

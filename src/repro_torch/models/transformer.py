"""Decoder-only transformer stack: GQA attention + dense FFN layers.

A model is described by ``ArchConfig.layer_pattern`` (one mixer name per
layer).  Consecutive layers of the same (mixer, ffn) kind form a *segment*
whose parameters are stacked on a leading "layers" axis — the reference's
tree layout (``params["segments"][i]`` is a dict of stacked leaves), so the
same numpy arrays load into both packages.  The reference scans a segment
with ``jax.lax.scan``; here a Python loop runs its layers one by one, with
no rematerialization (the reference's ``transformer_lm`` turns remat off
too).

Ported: the ``attn`` mixer with the ``dense`` FFN, RoPE or no positional
embedding, and the full-sequence ``forward``.  Other mixers (MLA, RWKV6,
RG-LRU, local attention), MoE FFNs, encoders, learned positions and decode
raise ``NotImplementedError`` naming ROADMAP M9.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import (
    ParamDef, apply_norm, norm_defs, normal_init, stack_defs,
)
from repro_torch.utils.tree import tree_map

@dataclasses.dataclass(frozen=True)
class Segment:
    mixer: str          # attn (ported) | local_attn | mla | rwkv6 | rglru
    ffn: str            # dense (ported) | dense0 | moe | rwkv
    count: int


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP M9); ported: "
        f"decoder-only 'attn' layers with a dense FFN")


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


def _apply_layer(cfg: ArchConfig, p, x, positions):
    """One ``attn`` + ``dense`` layer over the full sequence."""
    h = apply_norm(cfg, p["norm1"], x)
    out, _ = attn.gqa_attention(cfg, p["attn"], h, positions)
    x = x + out
    h = apply_norm(cfg, p["norm2"], x)
    return x + mlp_mod.mlp(cfg, p["mlp"], h)


def _run_segment(cfg: ArchConfig, seg_params, x, positions, count: int):
    for li in range(count):
        x = _apply_layer(cfg, tree_map(lambda t, i=li: t[i], seg_params), x,
                         positions)
    return x


def forward(cfg: ArchConfig, params, tokens):
    """Full-sequence forward.  tokens: (B, S) int -> logits (B, S, V) f32."""
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][tokens].to(dt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for seg, seg_params in zip(segments(cfg), params["segments"]):
        x = _run_segment(cfg, seg_params, x, positions, seg.count)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x)


def unembed(cfg: ArchConfig, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype)).to(torch.float32)


def decode_step(*args, **kwargs):
    raise _unported("one-token decode")

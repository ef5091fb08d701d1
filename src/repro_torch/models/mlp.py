"""Feed-forward blocks: SwiGLU and GELU (tanh approximation).

The reference's other activations (GeGLU, squared ReLU, the RWKV
channel-mix gate) belong to model families not ported yet and raise
``NotImplementedError`` naming ROADMAP M9.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig
from repro_torch.models.layers import ParamDef

PORTED_ACTS = ("swiglu", "gelu")


def mlp_defs(cfg: ArchConfig):
    d, ff = cfg.d_model, cfg.d_ff
    defs = {"w_down": ParamDef((ff, d)),
            "w_up": ParamDef((d, ff))}
    if cfg.act == "swiglu":
        defs["w_gate"] = ParamDef((d, ff))
    return defs


def _act(name: str, gate, up):
    if name == "swiglu":
        return F.silu(gate) * up
    if name == "gelu":
        return F.gelu(up, approximate="tanh")
    raise NotImplementedError(
        f"activation {name!r} is not ported to repro_torch yet (ROADMAP "
        f"M9); ported: {PORTED_ACTS}")


def mlp(cfg: ArchConfig, p, x):
    dt = x.dtype
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
    gate = None
    if "w_gate" in p:
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
    h = _act(cfg.act, gate, up)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(dt))

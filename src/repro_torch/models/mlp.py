"""Feed-forward blocks: SwiGLU / GeGLU / GELU / squared ReLU
(tanh-approximate GELU throughout, as the reference).  RWKV's channel-mix
is ``models/rwkv6.py::channel_mix``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig
from repro_torch.models.layers import ParamDef

GATED_ACTS = ("swiglu", "geglu")


def mlp_defs(cfg: ArchConfig, d_ff: int = 0):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    defs = {"w_down": ParamDef((ff, d), axes=("mlp", "embed")),
            "w_up": ParamDef((d, ff), axes=("embed", "mlp"))}
    if cfg.act in GATED_ACTS:
        defs["w_gate"] = ParamDef((d, ff), axes=("embed", "mlp"))
    return defs


def _act(name: str, gate, up):
    if name == "swiglu":
        return F.silu(gate) * up
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if name == "gelu":
        return F.gelu(up, approximate="tanh")
    if name == "sq_relu":
        return torch.square(F.relu(up))
    raise ValueError(f"unknown activation {name}")


def mlp(cfg: ArchConfig, p, x):
    dt = x.dtype
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
    gate = None
    if cfg.act in GATED_ACTS:
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
    h = _act(cfg.act, gate, up)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(dt))

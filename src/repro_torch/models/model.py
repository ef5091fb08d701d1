"""Model facade: ties an ArchConfig to its parameter defs, forward and
decode steps.

The layer the serving driver (``repro_torch.launch.serve``) programs
against.  The step builders run under ``torch.no_grad()``, so an RWKV6
model's prefill and decode take the WKV6 kernel (``models/transformer``).
Training steps, the train state and the dry run's input specs belong to
``launch/train`` and ``launch/dryrun``, which are not ported yet: they
raise ``NotImplementedError`` naming ROADMAP M9.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP M9: launch/train "
        f"and launch/dryrun)")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- parameters -------------------------------------------------
    def defs(self):
        return tfm.model_defs(self.cfg)

    def init(self, gen: torch.Generator,
             device: Optional[torch.device] = None) -> Dict[str, Any]:
        """Parameters drawn from the CPU generator ``gen``, then moved to
        ``device`` (default: :func:`repro_torch.get_device`)."""
        if device is None:
            from repro_torch.kernels.ops import get_device
            device = get_device()
        return init_params(self.defs(), gen, device)

    # ---- compute ----------------------------------------------------
    def forward(self, params, tokens):
        """``(logits, aux)``."""
        return tfm.forward(self.cfg, params, tokens)

    def decode_step(self, params, cache, tokens, pos, ring=False):
        return tfm.decode_step(self.cfg, params, cache, tokens, pos,
                               ring=ring)

    def init_cache(self, batch, length, ring=False, device=None):
        if device is None:
            from repro_torch.kernels.ops import get_device
            device = get_device()
        return tfm.init_cache(self.cfg, batch, length, ring, device)

    def cache_specs(self, batch, length, ring=False):
        return tfm.cache_specs(self.cfg, batch, length, ring)

    # ---- input specs for the dry-run ---------------------------------
    def input_specs(self, shape):
        raise _unported("Model.input_specs")

    def make_inputs(self, shape, gen):
        raise _unported("Model.make_inputs")


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


class TrainState:
    def __init__(self, *args, **kwargs):
        raise _unported("TrainState")


def make_train_step(model: Model, optimizer, remat: bool = True):
    raise _unported("make_train_step")


def make_prefill_step(model: Model):
    """(params, batch) -> logits, the full-sequence forward without
    autograd."""
    def step(params, batch):
        with torch.no_grad():
            logits, _ = model.forward(params, batch["tokens"])
        return logits
    return step


def make_serve_step(model: Model, ring: bool = False):
    """(params, cache, tokens, pos) -> (logits, cache), one decode step
    without autograd (the cache is updated in place)."""
    def step(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos, ring=ring)
    return step

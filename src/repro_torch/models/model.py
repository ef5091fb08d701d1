"""Model facade: ties an ArchConfig to its parameter defs, forward, loss,
decode steps, input specs and the train step.

The layer the drivers program against: ``repro_torch.launch.train``
(``make_train_step`` over ``Model.loss``), ``repro_torch.core.federated``
(the cross-pod round) and ``repro_torch.launch.serve`` (``make_prefill_step``
and ``make_serve_step``, both under ``torch.no_grad()``, so an RWKV6 model's
prefill and decode take the WKV6 kernel: ``models/transformer``).

A train step is ``(state, batch) -> (state, metrics)`` as in the reference:
autograd takes the gradients of ``Model.loss`` with respect to every
parameter leaf, then the ported optimizer's ``update`` and
``apply_updates`` make a new :class:`TrainState` (the input state is not
modified).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.core.config import ArchConfig
from repro_torch.models import kvcache as kvc
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.utils.tree import tree_flatten, tree_unflatten


def _default_device(device):
    if device is None:
        from repro_torch.kernels.ops import get_device
        device = get_device()
    return device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- parameters -------------------------------------------------
    def defs(self):
        return tfm.model_defs(self.cfg)

    def init(self, gen: torch.Generator,
             device: Optional[torch.device] = None) -> Dict[str, Any]:
        """Parameters drawn from ``gen`` on its own device, then moved to
        ``device`` (default: :func:`repro_torch.get_device`)."""
        return init_params(self.defs(), gen, _default_device(device))

    # ---- compute ----------------------------------------------------
    def forward(self, params, tokens, frames=None, remat=False):
        """``(logits, aux)``."""
        return tfm.forward(self.cfg, params, tokens, frames=frames,
                           remat=remat)

    def loss(self, params, batch, remat=True):
        """``(loss, {"nll", "aux"})``."""
        return tfm.loss_fn(self.cfg, params, batch, remat=remat)

    def decode_step(self, params, cache, tokens, pos, ring=False):
        return tfm.decode_step(self.cfg, params, cache, tokens, pos,
                               ring=ring)

    def init_cache(self, batch, length, ring=False, device=None):
        return tfm.init_cache(self.cfg, batch, length, ring,
                              _default_device(device))

    def cache_specs(self, batch, length, ring=False):
        return tfm.cache_specs(self.cfg, batch, length, ring)

    # ---- input specs ------------------------------------------------
    def text_len(self, shape: InputShape) -> int:
        # VLM: patch stubs occupy part of the global sequence budget
        if self.cfg.family == "vlm" and shape.kind != "decode":
            return max(shape.seq_len - self.cfg.n_frames, 16)
        return shape.seq_len

    def input_specs(self, shape: InputShape) -> Dict[str, Any]:
        """Meta-tensor stand-ins (shape and dtype, no storage) for every
        model input, with the reference's shapes and dtypes."""
        cfg = self.cfg
        B = shape.global_batch
        dt = getattr(torch, cfg.dtype)
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": kvc.spec((B, self.text_len(shape)),
                                        torch.int32)}
            if cfg.family in ("vlm", "audio"):
                specs["frames"] = kvc.spec((B, cfg.n_frames, cfg.d_model),
                                           dt)
            return specs
        # decode: one new token + cache of seq_len capacity
        ring = shape.seq_len > 65_536  # long-context uses windowed cache
        return {
            "tokens": kvc.spec((B, 1), torch.int32),
            "pos": kvc.spec((), torch.int32),
            "cache": self.cache_specs(B, shape.seq_len, ring=ring),
        }

    def make_inputs(self, shape: InputShape, gen: torch.Generator,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
        """Concrete inputs matching :meth:`input_specs`: tokens and frames
        drawn from ``gen`` (on its own device), the cache zeros, all on
        ``device`` (default: :func:`repro_torch.get_device`)."""
        device = _default_device(device)
        specs = self.input_specs(shape)
        out: Dict[str, Any] = {}
        if "tokens" in specs:
            out["tokens"] = torch.randint(
                0, self.cfg.vocab, specs["tokens"].shape, generator=gen,
                device=gen.device, dtype=torch.int32).to(device)
        if "frames" in specs:
            out["frames"] = torch.randn(
                specs["frames"].shape, generator=gen,
                device=gen.device).to(device, specs["frames"].dtype)
        if "cache" in specs:
            out["cache"] = kvc.zeros_like_specs(specs["cache"], device)
            out["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                      device=device)
        return out


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: Any        # 0-d int32 tensor


def make_train_step(model: Model, optimizer: Optimizer, remat: bool = True):
    """(state, batch) -> (state, metrics), ``metrics`` = the loss's
    ``{"nll", "aux"}`` plus ``"loss"``, all detached 0-d tensors."""

    def step(state: TrainState, batch):
        leaves, treedef = tree_flatten(state.params)
        live = [t.detach().requires_grad_() for t in leaves]
        loss, metrics = model.loss(tree_unflatten(treedef, live), batch,
                                   remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = tree_unflatten(treedef, [
            torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)])
        del live
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            del grads
            params = apply_updates(state.params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


def make_prefill_step(model: Model):
    """(params, batch) -> logits, the full-sequence forward without
    autograd."""
    def step(params, batch):
        with torch.no_grad():
            logits, _ = model.forward(params, batch["tokens"],
                                      frames=batch.get("frames"))
        return logits
    return step


def make_serve_step(model: Model, ring: bool = False):
    """(params, cache, tokens, pos) -> (logits, cache), one decode step
    without autograd (the cache is updated in place)."""
    def step(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos, ring=ring)
    return step


def init_train_state(model: Model, optimizer: Optimizer, gen: torch.Generator,
                     device: Optional[torch.device] = None) -> TrainState:
    params = model.init(gen, device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_flatten(params)[0][0].device)
    return TrainState(params, optimizer.init(params), step)


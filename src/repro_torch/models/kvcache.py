"""KV caches and recurrent decode states.

Two attention-cache layouts:

* **linear** — pre-allocated (B, L, KV, D); token at position p writes slot p.
  Used for ``decode_32k`` (full context kept).
* **ring** — (B, W, KV, D) ring buffer; token at position p writes slot
  p mod W.  Used for ``long_500k`` sliding-window decode: O(W) memory at
  524k positions.  RoPE is applied at *write* time with absolute positions,
  so slot order never matters.

A cache spec is a meta tensor (shape and dtype, no storage);
:func:`zeros_like_specs` materializes a tree of them on a device.  Unlike
the reference's functional update, :func:`write_slot` writes the new entry
into the cache tensor in place — copying a whole cache per token would
cost O(L) memory traffic per step.

The position is a 0-d integer tensor on the cache's device, as it is a
traced ``int32`` in the reference's jitted serve step: the slot, the write
(``index_copy_``) and the mask are computed on the device from it, so one
captured decode step serves every position (``models/model.py``).  The
helpers still take a Python int (:func:`as_pos`).

MLA caches the compressed latent + shared RoPE key instead of per-head K/V
(DeepSeek-V2's memory saving: (r + rope_dim) vs 2·H·D per token).
"""
from __future__ import annotations

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.utils.tree import tree_map


def spec(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (the reference's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def attn_cache_defs(cfg: ArchConfig, batch: int, length: int, dtype):
    hd = cfg.resolved_head_dim
    return {
        "k": spec((batch, length, cfg.n_kv_heads, hd), dtype),
        "v": spec((batch, length, cfg.n_kv_heads, hd), dtype),
    }


def mla_cache_defs(cfg: ArchConfig, batch: int, length: int, dtype):
    m = cfg.mla
    return {
        "c": spec((batch, length, m.kv_lora_rank), dtype),
        "kr": spec((batch, length, m.qk_rope_head_dim), dtype),
    }


def zeros_like_specs(specs, device=None):
    """Materialize a tree of specs as zeros on ``device``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), specs)


def as_pos(pos, device=None) -> torch.Tensor:
    """``pos`` as a 0-d int64 tensor on ``device`` (default: a tensor's own
    device, the CPU for an int): a Python int through a device fill, which
    needs no host-to-device copy; a tensor cast and moved (no copy when it
    is one already)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=pos.device if device is None else device,
                      dtype=torch.int64)
    return torch.full((), int(pos), dtype=torch.int64, device=device)


def write_slot(cache_arr, new, slot):
    """Write new (B, 1, ...) into cache (B, L, ...) at ``slot`` (a 0-d
    tensor or an int), in place; returns the cache."""
    index = as_pos(slot, cache_arr.device).reshape(1)
    return cache_arr.index_copy_(1, index, new.to(cache_arr.dtype))


def cache_slot(pos, length: int, ring: bool):
    """The slot of position ``pos``: ``pos mod length`` in a ring
    (``torch.remainder`` for a tensor), else ``pos``."""
    return pos % length if ring else pos


def cache_mask(batch: int, pos, length: int, ring: bool, device=None):
    """(B, L) bool — valid cache slots after writing position ``pos``,
    built on ``pos``'s device (or ``device``).

    For a ring buffer every slot is valid once pos+1 >= W; earlier, only the
    first pos+1 slots.  For linear layout, slots <= pos.
    """
    pos = as_pos(pos, device)
    idx = torch.arange(length, device=pos.device)
    valid = (idx <= pos if not ring
             else idx < torch.clamp_max(pos + 1, length))
    return valid[None, :].expand(batch, length)

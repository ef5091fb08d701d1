"""The client mesh: the port's counterpart of the reference's 1-D
``jax.sharding.Mesh`` over the ``"clients"`` axis.

A :class:`ClientMesh` is a tuple of devices, one shard an entry; a device
may repeat (each entry is still one shard), which is how one card or the
one CPU device holds 2, 4 or 8 shards.  A *sharded* row matrix is a list
of per-shard row blocks, block ``s`` on ``devices[s]``, in row order — the
explicit form of a JAX array sharded along its first axis.  The sharded
kernel routes (``fedavg_agg.fedavg_aggregate_sharded``,
``stc_topk.stc_compress_batched_sharded``,
``quant.int8_roundtrip_batched_sharded``) take either such a list, and
return lists, or one whole tensor, which they split here and whose
results they gather back onto the first shard's device.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

#: the mesh axis that carries the client dimension (the reference's
#: ``batched.CLIENT_AXIS``)
CLIENT_AXIS = "clients"

Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


class ClientMesh(NamedTuple):
    """A 1-D mesh of shard devices (hashable: round programs are cached
    per mesh)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (CLIENT_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def current(device: torch.device):
    """A context that makes ``device`` the current CUDA device (a no-op for
    the CPU), so a shard's work, allocations on ``"cuda"`` without an index
    included, runs on its own card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def check_mesh(mesh, axis: str, name: str) -> None:
    """The reference's error for a mesh that is not 1-D over ``axis``."""
    if len(mesh.axis_names) != 1 or mesh.axis_names[0] != axis:
        raise ValueError(
            f"{name} needs a 1-D mesh with axis {axis!r}, got axes "
            f"{tuple(mesh.axis_names)}")


def split_rows(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Equal row blocks of ``x``, block ``s`` on ``mesh.devices[s]`` (a
    view where the device is ``x``'s own)."""
    r = x.shape[0] // mesh.size
    return [x[s * r:(s + 1) * r].to(d) for s, d in enumerate(mesh.devices)]


def as_shards(x: Rows, mesh, name: str) -> Tuple[List[torch.Tensor], bool]:
    """``x``'s per-shard blocks, and whether ``x`` came whole (its row
    count must then divide by the mesh size, the reference's error)."""
    if isinstance(x, torch.Tensor):
        if x.shape[0] % mesh.size:
            raise ValueError(
                f"client dim {x.shape[0]} must be divisible by the mesh "
                f"size {mesh.size}")
        return split_rows(x, mesh), True
    parts = list(x)
    if len(parts) != mesh.size:
        raise ValueError(f"{name}: {len(parts)} row blocks for a mesh of "
                         f"{mesh.size} shards")
    return parts, False


def gather_rows(parts: Sequence[torch.Tensor],
                device: Optional[torch.device] = None) -> torch.Tensor:
    """The row blocks as one tensor on ``device`` (default: the first
    block's)."""
    dev = parts[0].device if device is None else device
    if len(parts) == 1:
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts])

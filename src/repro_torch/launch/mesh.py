"""The reference's production meshes, as abstract meshes.

The dry run resolves its partition specs over these shapes; no device
list is built, so a 512-way mesh costs nothing on one card or on the CPU.
"""
from __future__ import annotations

from repro_torch.models.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) = 256 chips, axes (data, model).
    Multi-pod: (2, 16, 16) = 512 chips, axes (pod, data, model)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


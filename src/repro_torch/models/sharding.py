"""Meshes, logical-axis rules and partition specs, without devices.

The reference's ``repro.models.sharding`` wraps ``jax.make_mesh`` and the
ambient-mesh API so that models can name *logical* axes (``"embed"``,
``"heads"``, ``"expert"``, ...) and a rule table maps them to mesh axes.
The port runs on one card and has no SPMD partitioner, so a mesh here is
abstract: a tuple of axis names and sizes, nothing more.  Resolving a
logical spec needs only those sizes (no device list), which is what the
dry run (``repro_torch.launch.dryrun``) and the expert-parallel MoE route
(``repro_torch.models.moe.moe_ffn_expert_parallel``) read.

A :class:`PartitionSpec` is a tuple with one entry a dim: ``None``
(replicated), a mesh axis name, or a tuple of mesh axis names.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """``P("data", None, ("pod", "model"))``: one entry a dim; a one-axis
    tuple is stored as its axis, as ``jax.sharding.PartitionSpec`` does."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """An abstract device mesh: axis names and their sizes."""

    def __init__(self, axis_shapes: Sequence[int],
                 axis_names: Sequence[str]):
        if len(axis_shapes) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(axis_shapes)} and axis "
                             f"names {tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.devices_shape = tuple(int(s) for s in axis_shapes)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.devices_shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.devices_shape:
            n *= s
        return n

    def __repr__(self):
        return f"Mesh({self.shape})"


_state = threading.local()

# logical -> mesh axis (or tuple); None = replicate (the reference's table)
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "vocab": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "expert_cap": None,
    "frames": None,
    # sequence-parallel attention fallback: used for the query-sequence dim
    # when an arch's head counts cannot shard over "model" (MQA, odd heads)
    "qseq": ("model",),
}


def current_rules() -> Dict[str, Optional[Tuple[str, ...]]]:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextmanager
def use_rules(rules: Dict[str, Optional[Tuple[str, ...]]]):
    old = current_rules()
    _state.rules = dict(rules)
    try:
        yield
    finally:
        _state.rules = old


def make_mesh(axis_shapes, axis_names, *, devices=None) -> Mesh:
    """An abstract :class:`Mesh`.  ``devices`` is accepted for the
    reference's signature and not needed: resolving specs reads sizes
    only."""
    del devices
    return Mesh(axis_shapes, axis_names)


def current_mesh() -> Optional[Mesh]:
    """The ambient mesh of :func:`use_mesh`, or None."""
    return getattr(_state, "mesh", None)


@contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh of this thread for the block."""
    old = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = old


def resolve_spec(logical: Tuple[Optional[str], ...],
                 shape=None) -> Optional[PartitionSpec]:
    """Logical axis names -> a :class:`PartitionSpec` for the ambient mesh
    under the current rules (None without a mesh).  An axis is left
    replicated when its rule names no axis of the mesh, when an earlier
    dim took those axes, or when ``shape``'s dim does not divide by their
    product."""
    mesh = current_mesh()
    if mesh is None:
        return None
    sizes = mesh.shape
    rules = current_rules()
    parts = []
    used = set()
    for i, name in enumerate(logical):
        target = rules.get(name) if name is not None else None
        if target is None:
            parts.append(None)
            continue
        axes = tuple(a for a in target if a in sizes and a not in used)
        if not axes:
            parts.append(None)
            continue
        if shape is not None:
            total = 1
            for a in axes:
                total *= sizes[a]
            if shape[i] % total != 0:
                parts.append(None)
                continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return P(*parts)

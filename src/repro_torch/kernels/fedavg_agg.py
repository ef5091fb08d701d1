"""FedAvg aggregation: the streaming weighted sum of client updates.

``out[d] = sum_n w[n] * U[n, d]`` over the stacked (N, D) f32 update
matrix — the CUDA port of the reference's ``fedavg_agg._agg_kernel``
(``csrc/fedavg_agg.cu``: a grid over D chunks, each thread accumulating its
columns over all N rows in fp32 registers, in row order).

:func:`fedavg_aggregate` launches the kernel for a CUDA tensor and uses
:func:`fedavg_plain` — the same sum in plain PyTorch, accumulated in the
same row order, so the two agree bit for bit — for a CPU tensor.  Any other
device, dtype or layout raises; there is no fallback.

The hierarchical topology (``resources.aggregation_topology =
"hierarchical"``): :func:`fedavg_aggregate_tree` reduces the rows through
an edge -> region -> global tree.  Each tier is ONE grouped launch of the
same kernel (:func:`fedavg_aggregate_grouped`: ``gridDim.y`` = groups, each
block row summing its group's rows in order), later tiers sum the partials
at weight 1.  The tree's shape rules are the reference's
(``fedavg_aggregate_tree``), because they fix the order of summation:
``fanout = 0`` takes ``max(2, ceil(sqrt(N)))``, ``fanout >= N`` is the flat
call (bit-equal to it), and under ``use_kernel`` the rows pad to a
power-of-two multiple of ``TILE_N`` and a group is
``bucket_clients(fanout)`` rows.  :func:`fedavg_tree_plain` is the same
tree with :func:`fedavg_plain` per group, bit for bit the kernel's.

The sharded cohort (``resources.distributed = "data"``):
:func:`fedavg_aggregate_sharded` reduces each shard's row block on its
own device (K1, or the tree's grouped K1 under ``fanout > 0``) and sums
the k (D,) partials in shard order in f32 on the first shard's device —
the reference's per-shard partials and ``psum``.
:func:`fedavg_sharded_plain` is the same with the plain versions.

Asynchronous (FedBuff) aggregation takes both entry points unchanged: its
staleness discount is a transform of the weight vector
(:func:`fold_staleness`, plain f32 arithmetic in the reference's op order)
ahead of the same K1 launch.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.mesh import CLIENT_AXIS, Rows, check_mesh

#: the reference's client-chunk tile: the kernel tree's padding and group
#: granularity (``src/repro/kernels/fedavg_agg.py::TILE_N``)
TILE_N = 8

#: launches of the CUDA kernel in this process (see ``ops.launch_counts``):
#: flat sums, and grouped launches (one per tier of a tree)
launches = 0
grouped_launches = 0


def fedavg_plain(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(N, D), (N,) -> (D,) f32, summed over n = 0 .. N-1 in order."""
    u = updates.to(torch.float32)
    w = weights.to(torch.float32)
    acc = torch.zeros(u.shape[1], dtype=torch.float32, device=u.device)
    for n in range(u.shape[0]):
        acc = acc + w[n] * u[n]
    return acc


def fedavg_grouped_plain(updates: torch.Tensor, weights: torch.Tensor,
                         groups: int) -> torch.Tensor:
    """(G*F, D), (G*F,) -> (G, D): :func:`fedavg_plain` of each group of F
    consecutive rows."""
    f = updates.shape[0] // groups
    return torch.stack([fedavg_plain(updates[g * f:(g + 1) * f],
                                     weights[g * f:(g + 1) * f])
                        for g in range(groups)])


def _check(updates: torch.Tensor, weights: torch.Tensor) -> None:
    if updates.dim() != 2 or weights.shape != (updates.shape[0],):
        raise ValueError(
            f"fedavg_aggregate needs (N, D) updates and (N,) weights, got "
            f"{tuple(updates.shape)} and {tuple(weights.shape)}")
    for name, t in (("updates", updates), ("weights", weights)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fedavg_aggregate: {name} must be contiguous "
                             f"float32, got {t.dtype} "
                             f"(contiguous={t.is_contiguous()})")
        if t.device != updates.device:
            raise ValueError("fedavg_aggregate: updates and weights must "
                             "share one device")


def fold_staleness(weights: torch.Tensor, staleness: torch.Tensor,
                   power: float = 0.5) -> torch.Tensor:
    """Fold the FedBuff staleness discount into a weight vector: each
    weight scaled by ``(1 + s) ** -power`` (``s`` the model versions that
    elapsed since the update's dispatch; ``power = 0`` disables the
    discount), then renormalized to sum to 1.  (N,), (N,) -> (N,) f32."""
    w = weights.to(torch.float32)
    s = staleness.to(device=w.device, dtype=torch.float32)
    w = w * (1.0 + s) ** torch.tensor(-power, dtype=torch.float32,
                                      device=w.device)
    return w / torch.sum(w)


def fedavg_aggregate(updates: torch.Tensor, weights: torch.Tensor,
                     staleness: Optional[torch.Tensor] = None,
                     staleness_power: float = 0.5) -> torch.Tensor:
    """Weighted sum of the rows of ``updates`` with ``weights``, the
    weights first discounted by ``staleness`` (:func:`fold_staleness`)
    when it is given.

    A CPU tensor goes to :func:`fedavg_plain`; a CUDA tensor to the CUDA
    kernel (contiguous f32 required); any other device raises."""
    if staleness is not None:
        weights = fold_staleness(weights, staleness, staleness_power)
    if updates.device.type == "cpu":
        return fedavg_plain(updates, weights)
    if updates.device.type != "cuda":
        raise RuntimeError(f"fedavg_aggregate: no kernel for device "
                           f"{updates.device}")
    _check(updates, weights)
    global launches
    n, d = updates.shape
    out = torch.empty((d,), dtype=torch.float32, device=updates.device)
    lib = build.load("fedavg_agg")
    build.launch(updates.device, "fedavg_agg", lib.fedavg_agg_launch,
                 updates.data_ptr(), weights.data_ptr(), out.data_ptr(), n, d)
    launches += 1
    return out


def fedavg_aggregate_grouped(updates: torch.Tensor, weights: torch.Tensor,
                             groups: int) -> torch.Tensor:
    """Weighted sums of ``groups`` blocks of consecutive rows: (G*F, D),
    (G*F,) -> (G, D), one launch for all groups.  A CPU tensor goes to
    :func:`fedavg_grouped_plain`; a CUDA tensor to the kernel."""
    if updates.device.type == "cpu":
        return fedavg_grouped_plain(updates, weights, groups)
    if updates.device.type != "cuda":
        raise RuntimeError(f"fedavg_aggregate_grouped: no kernel for device "
                           f"{updates.device}")
    _check(updates, weights)
    n, d = updates.shape
    if groups < 1 or n % groups:
        raise ValueError(f"fedavg_aggregate_grouped: {n} rows do not split "
                         f"into {groups} equal groups")
    global grouped_launches
    out = torch.empty((groups, d), dtype=torch.float32, device=updates.device)
    lib = build.load("fedavg_agg")
    build.launch(updates.device, "fedavg_agg_grouped",
                 lib.fedavg_agg_grouped_launch, updates.data_ptr(),
                 weights.data_ptr(), out.data_ptr(), groups, n // groups, d)
    grouped_launches += 1
    return out


def bucket_clients(n: int, tile_n: int = TILE_N) -> int:
    """Smallest power-of-two multiple of ``tile_n`` that holds ``n`` rows."""
    b = tile_n
    while b < n:
        b *= 2
    return b


def pad_cohort(updates: torch.Tensor, weights: torch.Tensor,
               tile_n: int = TILE_N) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero rows and zero weights up to ``bucket_clients(N, tile_n)`` rows
    (no-op terms of the weighted sum)."""
    n = updates.shape[0]
    nb = bucket_clients(n, tile_n)
    if nb == n:
        return updates, weights
    return F.pad(updates, (0, 0, 0, nb - n)), F.pad(weights, (0, nb - n))


#: tree plans built in this process (:func:`_tree_plan`): one a (rows,
#: fanout, route), none on a later call at the same shapes
_tree_builds = 0


def tree_trace_count() -> int:
    """How many hierarchical-aggregation plans this process has built — the
    eager twin of the reference's tree trace count, held by the contracts
    layer (``repro_torch.analysis.contracts``) to one a (cohort, fanout)
    and none across rounds."""
    return _tree_builds


@functools.lru_cache(maxsize=32)
def _tree_plan(n: int, fanout: int, use_kernel: bool
               ) -> Optional[Tuple[Tuple[int, int], ...]]:
    """The tree's shape for ``n`` rows, the reference's rules: None for the
    flat call, else ``(groups, zero rows padded)`` a tier, from the rows
    padded by :func:`pad_cohort` up to the single root."""
    global _tree_builds
    _tree_builds += 1
    if fanout <= 0:
        fanout = max(2, int(math.ceil(math.sqrt(n))))
    if fanout >= n:                    # one group: the flat call
        return None
    rows = bucket_clients(n, TILE_N if use_kernel else 1)
    group = bucket_clients(fanout, TILE_N) if use_kernel else fanout
    tiers = []
    while rows > 1:
        g = -(-rows // group)
        tiers.append((g, g * group - rows))
        rows = g
    return tuple(tiers)


def _tree(updates: torch.Tensor, weights: torch.Tensor, fanout: int,
          use_kernel: bool,
          flat: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
          tier: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
          ) -> torch.Tensor:
    """The reference's tree shapes (:func:`_tree_plan`) with ``flat`` for
    one group and ``tier`` ((G*F, D), (G*F,), G -> (G, D)) for a tier."""
    u = updates.to(torch.float32)
    w = weights.to(torch.float32)
    plan = _tree_plan(u.shape[0], int(fanout), use_kernel)
    if plan is None:
        return flat(u.contiguous(), w.contiguous())
    u, w = pad_cohort(u, w, TILE_N if use_kernel else 1)
    for g, pad in plan:
        if pad:                        # zero rows + zero weights: no-op terms
            u, w = F.pad(u, (0, 0, 0, pad)), F.pad(w, (0, pad))
        u = tier(u.contiguous(), w.contiguous(), g)
        w = torch.ones((g,), dtype=torch.float32, device=u.device)
    return u[0]


def _einsum_tier(u: torch.Tensor, w: torch.Tensor, g: int) -> torch.Tensor:
    return torch.einsum("gf,gfd->gd", w.view(g, -1),
                        u.view(g, -1, u.shape[1]))


def fedavg_aggregate_tree(updates: torch.Tensor, weights: torch.Tensor,
                          fanout: int = 0, use_kernel: bool = True,
                          staleness: Optional[torch.Tensor] = None,
                          staleness_power: float = 0.5) -> torch.Tensor:
    """Hierarchical (edge -> region -> global) weighted sum of the rows of
    ``updates``: (N, D), (N,) -> (D,) f32.

    ``use_kernel``: each tier is one :func:`fedavg_aggregate_grouped` (the
    kernel on a CUDA tensor, its plain version on a CPU tensor), the flat
    short cut :func:`fedavg_aggregate`; otherwise each tier is
    ``torch.einsum("gf,gfd->gd")`` and the short cut ``"n,nd->d"``, as in
    the reference.  ``staleness`` folds into the weights as on the flat
    path."""
    if staleness is not None:
        weights = fold_staleness(weights, staleness, staleness_power)
    if use_kernel:
        return _tree(updates, weights, fanout, True, fedavg_aggregate,
                     fedavg_aggregate_grouped)
    return _tree(updates, weights, fanout, False,
                 lambda u, w: torch.einsum("n,nd->d", w, u), _einsum_tier)


def fedavg_tree_plain(updates: torch.Tensor, weights: torch.Tensor,
                      fanout: int = 0) -> torch.Tensor:
    """The kernel tree (``use_kernel`` shapes) in plain PyTorch:
    :func:`fedavg_plain` per group and tier, in the kernel's order."""
    return _tree(updates, weights, fanout, True, fedavg_plain,
                 fedavg_grouped_plain)


def _sharded(updates: Rows, weights: torch.Tensor, devices, fanout: int,
             flat, tree) -> torch.Tensor:
    """Each row block reduced on its shard's device as it comes (flat, or
    the tree under ``fanout > 0``), the partials summed in shard order on
    the first shard's device.  A whole matrix is first cut into k blocks
    of as equal sizes as ``tensor_split`` makes; an empty block adds
    nothing."""
    if isinstance(updates, torch.Tensor):
        updates = updates.tensor_split(len(devices))
    elif len(updates) != len(devices):
        raise ValueError(f"fedavg_aggregate_sharded: {len(updates)} row "
                         f"blocks for a mesh of {len(devices)} shards")
    out, lo = None, 0
    for u, dev in zip(updates, devices):
        r = u.shape[0]
        w = weights[lo:lo + r].to(dev, torch.float32).contiguous()
        lo += r
        if not r:
            continue
        u = u.to(dev, torch.float32).contiguous()
        part = tree(u, w, fanout) if fanout > 0 else flat(u, w)
        out = part if out is None else out + part.to(out.device)
    return out


def fedavg_aggregate_sharded(updates: Rows, weights: torch.Tensor, mesh,
                             axis: str = CLIENT_AXIS,
                             staleness: Optional[torch.Tensor] = None,
                             staleness_power: float = 0.5,
                             fanout: int = 0) -> torch.Tensor:
    """Weighted sum over a client mesh: per-shard partials, then their sum
    (the reference's ``psum``) on the first shard's device -> (D,) f32.

    ``updates`` is the whole (N, D) matrix or its row blocks in order (one
    a shard, each on its shard's device: ``kernels.mesh``); ``weights``
    (N,).  As in the reference, ``staleness`` folds into the weights first
    (:func:`fold_staleness`); ``fanout > 0`` reduces each shard's rows
    through the tree of grouped K1 launches (one K1 launch where
    ``fanout`` covers the shard's rows), ``fanout = 0`` through one K1
    launch a shard.  Unlike the reference, the rows are not padded to
    ``TILE_N x k`` and re-cut: each shard reduces the rows it holds, so no
    row crosses devices and only the (D,) partials do (the sum order
    differs from the reference's by rounding only).  CPU shards take the
    plain versions."""
    check_mesh(mesh, axis, "fedavg_aggregate_sharded")
    if staleness is not None:
        weights = fold_staleness(weights, staleness, staleness_power)

    def tree(u, w, f):
        return _tree(u, w, f, True, fedavg_aggregate,
                     fedavg_aggregate_grouped)
    return _sharded(updates, weights, mesh.devices, int(fanout),
                    fedavg_aggregate, tree)


def fedavg_sharded_plain(updates: Rows, weights: torch.Tensor, k: int,
                         fanout: int = 0) -> torch.Tensor:
    """:func:`fedavg_aggregate_sharded` over k shards in plain PyTorch on
    ``updates``' device: :func:`fedavg_plain` / :func:`fedavg_tree_plain`
    a shard, the partials summed in shard order."""
    dev = (updates if isinstance(updates, torch.Tensor)
           else updates[0]).device
    return _sharded(updates, weights, [dev] * k, int(fanout), fedavg_plain,
                    fedavg_tree_plain)

"""FedAvg aggregation: the streaming weighted sum of client updates.

``out[d] = sum_n w[n] * U[n, d]`` over the stacked (N, D) f32 update
matrix — the CUDA port of the reference's ``fedavg_agg._agg_kernel``
(``csrc/fedavg_agg.cu``: a grid over D chunks, each thread accumulating its
columns over all N rows in fp32 registers, in row order).

:func:`fedavg_aggregate` launches the kernel for a CUDA tensor and uses
:func:`fedavg_plain` — the same sum in plain PyTorch, accumulated in the
same row order, so the two agree bit for bit — for a CPU tensor.  Any other
device, dtype or layout raises; there is no fallback.

One kernel serves every route: it sums *segments* (row blocks, each with
its own pointer, rows and weights) either group by group (a tree's tier,
:func:`fedavg_aggregate_grouped`) or all into one row, the segments' sums
added in order in registers (the flat sum, a tree's last tier, the
shards of one card).

The hierarchical topology (``resources.aggregation_topology =
"hierarchical"``): :func:`fedavg_aggregate_tree` reduces the rows through
an edge -> region -> global tree.  Each tier is ONE grouped launch, later
tiers sum the partials at weight 1.  The tree's shape rules are the
reference's (``fedavg_aggregate_tree``), because they fix the order of
summation: ``fanout = 0`` takes ``max(2, ceil(sqrt(N)))``, ``fanout >=
N`` is the flat call (bit-equal to it), and under ``use_kernel`` the rows
pad to a power-of-two multiple of ``TILE_N`` and a group is
``bucket_clients(fanout)`` rows.  The kernel route pads nothing: the
reference's zero rows of weight 0 add ``+0.0`` products to sums that
start at ``+0.0``, so a group simply ends at the last real row (and a
tier holds only the groups that have one) — bitwise the padded sums.
:func:`fedavg_tree_plain` is the same tree with :func:`fedavg_plain` a
group, bit for bit the kernel's.

The sharded cohort (``resources.distributed = "data"``):
:func:`fedavg_aggregate_sharded` reduces each shard's row block (flat,
or its tree under ``fanout > 0``) and adds the partials in shard order in
f32 — the reference's per-shard partials and ``psum``.  Consecutive
shards on one device (:func:`shard_runs`) take one launch together (a
tree's earlier tiers one launch a tier), which adds their partials in
registers; a run on a later device adds its partials onto the running sum
there (one shard: its partial moves to the first device and is added
there, as one launch a card and the cross-card adds always did), so the
result is bitwise one launch a shard and the k - 1 adds.
:func:`fedavg_sharded_plain` is the same with the plain versions.

Asynchronous (FedBuff) aggregation takes both entry points unchanged: its
staleness discount is a transform of the weight vector
(:func:`fold_staleness`, plain f32 arithmetic in the reference's op order)
ahead of the same K1 launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.mesh import CLIENT_AXIS, Rows, check_mesh

#: the reference's client-chunk tile: the kernel tree's padding and group
#: granularity (``src/repro/kernels/fedavg_agg.py::TILE_N``)
TILE_N = 8

#: segments a launch (``csrc/fedavg_agg.cu``'s ``MAX_SEGS``); more go in
#: several launches
MAX_SEGS = 64

#: launches of the CUDA kernel in this process (see ``ops.launch_counts``):
#: flat sums, and grouped launches (one per tier of a tree)
launches = 0
grouped_launches = 0

#: a segment: (rows (R, D) f32, weights (R,) f32 or None for weight 1)
Seg = Tuple[torch.Tensor, Optional[torch.Tensor]]


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


def _seg_plain(u: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    if w is None:
        w = torch.ones((u.shape[0],), dtype=torch.float32, device=u.device)
    return fedavg_plain(u, w)


def _tier_plain(segs: Sequence[Seg], group: int) -> List[torch.Tensor]:
    """Each segment's groups of ``group`` rows (the last group ending at
    its last row) -> a (ceil(R / group), D) tensor a segment."""
    return [torch.stack([_seg_plain(u[i:i + group],
                                    None if w is None else w[i:i + group])
                         for i in range(0, u.shape[0], group)])
            for u, w in segs]


def _combine_plain(segs: Sequence[Seg], init: Optional[torch.Tensor],
                   tree: bool = False) -> torch.Tensor:
    """Each segment's rows summed from +0.0, the sums added in segment
    order onto ``init`` (or onto the first sum) -> (D,)."""
    out = init
    for u, w in segs:
        part = _seg_plain(u, w)
        out = part if out is None else out + part
    return out


def _check(updates: torch.Tensor, weights: Optional[torch.Tensor]) -> None:
    """(N, D) contiguous f32 updates and (N,) contiguous f32 weights (or
    None) on one device."""
    if updates.dim() != 2 or (weights is not None and
                              weights.shape != (updates.shape[0],)):
        raise ValueError(
            f"fedavg_aggregate needs (N, D) updates and (N,) weights, got "
            f"{tuple(updates.shape)} and "
            f"{None if weights is None else tuple(weights.shape)}")
    for name, t in (("updates", updates), ("weights", weights)):
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fedavg_aggregate: {name} must be contiguous "
                             f"float32, got {t.dtype} "
                             f"(contiguous={t.is_contiguous()})")
        if t.device != updates.device:
            raise ValueError("fedavg_aggregate: updates and weights must "
                             "share one device")


def _device(segs: Sequence[Seg], what: str) -> torch.device:
    """The segments' device (the entry points have checked them: (R, D)
    contiguous f32 rows, (R,) contiguous f32 weights or None, R >= 1, one
    device and width a call); a device with no kernel raises."""
    dev = segs[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for device {dev}")
    return dev


def _launch(what: str, segs: Sequence[Seg], init: Optional[torch.Tensor],
            out: torch.Tensor, group: int, combine: bool) -> None:
    """One launch of ``csrc/fedavg_agg.cu`` over at most MAX_SEGS
    segments."""
    table = (ctypes.c_int64 * (3 * len(segs)))(*[
        v for u, w in segs
        for v in (u.data_ptr(), 0 if w is None else w.data_ptr(),
                  u.shape[0])])
    build.launch(out.device, what,
                 build.load("fedavg_agg").fedavg_agg_segments_launch, table,
                 len(segs), None if init is None else init.data_ptr(),
                 out.data_ptr(), group, out.shape[-1], int(combine))


def _tier(segs: Sequence[Seg], group: int) -> List[torch.Tensor]:
    """:func:`_tier_plain` on the kernel for CUDA segments: one grouped
    launch (a segment's groups are consecutive block rows)."""
    global grouped_launches
    dev = _device(segs, "fedavg_aggregate_grouped")
    if dev.type == "cpu":
        return _tier_plain(segs, group)
    sizes = [-(-u.shape[0] // group) for u, _ in segs]
    out = torch.empty((sum(sizes), segs[0][0].shape[1]),
                      dtype=torch.float32, device=dev)
    row = 0
    for i in range(0, len(segs), MAX_SEGS):
        rows = sum(sizes[i:i + MAX_SEGS])
        _launch("fedavg_agg_tree", segs[i:i + MAX_SEGS], None,
                out[row:row + rows], group, False)
        row += rows
        grouped_launches += 1
    return list(out.split(sizes))


def _combine(segs: Sequence[Seg], init: Optional[torch.Tensor],
             tree: bool = False) -> torch.Tensor:
    """:func:`_combine_plain` on the kernel for CUDA segments: one launch
    (counted as a tree's tier under ``tree``)."""
    global launches, grouped_launches
    dev = _device(segs, "fedavg_aggregate")
    if dev.type == "cpu":
        return _combine_plain(segs, init)
    out = init
    for i in range(0, len(segs), MAX_SEGS):
        nxt = torch.empty((segs[0][0].shape[1],), dtype=torch.float32,
                          device=dev)
        _launch("fedavg_agg_tree" if tree else "fedavg_agg",
                segs[i:i + MAX_SEGS], out, nxt, 1, True)
        out = nxt
        if tree:
            grouped_launches += 1
        else:
            launches += 1
    return out


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
    return _combine([(updates, weights)], None)


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
    n = updates.shape[0]
    if groups < 1 or n % groups:
        raise ValueError(f"fedavg_aggregate_grouped: {n} rows do not split "
                         f"into {groups} equal groups")
    return _tier([(updates, weights)], n // groups)[0]


def bucket_clients(n: int, tile_n: int = TILE_N) -> int:
    """Smallest power-of-two multiple of ``tile_n`` that holds ``n`` rows."""
    b = tile_n
    while b < n:
        b *= 2
    return b


def pad_cohort(updates: torch.Tensor, weights: torch.Tensor,
               tile_n: int = TILE_N) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero rows and zero weights up to ``bucket_clients(N, tile_n)`` rows
    (no-op terms of the weighted sum; the einsum tree's padding)."""
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
               ) -> Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]:
    """The tree's shape for ``n`` rows, the reference's rules: None for the
    flat call, else (rows a group, ``(groups, zero rows padded)`` a tier,
    from the rows padded by :func:`pad_cohort` up to the single root)."""
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
    return group, tuple(tiers)


def _reduce(segs: Sequence[Seg], tiers: Sequence[int], group: int,
            init: Optional[torch.Tensor], plain: bool) -> torch.Tensor:
    """Segment i through its ``tiers[i]`` tiers of ``group`` rows (0: its
    rows as they are), the tiers before the last one grouped launch a
    level over every segment that has it, then one combining launch: each
    segment's last rows summed, the sums added in order onto ``init``."""
    tier, combine = (_tier_plain, _combine_plain) if plain else (_tier,
                                                                 _combine)
    segs = list(segs)
    for level in range(max(tiers) - 1):
        idx = [i for i, t in enumerate(tiers) if t - 1 > level]
        for i, out in zip(idx, tier([segs[i] for i in idx], group)):
            segs[i] = (out, None)
    return combine(segs, init, max(tiers) > 0)


def _tree(updates: torch.Tensor, weights: torch.Tensor, fanout: int,
          plain: bool) -> torch.Tensor:
    """The kernel tree (the reference's ``use_kernel`` shapes) with no
    padded rows; ``plain``: the plain versions on any device."""
    u = updates.to(torch.float32).contiguous()
    w = weights.to(torch.float32).contiguous()
    _check(u, w)
    plan = _tree_plan(u.shape[0], int(fanout), True)
    if plan is None:
        return (fedavg_plain if plain else fedavg_aggregate)(u, w)
    group, tiers = plan
    return _reduce([(u, w)], [len(tiers)], group, None, plain)


def _einsum_tier(u: torch.Tensor, w: torch.Tensor, g: int) -> torch.Tensor:
    return torch.einsum("gf,gfd->gd", w.view(g, -1),
                        u.view(g, -1, u.shape[1]))


def _einsum_tree(updates: torch.Tensor, weights: torch.Tensor,
                 fanout: int) -> torch.Tensor:
    """The reference's ``use_kernel=False`` tree: rows padded to a power
    of two, each tier padded to whole groups and summed by
    ``einsum("gf,gfd->gd")``."""
    u = updates.to(torch.float32)
    w = weights.to(torch.float32)
    plan = _tree_plan(u.shape[0], int(fanout), False)
    if plan is None:
        return torch.einsum("n,nd->d", w, u)
    u, w = pad_cohort(u, w, 1)
    for g, pad in plan[1]:
        if pad:                        # zero rows + zero weights: no-op terms
            u, w = F.pad(u, (0, 0, 0, pad)), F.pad(w, (0, pad))
        u = _einsum_tier(u.contiguous(), w.contiguous(), g)
        w = torch.ones((g,), dtype=torch.float32, device=u.device)
    return u[0]


def fedavg_aggregate_tree(updates: torch.Tensor, weights: torch.Tensor,
                          fanout: int = 0, use_kernel: bool = True,
                          staleness: Optional[torch.Tensor] = None,
                          staleness_power: float = 0.5) -> torch.Tensor:
    """Hierarchical (edge -> region -> global) weighted sum of the rows of
    ``updates``: (N, D), (N,) -> (D,) f32.

    ``use_kernel``: each tier is one grouped launch of the kernel (its
    plain version on a CPU tensor), the flat short cut
    :func:`fedavg_aggregate`; otherwise each tier is
    ``torch.einsum("gf,gfd->gd")`` and the short cut ``"n,nd->d"``, as in
    the reference.  ``staleness`` folds into the weights as on the flat
    path."""
    if staleness is not None:
        weights = fold_staleness(weights, staleness, staleness_power)
    if use_kernel:
        return _tree(updates, weights, fanout, False)
    return _einsum_tree(updates, weights, fanout)


def fedavg_tree_plain(updates: torch.Tensor, weights: torch.Tensor,
                      fanout: int = 0) -> torch.Tensor:
    """The kernel tree (``use_kernel`` shapes) in plain PyTorch:
    :func:`fedavg_plain` per group and tier, in the kernel's order."""
    return _tree(updates, weights, fanout, True)


def shard_runs(devices: Sequence[torch.device]
               ) -> List[Tuple[torch.device, List[int]]]:
    """The shards of a mesh as runs of consecutive shards on one device,
    in shard order: (device, shard indices) a run.  The sharded route
    makes one launch a run (a tree's earlier tiers one a tier), so k
    shards of one card make one and k distinct cards k."""
    runs: List[Tuple[torch.device, List[int]]] = []
    for i, dev in enumerate(devices):
        if runs and runs[-1][0] == dev:
            runs[-1][1].append(i)
        else:
            runs.append((dev, [i]))
    return runs


def _sharded(updates: Rows, weights: torch.Tensor, devices, fanout: int,
             plain: bool) -> torch.Tensor:
    """Each row block reduced as it comes (flat, or its tree under
    ``fanout > 0``) and the partials added in shard order: one launch a
    run of :func:`shard_runs`, the first run's sum on the first shard's
    device.  A later run of one shard adds its partial there; a later run
    of more carries the sum to its device and adds its shards' partials
    onto it in the launch.  A whole matrix is first cut into k blocks of
    as equal sizes as ``tensor_split`` makes; an empty block adds
    nothing."""
    if isinstance(updates, torch.Tensor):
        updates = updates.tensor_split(len(devices))
    elif len(updates) != len(devices):
        raise ValueError(f"fedavg_aggregate_sharded: {len(updates)} row "
                         f"blocks for a mesh of {len(devices)} shards")
    shards, lo = [], 0
    for u, dev in zip(updates, devices):
        r = u.shape[0]
        if u.dim() != 2 or u.shape[1] != updates[0].shape[1] or \
                lo + r > weights.shape[0]:
            raise ValueError(
                f"fedavg_aggregate_sharded: row blocks of one width and a "
                f"weight a row, got {[tuple(b.shape) for b in updates]} "
                f"and {tuple(weights.shape)}")
        shards.append((u.to(dev, torch.float32).contiguous(),
                       weights[lo:lo + r].to(dev, torch.float32).contiguous())
                      if r else None)
        lo += r
    out = None
    for dev, idx in shard_runs(devices):
        segs = [shards[i] for i in idx if shards[i] is not None]
        if not segs:
            continue
        plans = [_tree_plan(u.shape[0], fanout, True) if fanout > 0
                 else None for u, _ in segs]
        tiers = [0 if p is None else len(p[1]) for p in plans]
        group = next((p[0] for p in plans if p is not None), 1)
        if out is None or len(segs) == 1:
            part = _reduce(segs, tiers, group, None, plain)
            out = part if out is None else out + part.to(out.device)
        else:
            out = _reduce(segs, tiers, group, out.to(dev), plain).to(
                out.device)
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
    through the tree (flat where ``fanout`` covers the shard's rows),
    ``fanout = 0`` flat.  Consecutive shards on one device take one
    launch together (:func:`shard_runs`).  Unlike the reference, the rows
    are not padded to ``TILE_N x k`` and re-cut: each shard reduces the
    rows it holds, so no row crosses devices and only the (D,) partials
    do (the sum order differs from the reference's by rounding only).
    CPU shards take the plain versions."""
    check_mesh(mesh, axis, "fedavg_aggregate_sharded")
    if staleness is not None:
        weights = fold_staleness(weights, staleness, staleness_power)
    return _sharded(updates, weights, mesh.devices, int(fanout), False)


def fedavg_sharded_plain(updates: Rows, weights: torch.Tensor, k: int,
                         fanout: int = 0) -> torch.Tensor:
    """:func:`fedavg_aggregate_sharded` over k shards of ``updates``'
    device in plain PyTorch: each shard's :func:`fedavg_plain` (or its
    tree of them), the partials added in shard order."""
    dev = (updates if isinstance(updates, torch.Tensor)
           else updates[0]).device
    return _sharded(updates, weights, [dev] * k, int(fanout), True)

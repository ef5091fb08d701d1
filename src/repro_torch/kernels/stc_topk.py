"""Sparse ternary compression (STC): batched over a stacked cohort update
(K2), and dense over one tensor (K4).

For each client row of an (N, D) f32 matrix and each 8192-element segment
of the row: a 16-step threshold bisection keeps
``max(round(keep_frac * real), 1)`` elements (``real`` = the segment's
unpadded length), and the kept elements become ``sign(x) * mu`` with ``mu``
their mean |x|; the rest become 0.  Returns the sparsified matrix and the
per-row count of kept elements.  This is the CUDA port of the reference's
``stc_topk._stc_batched_kernel`` (``csrc/stc_topk.cu``: one CTA per
(row, segment), the segment held in registers; once at most ``CAND_CAP``
elements can still lie between the bisection's bounds, one warp takes the
remaining steps on those alone — the same thresholds in fewer passes and
barriers; :func:`stc_kernel_order_segment` models that order for the
tests).

:func:`stc_compress_batched` launches the kernel for a CUDA tensor and uses
:func:`stc_plain` for a CPU tensor.  :func:`stc_compress_batched_sharded`
is its route over a client mesh (``resources.distributed = "data"``):
each shard's rows through the same call on that shard's device, no
collective — rows are independent, so the result is the unsharded one bit
for bit.

:func:`stc_compress` is the port of the reference's dense
``stc_topk._stc_kernel`` (its ``stc_compress``): the same per-8192-tile
STC on one flattened tensor, whose tiles are exactly the segments of a
single row.  It therefore launches the same CUDA kernel on the flattened
tensor viewed as one (1, n) row — per-tile real counts
``clip(n - i * 8192, 0, 8192)`` — and returns the result in the input's
shape; its own launch counter is ``dense_launches``.  Thresholds, masks and counts are the
same f32/integer operations in both, so they agree bit for bit; ``mu`` is
summed and divided in float64 in both, then rounded once to float32 — the
correctly rounded mean of the kept magnitudes.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.mesh import (
    CLIENT_AXIS, Rows, as_shards, check_mesh, gather_rows,
)

SEG = 8192            # elements per threshold segment (reference TILE_SEG)
BISECT_ITERS = 16
CAND_CAP = 128        # candidates the kernel's last steps take (csrc CAP)

#: launches of the CUDA kernel in this process (see ``ops.launch_counts``),
#: batched and dense
launches = 0
dense_launches = 0


def segment_targets(keep_frac: float, d: int,
                    device=None) -> torch.Tensor:
    """Per-segment kept-count targets from each segment's real length."""
    t = -(-d // SEG)
    real = (d - torch.arange(t, device=device) * SEG).clamp(0, SEG)
    return torch.clamp_min(
        torch.round(torch.tensor(keep_frac, dtype=torch.float32,
                                 device=device) * real.to(torch.float32)),
        1.0)


def _bisect(ax: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """16 single bisection steps on (N, T, SEG) magnitudes against (T, 1)
    targets -> (N, T, 1) thresholds."""
    n, t, _ = ax.shape
    lo = torch.zeros((n, t, 1), dtype=torch.float32, device=ax.device)
    hi = ax.amax(dim=-1, keepdim=True) + 1e-12
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        count = (ax > mid).sum(dim=-1, keepdim=True).to(torch.float32)
        more = count > target
        lo = torch.where(more, mid, lo)
        hi = torch.where(more, hi, mid)
    return 0.5 * (lo + hi)


def stc_thresholds(x: torch.Tensor, keep_frac: float = 0.01
                   ) -> torch.Tensor:
    """(N, D) -> (N, T) thresholds of :func:`stc_plain`, one a segment."""
    n, d = x.shape
    t = -(-d // SEG)
    ax = F.pad(x.to(torch.float32), (0, t * SEG - d)).view(n, t, SEG).abs()
    return _bisect(ax, segment_targets(keep_frac, d, x.device)[:, None])[..., 0]


def stc_kernel_order_segment(seg: torch.Tensor, keep_frac: float,
                             cap: int = CAND_CAP
                             ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """The CUDA kernel's order of the bisection on one segment's real
    elements (1-D f32, at most ``SEG``; no padding, as the kernel's loops
    stop at the real length).  With count(t) = #{|x| > t}, the kernel keeps
    count(lo) and count(hi) (count(0) is the non-zero elements), steps over
    the whole segment while more than ``cap`` elements lie in (lo, hi],
    then gathers those candidates and takes the
    remaining steps on them alone, as count(mid) = count(hi) +
    #{candidates > mid} for every mid in [lo, hi].  Returns (threshold,
    mask, kept count, steps taken over the whole segment); the tests hold
    the first three bit for bit against :func:`stc_plain`'s 16 steps."""
    a = seg.to(torch.float32).abs()
    target = segment_targets(keep_frac, a.numel())[0]
    lo = torch.zeros((), dtype=torch.float32)
    hi = a.max() + 1e-12
    cnt_lo, cnt_hi, step = int((a > 0).sum()), 0, 0
    while step < BISECT_ITERS and cnt_lo - cnt_hi > cap:
        mid = 0.5 * (lo + hi)
        c = int((a > mid).sum())
        if c > target:
            lo, cnt_lo = mid, c
        else:
            hi, cnt_hi = mid, c
        step += 1
    full_steps = step
    cand = a[(a > lo) & (a <= hi)]
    assert step == BISECT_ITERS or cand.numel() == cnt_lo - cnt_hi <= cap
    for _ in range(step, BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        if cnt_hi + int((cand > mid).sum()) > target:
            lo = mid
        else:
            hi = mid
    thr = 0.5 * (lo + hi)
    mask = a > thr
    return thr, mask, int(mask.sum()), full_steps


def adversarial_rows(d: int, seed: int = 0) -> torch.Tensor:
    """Seven (7, d) f32 rows on the CPU that stress the bisection: ties at
    the threshold (a mid lands exactly on 1.0, the magnitude of 2,000 of
    every 8192), one non-zero element, denormals only, one magnitude
    everywhere, all zeros (signed), a 1e30 outlier over unit noise, and
    small integer magnitudes (ties everywhere).  With ``d = 8193`` every
    row ends in a segment of one real element; flattened, ``d = 8192``
    gives one case a segment."""
    rs = np.random.RandomState(seed)
    sign = np.where(rs.rand(7, d) < 0.5, -1.0, 1.0).astype(np.float32)
    mag = np.zeros((7, d), np.float32)
    mag[0] = 0.5
    for s0 in range(0, d, SEG):
        idx = s0 + rs.permutation(min(SEG, d - s0))
        mag[0, idx[:2000]] = 1.0
        mag[0, idx[2000:2050]] = 2.0
    mag[1, rs.randint(d)] = 3.0
    mag[2] = np.abs(rs.standard_normal(d)) * np.float32(1e-39)
    mag[3] = 0.37
    mag[5] = np.abs(rs.standard_normal(d))
    mag[5, rs.randint(d)] = 1e30
    mag[6] = rs.randint(1, 4, d)
    return torch.from_numpy((sign * mag).astype(np.float32))


def stc_plain(x: torch.Tensor, keep_frac: float = 0.01
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) -> (sparsified (N, D) f32, nnz (N,) f32), in plain PyTorch."""
    n, d = x.shape
    t = -(-d // SEG)
    xp = F.pad(x.to(torch.float32), (0, t * SEG - d)).view(n, t, SEG)
    ax = xp.abs()
    thr = _bisect(ax, segment_targets(keep_frac, d, x.device)[:, None])
    mask = ax > thr
    cnt = mask.sum(dim=-1, keepdim=True)
    total = torch.where(mask, ax, 0.0).sum(dim=-1, keepdim=True,
                                           dtype=torch.float64)
    mu = (total / torch.clamp_min(cnt.to(torch.float64), 1.0)).to(torch.float32)
    out = torch.where(mask, torch.sign(xp) * mu, 0.0)
    out = out.view(n, t * SEG)[:, :d].contiguous()
    return out, cnt.sum(dim=(1, 2)).to(torch.float32)


def _launch(x: torch.Tensor, keep_frac: float, counts: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on an (N, D) CUDA tensor -> (out, int32 nnz, or
    None without ``counts``: the kernel then skips them)."""
    n, d = x.shape
    out = torch.empty_like(x)
    nnz = (torch.empty((n,), dtype=torch.int32, device=x.device) if counts
           else None)
    lib = build.load("stc_topk")
    build.launch(x.device, "stc_batched", lib.stc_batched_launch,
                 x.data_ptr(), out.data_ptr(),
                 None if nnz is None else nnz.data_ptr(), n, d,
                 float(keep_frac))
    return out, nnz


def stc_compress_batched(x: torch.Tensor, keep_frac: float = 0.01
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparsify a stacked (N, D) cohort update; returns ``(out, nnz)``.

    A CPU tensor goes to :func:`stc_plain`; a CUDA tensor to the CUDA
    kernel (contiguous f32, N <= 65535); any other device raises."""
    if x.device.type == "cpu":
        return stc_plain(x, keep_frac)
    if x.device.type != "cuda":
        raise RuntimeError(f"stc_compress_batched: no kernel for device "
                           f"{x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"stc_compress_batched needs a contiguous (N, D) float32 "
            f"tensor, got {tuple(x.shape)} {x.dtype} "
            f"(contiguous={x.is_contiguous()})")
    global launches
    out, nnz = _launch(x, keep_frac)
    launches += 1
    return out, nnz.to(torch.float32)


def stc_compress_batched_sharded(
        x: Rows, keep_frac: float, mesh, axis: str = CLIENT_AXIS
) -> Tuple[Union[torch.Tensor, List[torch.Tensor]],
           Union[torch.Tensor, List[torch.Tensor]]]:
    """:func:`stc_compress_batched` of each shard's rows on its device.
    ``x`` whole ((N, D), N divisible by the mesh size) -> ``(out, nnz)``
    gathered on the first shard's device; ``x`` as row blocks (one a
    shard, ``kernels.mesh``) -> lists of per-shard ``out`` and ``nnz``."""
    check_mesh(mesh, axis, "stc_compress_batched_sharded")
    parts, whole = as_shards(x, mesh, "stc_compress_batched_sharded")
    outs = [stc_compress_batched(p, keep_frac) for p in parts]
    out, nnz = [o for o, _ in outs], [c for _, c in outs]
    if whole:
        return gather_rows(out), gather_rows(nnz)
    return out, nnz


def stc_dense_plain(x: torch.Tensor, keep_frac: float = 0.01
                    ) -> torch.Tensor:
    return stc_plain(x.reshape(1, -1), keep_frac)[0].view(x.shape)


def stc_compress(x: torch.Tensor, keep_frac: float = 0.01) -> torch.Tensor:
    """Dense STC of one float32 tensor of any shape; returns the
    sparsified/ternarized tensor in the same shape.

    A CPU tensor goes to :func:`stc_dense_plain`; a CUDA tensor to the CUDA
    kernel; any other device raises."""
    if x.device.type == "cpu":
        return stc_dense_plain(x, keep_frac)
    if x.device.type != "cuda":
        raise RuntimeError(f"stc_compress: no kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or not x.numel():
        raise ValueError(
            f"stc_compress needs a non-empty contiguous float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} (contiguous={x.is_contiguous()})")
    global dense_launches
    out, _ = _launch(x.view(1, -1), keep_frac, counts=False)
    dense_launches += 1
    return out.view(x.shape)

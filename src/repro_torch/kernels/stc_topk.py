"""Sparse ternary compression (STC): batched over a stacked cohort update
(K2), and dense over one tensor (K4).

For each client row of an (N, D) f32 matrix and each 8192-element segment
of the row: a 16-step threshold bisection keeps
``max(round(keep_frac * real), 1)`` elements (``real`` = the segment's
unpadded length), and the kept elements become ``sign(x) * mu`` with ``mu``
their mean |x|; the rest become 0.  Returns the sparsified matrix and the
per-row count of kept elements.  This is the CUDA port of the reference's
``stc_topk._stc_batched_kernel`` (``csrc/stc_topk.cu``: one CTA per
(row, segment), the segment staged in shared memory).

:func:`stc_compress_batched` launches the kernel for a CUDA tensor and uses
:func:`stc_plain` for a CPU tensor.

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

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

SEG = 8192            # elements per threshold segment (reference TILE_SEG)
BISECT_ITERS = 16

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


def stc_plain(x: torch.Tensor, keep_frac: float = 0.01
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) -> (sparsified (N, D) f32, nnz (N,) f32), in plain PyTorch."""
    n, d = x.shape
    t = -(-d // SEG)
    xp = F.pad(x.to(torch.float32), (0, t * SEG - d)).view(n, t, SEG)
    ax = xp.abs()
    target = segment_targets(keep_frac, d, x.device)[:, None]   # (T, 1)
    lo = torch.zeros((n, t, 1), dtype=torch.float32, device=x.device)
    hi = ax.amax(dim=-1, keepdim=True) + 1e-12
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        count = (ax > mid).sum(dim=-1, keepdim=True).to(torch.float32)
        more = count > target
        lo = torch.where(more, mid, lo)
        hi = torch.where(more, hi, mid)
    thr = 0.5 * (lo + hi)
    mask = ax > thr
    cnt = mask.sum(dim=-1, keepdim=True)
    total = torch.where(mask, ax, 0.0).sum(dim=-1, keepdim=True,
                                           dtype=torch.float64)
    mu = (total / torch.clamp_min(cnt.to(torch.float64), 1.0)).to(torch.float32)
    out = torch.where(mask, torch.sign(xp) * mu, 0.0)
    out = out.view(n, t * SEG)[:, :d].contiguous()
    return out, cnt.sum(dim=(1, 2)).to(torch.float32)


def _launch(x: torch.Tensor, keep_frac: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = x.shape
    out = torch.empty_like(x)
    nnz = torch.empty((n,), dtype=torch.int32, device=x.device)
    lib = build.load("stc_topk")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.stc_batched_launch(x.data_ptr(), out.data_ptr(),
                                       nnz.data_ptr(), n, d, float(keep_frac),
                                       stream),
                "stc_batched")
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
    out, _ = _launch(x.view(1, -1), keep_frac)
    dense_launches += 1
    return out.view(x.shape)

"""FedAvg aggregation: the streaming weighted sum of client updates.

``out[d] = sum_n w[n] * U[n, d]`` over the stacked (N, D) f32 update
matrix — the CUDA port of the reference's ``fedavg_agg._agg_kernel``
(``csrc/fedavg_agg.cu``: a grid over D chunks, each thread accumulating its
columns over all N rows in fp32 registers, in row order).

:func:`fedavg_aggregate` launches the kernel for a CUDA tensor and uses
:func:`fedavg_plain` — the same sum in plain PyTorch, accumulated in the
same row order, so the two agree bit for bit — for a CPU tensor.  Any other
device, dtype or layout raises; there is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel in this process (see ``ops.launch_counts``)
launches = 0


def fedavg_plain(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(N, D), (N,) -> (D,) f32, summed over n = 0 .. N-1 in order."""
    u = updates.to(torch.float32)
    w = weights.to(torch.float32)
    acc = torch.zeros(u.shape[1], dtype=torch.float32, device=u.device)
    for n in range(u.shape[0]):
        acc = acc + w[n] * u[n]
    return acc


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


def fedavg_aggregate(updates: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of the rows of ``updates`` with ``weights``.

    A CPU tensor goes to :func:`fedavg_plain`; a CUDA tensor to the CUDA
    kernel (contiguous f32 required); any other device raises."""
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
    stream = build.stream(updates.device)
    build.check(lib.fedavg_agg_launch(updates.data_ptr(), weights.data_ptr(),
                                      out.data_ptr(), n, d, stream),
                "fedavg_agg")
    launches += 1
    return out

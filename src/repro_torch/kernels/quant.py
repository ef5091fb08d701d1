"""Batched int8 quantize -> dequantize round trip with per-row scales.

The stacked (N, D) f32 cohort update goes through two CUDA kernels
(``csrc/quant.cu``), the port of the reference's ``quant._rowmax_kernel``
and ``quant._qdq_kernel``:

1. :func:`rowmax` — per-row ``max |x|``;
2. the scale ``max(m, 1e-12) * f32(1/127)`` — a host-side PyTorch
   expression with the reciprocal constant built exactly as the reference
   builds it (:func:`int8_scale`);
3. :func:`qdq` — ``clip(round(x / s), -127, 127) * s``, round-half-even
   with an IEEE-rounded division.

Every step is order-free, so the kernels and the plain versions
(:func:`rowmax_plain`, :func:`qdq_plain`) agree bit for bit with each
other and with the reference.  A CPU tensor goes to the plain version, a
CUDA tensor to the kernel; any other device raises.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

#: launches of each CUDA kernel in this process (see ``ops.launch_counts``)
rowmax_launches = 0
qdq_launches = 0

_INV127 = np.float32(1.0 / 127.0)


def rowmax_plain(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).abs().amax(dim=1)


def qdq_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    s = scale[:, None]
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -127.0, 127.0)
    return q * s


def int8_scale(m: torch.Tensor) -> torch.Tensor:
    """Per-row scale from the row max: ``max(m, 1e-12) * f32(1/127)``."""
    return torch.clamp_min(m, 1e-12) * _INV127


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"{name} needs a contiguous (N, D) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} (contiguous={x.is_contiguous()})")


def rowmax(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N,) f32 per-row max |x|."""
    if x.device.type == "cpu":
        return rowmax_plain(x)
    _check("int8 rowmax", x)
    global rowmax_launches
    n, d = x.shape
    m = torch.empty((n,), dtype=torch.float32, device=x.device)
    lib = build.load("quant")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.int8_rowmax_launch(x.data_ptr(), m.data_ptr(), n, d,
                                       stream), "int8_rowmax")
    rowmax_launches += 1
    return m


def qdq(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(N, D), (N,) -> (N, D) f32 quantize -> dequantize round trip."""
    if x.device.type == "cpu":
        return qdq_plain(x, scale)
    _check("int8 qdq", x)
    if scale.shape != (x.shape[0],) or scale.dtype != torch.float32 \
            or scale.device != x.device or not scale.is_contiguous():
        raise ValueError(
            f"int8 qdq needs a contiguous ({x.shape[0]},) float32 scale on "
            f"{x.device}, got {tuple(scale.shape)} {scale.dtype} on "
            f"{scale.device}")
    global qdq_launches
    n, d = x.shape
    out = torch.empty_like(x)
    lib = build.load("quant")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.int8_qdq_launch(x.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), n, d, stream),
                "int8_qdq")
    qdq_launches += 1
    return out


def int8_roundtrip_batched(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-trip a stacked (N, D) update; returns ``(sent, scale)``."""
    scale = int8_scale(rowmax(x))
    return qdq(x, scale), scale

"""Int8 quantization: the batched round trip with per-row scales (K3) and
the dense tiled quantize / dequantize pair (K5).

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
other and with the reference.

The dense pair (the port of ``quant._quant_kernel`` / ``_dequant_kernel``,
reached through the reference's ``ops.quantize`` / ``ops.dequantize``):
:func:`quantize` cuts the flattened tensor into zero-padded 8192-element
tiles (the reference's (8, 1024) blocks) and returns int8 ``q`` of shape
(tiles * 8, 1024) with one f32 scale per tile, (tiles, 1):
``s = max(max|x|, 1e-12) / 127`` as a true IEEE division (unlike K3's
reciprocal multiply) and ``q = clip(rint(x / s), -127, 127)``;
:func:`dequantize` returns ``q * s`` in the original shape.  Both plain
versions divide tensor by tensor: PyTorch's CUDA division by a host scalar
multiplies by the reciprocal instead.

A CPU tensor goes to the plain version, a CUDA tensor to the kernel; any
other device raises.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

#: launches of each CUDA kernel in this process (see ``ops.launch_counts``)
rowmax_launches = 0
qdq_launches = 0
quantize_launches = 0
dequantize_launches = 0

TILE_R, TILE_C = 8, 1024
TILE = TILE_R * TILE_C          # elements per dense quantization tile

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


# ---------------------------------------------------------------------------
# Dense tiled quantize / dequantize (K5)
# ---------------------------------------------------------------------------


def _tiles(x: torch.Tensor) -> torch.Tensor:
    """The flattened tensor, zero-padded to whole tiles: (tiles, TILE) f32."""
    flat = x.reshape(-1).to(torch.float32)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % TILE)).view(
        -1, TILE)


def quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    t = _tiles(x)
    m = torch.clamp_min(t.abs().amax(dim=1, keepdim=True), 1e-12)
    s = m / torch.full_like(m, 127.0)               # tensor / tensor: IEEE
    q = torch.clamp(torch.round(t / s), -127.0, 127.0).to(torch.int8)
    return q.view(-1, TILE_C), s


def dequantize_plain(q: torch.Tensor, s: torch.Tensor, shape,
                     dtype=torch.float32) -> torch.Tensor:
    n = math.prod(shape)
    out = q.view(-1, TILE).to(torch.float32) * s
    return out.reshape(-1)[:n].reshape(shape).to(dtype)


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape f32 tensor -> (q int8 (tiles * 8, 1024), scales f32
    (tiles, 1)); the input to :func:`dequantize`."""
    if x.device.type == "cpu":
        return quantize_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8 quantize: no kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or not x.numel():
        raise ValueError(
            f"int8 quantize needs a non-empty contiguous float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} (contiguous={x.is_contiguous()})")
    global quantize_launches
    n = x.numel()
    tiles = -(-n // TILE)
    q = torch.empty((tiles * TILE_R, TILE_C), dtype=torch.int8,
                    device=x.device)
    s = torch.empty((tiles, 1), dtype=torch.float32, device=x.device)
    lib = build.load("quant")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.int8_quantize_launch(x.data_ptr(), q.data_ptr(),
                                         s.data_ptr(), n, stream),
                "int8_quantize")
    quantize_launches += 1
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    """(q, scales) from :func:`quantize` -> ``q * s`` of ``shape``."""
    if q.device.type == "cpu":
        return dequantize_plain(q, s, shape, dtype)
    if q.device.type != "cuda":
        raise RuntimeError(f"int8 dequantize: no kernel for device {q.device}")
    n = math.prod(shape)
    tiles = s.shape[0]
    if q.dtype != torch.int8 or q.shape != (tiles * TILE_R, TILE_C) \
            or s.shape != (tiles, 1) or s.dtype != torch.float32 \
            or s.device != q.device or not (q.is_contiguous()
                                            and s.is_contiguous()) \
            or not 0 < n <= tiles * TILE:
        raise ValueError(
            f"int8 dequantize needs contiguous int8 q ({tiles * TILE_R}, "
            f"{TILE_C}) and float32 scales ({tiles}, 1) on one device for "
            f"{n} elements, got q {tuple(q.shape)} {q.dtype}, s "
            f"{tuple(s.shape)} {s.dtype} on {s.device}")
    global dequantize_launches
    out = torch.empty(tuple(shape), dtype=torch.float32, device=q.device)
    lib = build.load("quant")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.int8_dequantize_launch(q.data_ptr(), s.data_ptr(),
                                           out.data_ptr(), n, stream),
                "int8_dequantize")
    dequantize_launches += 1
    return out.to(dtype)

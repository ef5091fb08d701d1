"""Int8 quantization: the batched round trip with per-row scales (K3) and
the dense tiled quantize / dequantize pair (K5).

The stacked (N, D) f32 cohort update goes through two CUDA kernels
(``csrc/quant.cu``), the port of the reference's ``quant._rowmax_kernel``
and ``quant._qdq_kernel``:

1. :func:`rowmax_scale` — per-row ``max |x|`` and, in the same launch,
   the scale ``max(m, 1e-12) * f32(1/127)`` with the reciprocal constant
   built exactly as the reference builds it (its plain version:
   :func:`rowmax_plain`, then :func:`int8_scale`); :func:`rowmax` is its
   ``m`` alone;
2. :func:`qdq` — ``clip(round(x / s), -127, 127) * s``, round-half-even
   with an IEEE-rounded division; with ``with_q`` the same launch also
   writes the int8 ``q`` (the sequential compression stage sends ``q`` and
   ``s``: ``repro_torch.core.compression.int8_compress_array``).

Every step is order-free, so the kernels and the plain versions
(:func:`rowmax_plain`, :func:`int8_scale`, :func:`qdq_plain`) agree bit
for bit with each other and with the reference.  K3a splits a long row
over C CTAs (:func:`rowmax_split`) whose last to arrive publishes the
row's max and scale; each row's 16-byte vectors start at its first
aligned element (:func:`row_plan`).  :func:`int8_roundtrip_batched_sharded` is
the route over a client mesh: each shard's rows through K3a + K3b on that
shard's device, no collective.

The dense pair (the port of ``quant._quant_kernel`` / ``_dequant_kernel``,
reached through the reference's ``ops.quantize`` / ``ops.dequantize``):
:func:`quantize` cuts the flattened tensor into zero-padded 8192-element
tiles (the reference's (8, 1024) blocks) and returns int8 ``q`` of shape
(tiles * 8, 1024) with one f32 scale per tile, (tiles, 1):
``s = max(max|x|, 1e-12) / 127`` as a true IEEE division (unlike K3's
reciprocal multiply) and ``q = clip(rint(x / s), -127, 127)``;
:func:`dequantize` returns ``q * s`` in the original shape.  Both plain
versions divide tensor by tensor: PyTorch's CUDA division by a host scalar
multiplies by the reciprocal instead.  :func:`quantize` takes f32, bf16 or
f16 and widens to f32 first, as the reference's kernel does.  Both kernels
take any pointer a contiguous tensor may have: 16-byte accesses from each
tile's first 16-byte-aligned element on, scalar ones for the head before
it and the tail after the last whole vector (:func:`tile_plan`; the wrapper
passes :func:`vector_head` of the input's address).

A CPU tensor goes to the plain version, a CUDA tensor to the kernel; any
other device raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.mesh import (
    CLIENT_AXIS, Rows, as_shards, check_mesh, gather_rows,
)

#: launches of each CUDA kernel in this process (see ``ops.launch_counts``)
rowmax_launches = 0
qdq_launches = 0
quantize_launches = 0
dequantize_launches = 0

TILE_R, TILE_C = 8, 1024
TILE = TILE_R * TILE_C          # elements per dense quantization tile

_INV127 = np.float32(1.0 / 127.0)
_INV127_ARG = ctypes.c_float(_INV127)      # the same f32, as K3a takes it


def rowmax_plain(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).abs().amax(dim=1)


def qdq_plain(x: torch.Tensor, scale: torch.Tensor, with_q: bool = False):
    s = scale[:, None]
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -127.0, 127.0)
    return (q * s, q.to(torch.int8)) if with_q else q * s


def int8_scale(m: torch.Tensor) -> torch.Tensor:
    """Per-row scale from the row max: ``max(m, 1e-12) * f32(1/127)``."""
    return torch.clamp_min(m, 1e-12) * _INV127


#: K3a's launch shape (``csrc/quant.cu``'s ``RM_*``): CTAs resident an SM,
#: 16-byte vectors a CTA's batch (256 threads x 8 loads), the most rows a
#: launch may split (its arrival counters a stream) and the streams a
#: device with counters of their own
RM_CTAS_PER_SM = 4
RM_BATCH = 256 * 8
RM_SPLIT_ROWS = 1024
RM_SLOTS = 32


def row_plan(d: int, head0: int, row: int) -> Tuple[int, int, int]:
    """K3a's accesses in ``row`` of a contiguous (N, d) f32 matrix whose
    first element lies ``head0`` elements before a 16-byte boundary
    (:func:`vector_head`): :func:`tile_plan` of the row at its own
    alignment.  -> ``(lead, number of 16-byte vectors, tail)``."""
    return tile_plan(d, (head0 - row * d) % 4, 4)


def rowmax_split(n: int, d: int, sms: int) -> int:
    """CTAs a row of K3a on a card of ``sms`` SMs: as many as keep the
    whole launch resident (``RM_CTAS_PER_SM`` a SM) and no more than the
    row has batches, then as few as take the same most batches a CTA (so
    no CTA idles behind a busier one for a whole batch)."""
    batches = max(1, -(-(d // 4) // RM_BATCH))
    cap = max(1, sms * RM_CTAS_PER_SM // n) if n <= RM_SPLIT_ROWS else 1
    per = -(-batches // cap)
    return -(-batches // per)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"{name} needs a contiguous (N, D) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} (contiguous={x.is_contiguous()})")


def rowmax_scale(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) -> ((N,) f32 per-row max |x|, (N,) f32 scale
    :func:`int8_scale` of it), both from one K3a launch on a card."""
    if x.device.type == "cpu":
        m = rowmax_plain(x)
        return m, int8_scale(m)
    _check("int8 rowmax", x)
    global rowmax_launches
    dev = x.device
    n, d = x.shape
    if n > 65535:
        raise ValueError(f"int8 rowmax takes at most 65535 rows, got {n}")
    c = rowmax_split(n, d, _sms(dev.index))
    # m, scale and (for C > 1) the CTAs' partials in one allocation; the
    # pointers by arithmetic (a view a pointer costs the host more)
    buf = torch.empty((2 + (c if c > 1 else 0), n), dtype=torch.float32,
                      device=dev)
    ptr, out = x.data_ptr(), buf.data_ptr()
    build.launch(dev, "int8_rowmax", build.load("quant").int8_rowmax_launch,
                 ptr, out, out + 4 * n, out + 8 * n if c > 1 else None, n, d,
                 c, vector_head(ptr, 4), _INV127_ARG,
                 build.stream_slot(dev, RM_SLOTS))
    rowmax_launches += 1
    return buf[0], buf[1]


def rowmax(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N,) f32 per-row max |x| (:func:`rowmax_scale`'s m)."""
    return rowmax_scale(x)[0]


def qdq(x: torch.Tensor, scale: torch.Tensor, with_q: bool = False):
    """(N, D), (N,) -> (N, D) f32 quantize -> dequantize round trip; with
    ``with_q`` -> (round trip, (N, D) int8 q) from the same launch."""
    if x.device.type == "cpu":
        return qdq_plain(x, scale, with_q)
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
    q = torch.empty((n, d), dtype=torch.int8, device=x.device) if with_q \
        else None
    lib = build.load("quant")
    build.launch(x.device, "int8_qdq", lib.int8_qdq_launch, x.data_ptr(),
                 scale.data_ptr(), out.data_ptr(),
                 None if q is None else q.data_ptr(), n, d)
    qdq_launches += 1
    return (out, q) if with_q else out


def int8_roundtrip_batched(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-trip a stacked (N, D) update; returns ``(sent, scale)``: two
    launches on a card, K3a (max and scale) and K3b."""
    scale = rowmax_scale(x)[1]
    return qdq(x, scale), scale


def int8_roundtrip_batched_sharded(
        x: Rows, mesh, axis: str = CLIENT_AXIS
) -> Tuple[Union[torch.Tensor, List[torch.Tensor]],
           Union[torch.Tensor, List[torch.Tensor]]]:
    """:func:`int8_roundtrip_batched` of each shard's rows on its device:
    ``x`` whole ((N, D), N divisible by the mesh size) -> ``(sent,
    scale)`` gathered on the first shard's device; ``x`` as row blocks ->
    lists of per-shard ``sent`` and ``scale``."""
    check_mesh(mesh, axis, "int8_roundtrip_batched_sharded")
    parts, whole = as_shards(x, mesh, "int8_roundtrip_batched_sharded")
    outs = [int8_roundtrip_batched(p) for p in parts]
    sent, scale = [o for o, _ in outs], [s for _, s in outs]
    if whole:
        return gather_rows(sent), gather_rows(scale)
    return sent, scale


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


def edge_tiles(seed: int = 0) -> torch.Tensor:
    """Six dense-quantization tiles, flattened, f32 on the CPU, that stress
    K5: unit noise; signed zeros; subnormals only; exact half-integer
    quotients (max |x| = 127, so s = 1 and each x / s = k + 1/2 rounds half
    to even); noise with a NaN; noise with +inf and -inf."""
    rs = np.random.RandomState(seed)
    t = rs.standard_normal((6, TILE))
    sign = np.where(rs.rand(TILE) < 0.5, -1.0, 1.0)
    t[1] = sign * 0.0
    t[2] = sign * rs.randint(1, 2 ** 23, TILE) * 2.0 ** -149
    t[3] = rs.randint(-127, 127, TILE) + 0.5
    t[3, rs.randint(TILE)] = 127.0
    t[4, rs.randint(TILE)] = np.nan
    t[5, rs.permutation(TILE)[:2]] = (np.inf, -np.inf)
    return torch.from_numpy(t.astype(np.float32).reshape(-1))


_QUANT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def vector_head(ptr: int, itemsize: int) -> int:
    """Elements from a tile's start to its first 16-byte-aligned element,
    for data at byte address ``ptr`` (the same in every tile: a tile's bytes
    are a multiple of 16)."""
    return (-ptr % 16) // itemsize


def tile_plan(real: int, head: int, vec: int) -> Tuple[int, int, int]:
    """The K5 kernels' accesses in a tile of ``real`` elements
    (``csrc/quant.cu::TilePlan``): 16-byte vectors of ``vec`` elements cover
    ``[lead, tail)``, scalar accesses ``[0, lead)`` and ``[tail, real)``.
    -> ``(lead, number of vectors, tail)``."""
    lead = min(head, real)
    nvec = (real - lead) // vec
    return lead, nvec, lead + vec * nvec


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape f32, bf16 or f16 tensor -> (q int8 (tiles * 8, 1024),
    scales f32 (tiles, 1)); the input to :func:`dequantize`."""
    dev = x.device
    if dev.type == "cpu":
        return quantize_plain(x)
    if dev.type != "cuda":
        raise RuntimeError(f"int8 quantize: no kernel for device {dev}")
    code = _QUANT_DTYPES.get(x.dtype)
    if code is None or not x.is_contiguous() or not x.numel():
        raise ValueError(
            f"int8 quantize needs a non-empty contiguous float32, bfloat16 "
            f"or float16 tensor, got {tuple(x.shape)} {x.dtype} "
            f"(contiguous={x.is_contiguous()})")
    global quantize_launches
    n = x.numel()
    tiles = -(-n // TILE)
    q = torch.empty((tiles * TILE_R, TILE_C), dtype=torch.int8, device=dev)
    s = torch.empty((tiles, 1), dtype=torch.float32, device=dev)
    ptr = x.data_ptr()
    build.launch(dev, "int8_quantize",
                 build.load("quant").int8_quantize_launch, ptr, q.data_ptr(),
                 s.data_ptr(), n, code,
                 vector_head(ptr, x.element_size()))
    quantize_launches += 1
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    """(q, scales) from :func:`quantize` -> ``q * s`` of ``shape``."""
    dev = q.device
    if dev.type == "cpu":
        return dequantize_plain(q, s, shape, dtype)
    if dev.type != "cuda":
        raise RuntimeError(f"int8 dequantize: no kernel for device {dev}")
    n = math.prod(shape)
    tiles = s.shape[0]
    if q.dtype != torch.int8 or q.shape != (tiles * TILE_R, TILE_C) \
            or s.shape != (tiles, 1) or s.dtype != torch.float32 \
            or s.device != dev or not (q.is_contiguous()
                                       and s.is_contiguous()) \
            or not 0 < n <= tiles * TILE:
        raise ValueError(
            f"int8 dequantize needs contiguous int8 q ({tiles * TILE_R}, "
            f"{TILE_C}) and float32 scales ({tiles}, 1) on one device for "
            f"{n} elements, got q {tuple(q.shape)} {q.dtype}, s "
            f"{tuple(s.shape)} {s.dtype} on {s.device}")
    global dequantize_launches
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    ptr = q.data_ptr()
    build.launch(dev, "int8_dequantize",
                 build.load("quant").int8_dequantize_launch, ptr,
                 s.data_ptr(), out.data_ptr(), n, vector_head(ptr, 1))
    dequantize_launches += 1
    return out if dtype == torch.float32 else out.to(dtype)


def kernel_info(kernel: str) -> dict:
    """{"registers", "spill_bytes", "smem_bytes" (static), "ctas_per_sm"}
    of ``"quantize"`` (f32), ``"dequantize"`` or ``"rowmax"`` (needs a
    card)."""
    vals = (ctypes.c_int * 4)()
    build.check(build.load("quant").int8_kernel_info(
        ("quantize", "dequantize", "rowmax").index(kernel), vals),
        "int8_kernel_info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "ctas_per_sm"), vals))

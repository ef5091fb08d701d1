"""Chunked WKV6 recurrence (RWKV-6 time-mix), the port of the reference's
``rwkv6_scan._wkv6_kernel``.

``wkv6(r, k, v, logw, u, s0)`` with r, k, v, logw (B, T, H, hd), u (H, hd)
and s0 (B, H, hd, hd) returns y (B, T, H, hd) and the final state sT, all
float32; T is a multiple of :data:`CHUNK` (callers pad with log w = 0 and
k = 0).  Each (batch, head) walks its 64-step chunks in order with the
state carried: a cross-chunk product against the state, the scores inside
the chunk with the diagonal bonus ``u``, and the state carried to the
chunk's end.  The chunk is cut into sub-chunks of :data:`SUB` steps:
scores within a sub-chunk keep the exact log-space pairwise gates, scores
against an earlier sub-chunk are a product of two factors taken through
the log decay at the end of the previous sub-chunk — every exponent <= 0
either way, up to the rounding of cw - log w (``csrc/wkv6.cu`` says why,
and how the CUDA kernel lays this out on the tensor cores).

:func:`wkv6` launches the kernel for CUDA tensors and takes
:func:`wkv6_plain` — the same sub-chunked arithmetic, vectorized over
batch and heads — for CPU tensors; any other device raises.  The exact
pairwise form is the model's own ``models/rwkv6.wkv6_chunked``;
:func:`wkv6_ref` is the sequential token-by-token recurrence, the
reference's ground truth (``kernels/ref.py::wkv6_ref``).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from repro_torch.kernels import build

CHUNK = 64
SUB = 16                         # sub-chunk: an m-tile of the products
MAX_HEAD_DIM = 64                # the CUDA kernel's shared-memory layout

#: launches of the CUDA kernel in this process (see ``ops.launch_counts``)
launches = 0


def serial_cumsum(wb: torch.Tensor) -> torch.Tensor:
    """The inclusive cumsum of log w over a chunk (dim 2 of (B, H, L, hd)),
    added serially in f32 as the kernel adds it (``csrc/wkv6.cu``'s
    ``chunk_cumsum`` says why that order); ``torch.cumsum`` adds in double
    on the CPU."""
    cw = torch.empty_like(wb)
    acc = torch.zeros_like(wb[:, :, 0])
    for t in range(wb.shape[2]):
        acc = acc + wb[:, :, t]
        cw[:, :, t] = acc
    return cw


def wkv6_plain(r, k, v, logw, u, s0,
               matmul: Callable = torch.matmul
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's sub-chunked arithmetic in plain PyTorch, float32.
    ``matmul`` computes the four products the kernel runs on the tensor
    cores — (r exp(cwx)) S, the off-diagonal score blocks, P V and the
    state update — so a test can emulate the kernel's 3xTF32 through it."""
    f32 = torch.float32
    r, k, v, logw, u, S = (a.to(f32) for a in (r, k, v, logw, u, s0))
    B, T, H, hd = r.shape
    L, n = CHUNK, CHUNK // SUB
    dev = r.device
    strict = torch.tril(torch.ones((SUB, SUB), dtype=torch.bool, device=dev),
                        diagonal=-1)
    eye = torch.eye(SUB, dtype=torch.bool, device=dev)
    # key s lies in a sub-chunk before row block a
    before = (torch.arange(L, device=dev)[None, :]
              < SUB * torch.arange(n, device=dev)[:, None])   # (n, L)
    ys = []
    for c in range(T // L):
        rb, kb, vb, wb = (a[:, c * L:(c + 1) * L].transpose(1, 2)
                          for a in (r, k, v, logw))          # (B,H,L,hd)
        cw = serial_cumsum(wb)
        cwx = cw - wb
        y = matmul(rb * torch.exp(cwx), S)
        # diagonal blocks: exact pairwise gates, the bonus on the diagonal
        rs, ks, xs, cs = (a.reshape(B, H, n, SUB, hd)
                          for a in (rb, kb, cwx, cw))
        diff = xs[:, :, :, :, None, :] - cs[:, :, :, None, :, :]
        gate = torch.exp(torch.where(strict[:, :, None], diff, -torch.inf))
        gate = torch.where(eye[:, :, None], u[None, :, None, None, None, :],
                           gate)                    # (B,H,n,SUB,SUB,hd)
        diag = ((rs[:, :, :, :, None, :] * gate)
                * ks[:, :, :, None, :, :]).sum(-1)  # (B,H,n,SUB,SUB)
        # off-diagonal blocks through ref = cw at the end of sub-chunk a - 1
        ref = torch.cat([torch.zeros_like(cw[:, :, :1]),
                         cw[:, :, SUB - 1:L - 1:SUB]], 2)     # (B,H,n,hd)
        a_fac = rs * torch.exp(xs - ref[:, :, :, None, :])
        b_exp = torch.where(before[:, :, None],
                            ref[:, :, :, None, :] - cw[:, :, None, :, :],
                            -torch.inf)
        b_fac = kb[:, :, None] * torch.exp(b_exp)  # (B,H,n,L,hd)
        P = matmul(a_fac, b_fac.transpose(-1, -2))  # (B,H,n,SUB,L)
        P = P.reshape(B, H, L, L).clone()
        for a in range(n):
            P[:, :, SUB * a:SUB * (a + 1), SUB * a:SUB * (a + 1)] = diag[:, :, a]
        y = y + matmul(P, vb)
        k_dec = kb * torch.exp(cw[:, :, -1:, :] - cw)
        S = torch.exp(cw[:, :, -1, :])[..., None] * S \
            + matmul(k_dec.transpose(-1, -2), vb)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1), S


def wkv6_ref(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (non-chunked) WKV6 recurrence — ground truth."""
    f32 = torch.float32
    r, k, v, logw, u, S = (a.to(f32) for a in (r, k, v, logw, u, s0))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv6(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, T, H, hd), sT (B, H, hd, hd); inputs are cast to contiguous
    float32 (as the reference's wrapper casts them)."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, s0)
    if r.device.type != "cuda":
        raise RuntimeError(f"wkv6: no kernel for device {r.device}")
    B, T, H, hd = r.shape
    want = {"r": (B, T, H, hd), "k": (B, T, H, hd), "v": (B, T, H, hd),
            "logw": (B, T, H, hd), "u": (H, hd), "s0": (B, H, hd, hd)}
    got = dict(zip(want, (r, k, v, logw, u, s0)))
    for name, t in got.items():
        if tuple(t.shape) != want[name] or t.device != r.device:
            raise ValueError(
                f"wkv6: {name} must be {want[name]} on {r.device}, got "
                f"{tuple(t.shape)} on {t.device}")
    if T % CHUNK or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"wkv6 needs T % {CHUNK} == 0 and head dim <= "
                         f"{MAX_HEAD_DIM}, got T={T}, hd={hd}")
    global launches
    r, k, v, logw, u, s0 = (t.to(torch.float32).contiguous()
                            for t in got.values())
    y = torch.empty_like(r)
    sT = torch.empty_like(s0)
    lib = build.load("wkv6")
    build.launch(r.device, "wkv6", lib.wkv6_launch, r.data_ptr(),
                 k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                 s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, T, H, hd)
    launches += 1
    return y, sT


def kernel_info(hd: int = MAX_HEAD_DIM) -> dict:
    """{"registers", "spill_bytes", "smem_bytes", "ctas_per_sm"} of the CUDA
    kernel built for head dim ``hd`` (needs a card)."""
    vals = (ctypes.c_int * 4)()
    build.check(build.load("wkv6").wkv6_kernel_info(hd, vals),
                "wkv6_kernel_info")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "ctas_per_sm"), vals))

"""Chunked WKV6 recurrence (RWKV-6 time-mix), the port of the reference's
``rwkv6_scan._wkv6_kernel``.

``wkv6(r, k, v, logw, u, s0)`` with r, k, v, logw (B, T, H, hd), u (H, hd)
and s0 (B, H, hd, hd) returns y (B, T, H, hd) and the final state sT, all
float32; T is a multiple of :data:`CHUNK` (callers pad with log w = 0 and
k = 0).  Each (batch, head) walks its 64-step chunks in order with the
state carried: a cross-chunk product against the state, exact log-space
pairwise gates inside the chunk (every exponent <= 0), the diagonal bonus
``u``, and the state carried to the chunk's end
(``csrc/wkv6.cu`` says how the CUDA kernel lays this out).

:func:`wkv6` launches the kernel for CUDA tensors and takes
:func:`wkv6_plain` — a chunk loop with the kernel's arithmetic, vectorized
over batch and heads — for CPU tensors; any other device raises.
:func:`wkv6_ref` is the sequential token-by-token recurrence, the
reference's ground truth (``kernels/ref.py::wkv6_ref``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

CHUNK = 64
MAX_HEAD_DIM = 64                # the CUDA kernel's shared-memory layout

#: launches of the CUDA kernel in this process (see ``ops.launch_counts``)
launches = 0


def wkv6_plain(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's chunk loop in plain PyTorch (the bonus term sits on the
    diagonal of the intra-chunk scores, as in the kernel)."""
    f32 = torch.float32
    r, k, v, logw, u, S = (a.to(f32) for a in (r, k, v, logw, u, s0))
    B, T, H, hd = r.shape
    L = CHUNK
    strict = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    ys = []
    for c in range(T // L):
        rb, kb, vb, wb = (a[:, c * L:(c + 1) * L].transpose(1, 2)
                          for a in (r, k, v, logw))          # (B,H,L,hd)
        cw = torch.cumsum(wb, dim=2)
        cwx = cw - wb
        diff = cwx[:, :, :, None, :] - cw[:, :, None, :, :]  # (B,H,L,L,hd)
        gate = torch.exp(torch.where(strict[:, :, None], diff, -torch.inf))
        scores = ((rb[:, :, :, None, :] * gate)
                  * kb[:, :, None, :, :]).sum(-1)
        bonus = ((rb * u[None, :, None, :]) * kb).sum(-1)
        scores = scores + torch.diag_embed(bonus)
        y = (rb * torch.exp(cwx)) @ S + scores @ vb
        k_dec = kb * torch.exp(cw[:, :, -1:, :] - cw)
        S = torch.exp(cw[:, :, -1, :])[..., None] * S \
            + k_dec.transpose(-1, -2) @ vb
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
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
                                y.data_ptr(), sT.data_ptr(), B, T, H, hd,
                                stream),
                "wkv6")
    launches += 1
    return y, sT

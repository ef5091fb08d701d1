"""Flash attention: tiled online-softmax forward and the flash backward.

The port of the reference's ``kernels/attention.py`` — the LLM fine-tuning
hot path behind ``REPRO_FLASH_ATTN`` (``models/attention``).  Three CUDA
kernels (``csrc/flash_attn.cu``) replace the three Pallas kernels:

* ``flash_fwd`` (``_fwd_kernel``) — O and the row log-sum-exp (LSE),
  streaming key tiles with the running max / denominator recurrence;
* ``flash_dq`` (``_dq_kernel``) — dQ over key tiles, probabilities
  recomputed from the LSE;
* ``flash_dkv`` (``_dkv_kernel``) — dK and dV over query tiles.

Tensors are (BH, S, D) float32, MHA layout; ``delta = rowsum(dO * O)`` is
plain PyTorch between the forward and the backward kernels, as in the
reference.  The semantics are the reference's: scale ``1/sqrt(D)`` of the
real head dim, validity from global indices, masked scores ``-1e30``,
denominator floor ``1e-30``.  The kernels take any S and D <= 256 (the
reference's config zoo tops out at 256: PaliGemma and RecurrentGemma; 192
for Nemotron-4).  Above 128 all three run one CTA of 8 warps a 64-row
tile: 4 pairs of warps, the two warps of a pair splitting the head dim and
swapping their partial score tiles through shared memory, so each score
product runs once (``csrc/flash_attn.cu``).

They run every product on the H100's tensor cores (``mma.sync`` m16n8k8
TF32) in 3xTF32 — each fp32 operand split into a TF32 ``big`` and the
remainder ``small``, three TF32 products a fp32-accurate one — so they keep
fp32 accuracy ("TF32 off": within 1e-5 of the plain versions on O and LSE,
1e-4 on the gradients at unit-scale inputs).  FA2-style tiles: 16 rows a
warp (a warp pair above D 128), the score tile's C fragment reused as the
next product's A fragment, K/V (or Q/dO) streamed with ``cp.async``; the
design and its bound are in the source's header.  :func:`kernel_info`
reports each kernel's registers, spills, shared memory, CTAs per SM,
threads a CTA and grid z.

Two ``torch.library`` custom ops carry them through ``torch.func``:
``repro_torch::flash_fwd`` -> (O, LSE) and ``repro_torch::flash_bwd`` ->
(dQ, dK, dV).  Each has a CPU implementation, the plain version
(:func:`flash_fwd_plain`, :func:`flash_bwd_plain`: materialized scores with
the same masking), and a CUDA implementation, the kernels; a tensor on any
other device has no implementation and raises.  ``register_vmap`` folds a
vmapped dimension (the cohort's clients) into BH, so one launch serves the
whole cohort.  A ``torch.autograd.Function`` with ``setup_context`` wires
the forward op to the backward op (``torch.func.grad`` needs that form; a
custom op's own ``register_autograd`` is refused by ``torch.func``).  The
same autograd and vmap rules run on the CPU and the card; only the
implementation under them differs.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

TILE = 64
NEG_INF = -1e30
_TINY = 1e-30          # denominator floor for fully-masked rows
MAX_HEAD_DIM = 256     # the CUDA kernels' limit

#: launches of each CUDA kernel in this process (see ``ops.launch_counts``)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _mask(s: int, causal: bool, device) -> torch.Tensor:
    if not causal:
        return torch.ones((s, s), dtype=torch.bool, device=device)
    i = torch.arange(s, device=device)
    return i[None, :] <= i[:, None]


def _probs_scale(q, k, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    return s, _mask(q.shape[1], causal, q.device), scale


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, D) x3 -> (O (BH, S, D), LSE (BH, S)), materialized scores."""
    s, mask, _ = _probs_scale(q, k, causal)
    m = torch.where(mask, s, NEG_INF).amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = torch.clamp_min(p.sum(dim=-1), _TINY)
    o = torch.einsum("bqk,bkd->bqd", p, v) / l[..., None]
    return o, m + torch.log(l)


def _recomputed_probs(q, k, lse, causal):
    s, mask, scale = _probs_scale(q, k, causal)
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0), scale


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """dQ with the probabilities recomputed from the LSE."""
    p, scale = _recomputed_probs(q, k, lse, causal)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bqk,bkd->bqd", ds, k)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) with the probabilities recomputed from the LSE."""
    p, scale = _recomputed_probs(q, k, lse, causal)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return (torch.einsum("bqk,bqd->bkd", ds, q),
            torch.einsum("bqk,bqd->bkd", p, do))


def flash_bwd_plain(q, k, v, o, lse, do, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_fwd_plain`'s O: -> (dQ, dK, dV), with
    ``delta = rowsum(dO * O)``."""
    delta = (do * o).sum(dim=-1)
    return (flash_dq_plain(q, k, v, do, lse, delta, causal),
            *flash_dkv_plain(q, k, v, do, lse, delta, causal))


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check(name: str, q: torch.Tensor, *rest: torch.Tensor) -> None:
    """(BH, S, D) q, then tensors of q's shape or (BH, S) row vectors: all
    contiguous float32 on q's CUDA device."""
    if q.dim() != 3 or q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name} needs (BH, S, D) tensors with D <= "
                         f"{MAX_HEAD_DIM}, got {tuple(q.shape)}")
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    for t in (q, *rest):
        if t.shape not in (q.shape, q.shape[:2]) or \
                t.dtype != torch.float32 or t.device != q.device or \
                not t.is_contiguous():
            raise ValueError(
                f"{name} needs contiguous float32 tensors of shape "
                f"{tuple(q.shape)} or {tuple(q.shape[:2])} on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _fwd_cuda(q, k, v, causal: bool):
    global fwd_launches
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check("flash_fwd", q, k, v)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attn")
    build.launch(q.device, "flash_fwd", lib.flash_fwd_launch,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), bh, s, d, 1.0 / math.sqrt(d), int(causal))
    fwd_launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """dQ on the card (CUDA tensors, contiguous float32)."""
    global dq_launches
    _check("flash_dq", q, k, v, do, lse, delta)
    bh, s, d = q.shape
    dq = torch.empty_like(q)
    lib = build.load("flash_attn")
    build.launch(q.device, "flash_dq", lib.flash_dq_launch,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
                 1.0 / math.sqrt(d), int(causal))
    dq_launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) on the card (CUDA tensors, contiguous float32)."""
    global dkv_launches
    _check("flash_dkv", q, k, v, do, lse, delta)
    bh, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = build.load("flash_attn")
    build.launch(q.device, "flash_dkv", lib.flash_dkv_launch,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), bh, s, d, 1.0 / math.sqrt(d), int(causal))
    dkv_launches += 1
    return dk, dv


def kernel_info(d: int = 128) -> dict:
    """{kernel: {"registers", "spill_bytes", "smem_bytes", "ctas_per_sm",
    "threads", "grid_z"}} of the three CUDA kernels built for head dim
    ``d`` (needs a card); a launch's grid is (BH, ceil(S / 64), grid_z),
    grid_z 1 at every head dim; threads 128, or 256 above D 128 (the warp
    pairs)."""
    lib = build.load("flash_attn")
    out = {}
    for which, name in enumerate(("flash_fwd", "flash_dq", "flash_dkv")):
        vals = (ctypes.c_int * 6)()
        build.check(lib.flash_kernel_info(which, d, vals), "flash_kernel_info")
        out[name] = dict(zip(("registers", "spill_bytes", "smem_bytes",
                              "ctas_per_sm", "threads", "grid_z"), vals))
    return out


def _bwd_cuda(q, k, v, o, lse, do, causal):
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    delta = (do * o).sum(dim=-1)
    return (flash_dq(q, k, v, do, lse, delta, causal),
            *flash_dkv(q, k, v, do, lse, delta, causal))


# ---------------------------------------------------------------------------
# custom ops: CPU = plain version, CUDA = kernels; autograd and vmap rules
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, D) x3 -> (O, LSE).  CPU: the plain version."""
    return flash_fwd_plain(q, k, v, causal)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=(),
                         device_types="cpu")
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dQ, dK, dV).  CPU: the plain version."""
    return flash_bwd_plain(q, k, v, o, lse, do, causal)


flash_fwd.register_kernel("cuda")(_fwd_cuda)
flash_bwd.register_kernel("cuda")(_bwd_cuda)


@flash_fwd.register_fake
def _fwd_fake(q, k, v, causal):
    return q.new_empty(q.shape), q.new_empty(q.shape[:2])


@flash_bwd.register_fake
def _bwd_fake(q, k, v, o, lse, do, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _fold(x: torch.Tensor, dim, n: int) -> torch.Tensor:
    """Move the vmapped dim (or a broadcast of it) into BH."""
    x = (x.unsqueeze(0).expand((n,) + tuple(x.shape)) if dim is None
         else x.movedim(dim, 0))
    return x.reshape((n * x.shape[1],) + tuple(x.shape[2:]))


def _unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.view((n, x.shape[0] // n) + tuple(x.shape[1:]))


@flash_fwd.register_vmap
def _fwd_vmap(info, in_dims, q, k, v, causal):
    n = info.batch_size
    o, lse = flash_fwd(*(_fold(t, d, n) for t, d in zip((q, k, v), in_dims)),
                       causal)
    return (_unfold(o, n), _unfold(lse, n)), (0, 0)


@flash_bwd.register_vmap
def _bwd_vmap(info, in_dims, q, k, v, o, lse, do, causal):
    n = info.batch_size
    grads = flash_bwd(*(_fold(t, d, n) for t, d in
                        zip((q, k, v, o, lse, do), in_dims)), causal)
    return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


class _Flash(torch.autograd.Function):
    """O of :func:`flash_fwd` with :func:`flash_bwd` as its gradient.  Under
    ``torch.func.vmap`` the forward and backward run batched and the ops'
    vmap rules fold the batch into BH (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal):
        return flash_fwd(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal = causal

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        with torch.no_grad():      # first-order only: no graph through it
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Tiled online-softmax attention with the flash backward.

    q, k, v: (B, H, S, D), MHA layout (``models/attention`` repeats GQA kv
    heads per group first).  Returns (B, H, S, D) in ``q.dtype``;
    differentiable (also under ``torch.func.grad`` / ``vmap``) through
    :func:`flash_bwd`."""
    B, H, S, D = q.shape

    def flat(x):
        return x.reshape(B * H, S, x.shape[-1]).to(torch.float32)
    o, _ = _Flash.apply(flat(q), flat(k), flat(v), bool(causal))
    return o.reshape(B, H, S, D).to(q.dtype)

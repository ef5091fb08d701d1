"""Update-compression stages (paper §V-B: compression/decompression stages).

Implemented compressors:

* ``stc``  — Sparse Ternary Compression [Sattler et al., TNNLS'19]: keep the
  top-p fraction of entries by magnitude per 8192-element tile of each
  tensor's flat vector (threshold bisection), replace kept entries with
  ``±mean(|kept|)``.  A tensor goes through the batched STC kernel as one
  ``(1, n)`` row (``kernels.ops.stc_compress_batched``, whose segments are
  the reference stage's tiles), so the per-client stage and the batched
  engine's in-program compression launch the same kernel and ``nnz`` comes
  from the kernel's counts.
* ``int8`` — symmetric per-tensor int8 quantization: the scale
  ``max(max|x|, 1e-12) * f32(1/127)`` from the row-max kernel on one row,
  ``q = clip(round(x / scale), -127, 127)`` and the round trip ``q * scale``
  from one launch of the round-trip kernel (``kernels.quant.qdq`` with
  ``with_q``).
* error feedback (residual accumulation) for biased compressors, used by
  the client's compression stage (the batched engine keeps the same
  residuals in its device-resident store).

A compressed message is a tree of :class:`CompressedTensor` leaves; its
semantics are dense-equivalent after :func:`decompress`, and
:func:`payload_bytes` gives its wire size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.comm.serialize import array_nbytes
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant
from repro_torch.kernels.stc_topk import BISECT_ITERS as STC_BISECT_ITERS
from repro_torch.utils.tree import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)

PyTree = Any

# Tensors smaller than this stay dense through every compressor — the
# per-client stage and the batched in-program path must agree on which
# leaves compress, for parity and the wire accounting.
DENSE_MIN_ELEMS = 64


@dataclass(frozen=True)
class CompressedTensor:
    kind: str              # "stc" | "int8" | "dense"
    data: Any              # dense values (stc: sparsified dense; int8: int8)
    scale: Any = None      # int8 scale (0-d f32)
    nnz: Any = None        # stc: number of non-zeros (0-d int32)


def stc_threshold(absx: torch.Tensor, keep_frac: float,
                  iters: int = STC_BISECT_ITERS) -> torch.Tensor:
    """Bisection for a *global* t such that ~keep_frac of |x| exceeds t.
    Kept for experiments: the built-in ``stc`` compressor is tile-local
    (:func:`stc_compress_array`)."""
    x = absx.reshape(-1).to(torch.float32)
    target = float(max(int(round(keep_frac * x.numel())), 1))
    lo = torch.zeros((), dtype=torch.float32, device=x.device)
    hi = x.max() + 1e-12
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        more = (x > mid).sum() > target      # too many kept: raise t
        lo = torch.where(more, mid, lo)
        hi = torch.where(more, hi, mid)
    return 0.5 * (lo + hi)


def stc_compress_array(x: torch.Tensor, keep_frac: float) -> CompressedTensor:
    """Tile-local STC of one tensor (see the module docstring)."""
    out, nnz = kops.stc_compress_batched(
        x.reshape(1, -1).to(torch.float32).contiguous(), keep_frac)
    return CompressedTensor("stc", out.view(x.shape).to(x.dtype),
                            nnz=nnz[0].to(torch.int32))


def _int8(x: torch.Tensor) -> Tuple[CompressedTensor, torch.Tensor]:
    """-> (the int8 leaf, its f32 round trip ``q * scale``)."""
    row = x.reshape(1, -1).to(torch.float32).contiguous()
    scale = quant.int8_scale(quant.rowmax(row))
    sent, q = quant.qdq(row, scale, with_q=True)
    return (CompressedTensor("int8", q.view(x.shape), scale=scale[0]),
            sent.view(x.shape))


def int8_compress_array(x: torch.Tensor) -> CompressedTensor:
    """Per-tensor int8 of one tensor (see the module docstring)."""
    return _int8(x)[0]


def decompress_array(c: CompressedTensor,
                     dtype=torch.float32) -> torch.Tensor:
    if c.kind == "int8":
        return (c.data.to(torch.float32) * c.scale).to(dtype)
    return c.data.to(dtype)


def _compress_leaf(x: torch.Tensor, method: str, stc_sparsity: float
                   ) -> Tuple[CompressedTensor, torch.Tensor]:
    """-> (the compressed leaf, what the server decompresses it to)."""
    if x.dim() == 0 or x.numel() < DENSE_MIN_ELEMS:  # tiny tensors stay dense
        c = CompressedTensor("dense", x)
        return c, decompress_array(c)
    if method == "stc":
        c = stc_compress_array(x, stc_sparsity)
        return c, decompress_array(c)
    if method == "int8":
        return _int8(x)
    raise ValueError(f"unknown compression {method!r}")


# ---------------------------------------------------------------------------
# Tree-level API (the compression/decompression *stages*)
# ---------------------------------------------------------------------------


def compress(tree: PyTree, method: str = "none",
             stc_sparsity: float = 0.01) -> PyTree:
    if method in ("none", "", None):
        return tree
    return tree_map(lambda x: _compress_leaf(x, method, stc_sparsity)[0],
                    tree)


def decompress(tree: PyTree) -> PyTree:
    return tree_map(lambda x: decompress_array(x)
                    if isinstance(x, CompressedTensor) else x, tree)


def stc_leaf_bytes(nnz):
    """STC wire format (per Sattler et al.): nnz * (4-byte index + 1 sign
    bit) + one float mean.  Elementwise on an integer array of counts."""
    return nnz * 4 + (nnz + 7) // 8 + 4


def payload_bytes(tree: PyTree) -> int:
    """Wire size of a (possibly compressed) update: STC by
    :func:`stc_leaf_bytes`, int8 one byte an element plus the scale, dense
    leaves their dtype's bytes."""
    return payload_bytes_many([tree])[0]


def payload_bytes_many(trees) -> list:
    """:func:`payload_bytes` of many updates, with every STC ``nnz`` of
    every tree fetched in ONE device-to-host transfer."""
    totals, pending, pending_at = [], [], []
    for ti, tree in enumerate(trees):
        total = 0
        for leaf in tree_leaves(tree):
            if isinstance(leaf, CompressedTensor):
                if leaf.kind == "stc":
                    pending.append(leaf.nnz.reshape(()))
                    pending_at.append(ti)
                elif leaf.kind == "int8":
                    total += leaf.data.numel() + 4
                else:
                    total += array_nbytes(leaf.data)
            else:
                total += array_nbytes(leaf)
        totals.append(total)
    if pending:
        for ti, nnz in zip(pending_at, torch.stack(pending).cpu().tolist()):
            totals[ti] += stc_leaf_bytes(int(nnz))
    return totals


# ---------------------------------------------------------------------------
# Error feedback (residual accumulation) for biased compressors
# ---------------------------------------------------------------------------


def compress_with_feedback(update: PyTree, residual: PyTree, method: str,
                           stc_sparsity: float) -> Tuple[PyTree, PyTree]:
    """Returns (compressed(update + residual), new_residual)."""
    if method in ("none", "", None):
        return update, residual
    leaves, treedef = tree_flatten(
        tree_map(lambda u, r: u + r, update, residual))
    pairs = [_compress_leaf(x, method, stc_sparsity) for x in leaves]
    return (tree_unflatten(treedef, [c for c, _ in pairs]),
            tree_unflatten(treedef, [x - sent for x, (_, sent)
                                     in zip(leaves, pairs)]))


def zero_residual(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)

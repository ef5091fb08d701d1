"""Update-compression stage helpers shared by the batched engine.

The batched round program compresses in-program with the CUDA kernels
(``repro_torch.kernels.stc_topk`` / ``quant``); this module keeps what the
round pipeline shares with the (not yet ported, ROADMAP M4) per-client
compression stage: the dense-leaf threshold, the STC wire format, and the
``"none"`` compress/decompress pair that ``Server.distribution`` and
``Client.decompression`` call.
"""
from __future__ import annotations

from typing import Any

from repro_torch.utils.tree import tree_leaves

PyTree = Any

# Tensors smaller than this stay dense through every compressor — the
# batched in-program path and the wire accounting must agree on which
# leaves compress.
DENSE_MIN_ELEMS = 64


def compress(tree: PyTree, method: str = "none",
             stc_sparsity: float = 0.01) -> PyTree:
    if method in ("none", "", None):
        return tree
    raise NotImplementedError(
        f"the per-client compression stage ({method!r}) is not ported to "
        f"repro_torch yet (ROADMAP M4); the batched round compresses "
        f"client updates in-program")


def decompress(tree: PyTree) -> PyTree:
    """Dense trees pass through unchanged (no compressed leaves exist in
    the ported slice)."""
    return tree


def stc_leaf_bytes(nnz):
    """STC wire format (per Sattler et al.): nnz * (4-byte index + 1 sign
    bit) + one float mean.  Elementwise on an integer array of counts."""
    return nnz * 4 + (nnz + 7) // 8 + 4


def payload_bytes(tree: PyTree) -> int:
    """Wire size of a dense update: each leaf's element count times its
    dtype's item size."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))

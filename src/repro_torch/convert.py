"""Carry weights between the reference package and the port as numpy.

Shapes and layouts are kept exactly (conv weights stay HWIO), so a tree
of numpy arrays taken from the reference loads unchanged — including a
transformer's (``"segments"``: a list of dicts of layer-stacked leaves) and
a LoRA adapter tree (``{"segments/0/attn/wq": {"a": ..., "b": ...}}``) and
a decode cache (``{"segments": [{"k": ..., "v": ...}]}``, RWKV6's
``{"att_x", "ffn_x", "wkv"}``).  bfloat16 arrays (numpy's ``ml_dtypes``
type, which ``torch.tensor`` does not take) carry over by their bits.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def params_from_jax(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Nested dict of numpy arrays -> the same tree of tensors on
    ``device`` (default: :func:`repro_torch.get_device`)."""
    if device is None:
        from repro_torch.kernels.ops import get_device
        device = get_device()
    return tree_map(lambda a: _tensor(np.asarray(a), device), tree)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def params_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> the same tree of host numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)

"""FedReID-style application client (paper §VIII-H case study).

FedReID [Zhuang et al., ACMMM'20] federates person re-identification over
heterogeneous datasets and changes the *aggregation* and *train* stages
(Table VII).  The client below models its platform-relevant property: a
client-local identity-classifier head that stays out of aggregation.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.client import Client


def _zero_under(tree: Any, keys, inside: bool = False) -> Any:
    """``tree`` with every leaf under a dict key in ``keys`` zeroed."""
    if isinstance(tree, dict):
        return {k: _zero_under(v, keys, inside or k in keys)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zero_under(v, keys, inside) for v in tree)
    return torch.zeros_like(tree) if inside else tree


class FedReIDClient(Client):
    """Train-stage override: keep a client-local head out of aggregation.

    The last dense layer (``"fc"`` or ``"fc2"`` in the small-model zoo) is
    the local identity classifier: its update is zeroed before upload, so
    aggregation merges only the shared backbone."""

    LOCAL_KEYS = ("fc", "fc2")

    def train(self, params: Any, round_id: int) -> Dict[str, Any]:
        result = super().train(params, round_id)
        result["update"] = _zero_under(result["update"], self.LOCAL_KEYS)
        return result

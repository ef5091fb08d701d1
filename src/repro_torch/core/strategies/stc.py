"""Sparse Ternary Compression [Sattler et al., TNNLS'19] as a two-stage
plugin (paper §V-B).

STC changes the compression stages in *both* directions: clients sparsify
and ternarize their updates (with error feedback), the server sparsifies
the distributed global model.  Train, selection and aggregation are
untouched — a two-stage algorithm in the sense of Table VII.

Engine note: :class:`STCClient` *overrides* the compression stage, so the
batched engine cannot see inside it and takes the gathering path
(per-client updates through each client's own stages).  The built-in
``{"client": {"compression": "stc"}}`` is the same algorithm, error
feedback and wire accounting, compressed in-program by the batched STC
kernel (``BatchedExecutor.compress_stacked``) without gathering updates.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core import compression as comp
from repro_torch.core.client import Client
from repro_torch.core.server import Server


class STCClient(Client):
    """Upstream compression stage: top-p ternary with error feedback."""

    def compression(self, result: Dict[str, Any]) -> Dict[str, Any]:
        if self._residual is None:
            self._residual = comp.zero_residual(result["update"])
        compressed, self._residual = comp.compress_with_feedback(
            result["update"], self._residual, "stc", self.cfg.stc_sparsity)
        out = dict(result)
        out["update"] = compressed
        out["payload_bytes"] = comp.payload_bytes(compressed)
        return out


class STCServer(Server):
    """Downstream compression stage: the server sends sparse models too,
    with an error residual of its own (bidirectional STC)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._residual = None

    def compression(self, params: Any) -> Any:
        if self._residual is None:
            self._residual = comp.zero_residual(params)
        compressed, self._residual = comp.compress_with_feedback(
            params, self._residual, "stc", self.cfg.client.stc_sparsity)
        return compressed


def stc_config(base: dict | None = None, sparsity: float = 0.01) -> dict:
    cfg = dict(base or {})
    cfg.setdefault("client", {})["compression"] = "stc"
    cfg["client"]["stc_sparsity"] = sparsity
    return cfg

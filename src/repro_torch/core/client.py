"""FL client with the granular training-flow stages (paper Fig. 3, right).

Stage pipeline per round:
    download -> decompression -> train (E local epochs) -> compression
    -> encryption -> upload

Subclass and override any stage to implement a new algorithm (§V-B).  The
batched engine vectorizes ``train`` across the cohort and runs the built-in
compression in-program, so in this port a ``Client`` is the per-client
shell the engine reads (id, data, config, optimizer, batch size); the
per-client ``train`` and compression stages belong to the sequential
engine, which is not ported yet (ROADMAP M4) and raise.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core import compression as comp
from repro_torch.core.config import (
    ClientConfig, validate_finetune_config, validate_optimizer_hparams,
)
from repro_torch.core.local_train import evaluate
from repro_torch.data.fed_data import ClientData
from repro_torch.models.small import FLModel
from repro_torch.optim import get_optimizer


class Client:
    def __init__(self, client_id: str, model: FLModel, data: ClientData,
                 cfg: ClientConfig, batch_size: int = 64):
        self.client_id = client_id
        self.model = model
        self.data = data
        self.cfg = cfg
        self.batch_size = batch_size
        validate_optimizer_hparams(cfg, owner=f"client {str(client_id)!r}")
        validate_finetune_config(cfg, owner=f"client {str(client_id)!r}")
        self.optimizer = get_optimizer(cfg.optimizer, cfg.lr, cfg.momentum,
                                       cfg.weight_decay, cfg.nesterov,
                                       cfg.adam_b1, cfg.adam_b2, cfg.adam_eps)
        self._residual = None      # error-feedback state (sequential engine)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def download(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return payload

    def decompression(self, payload: Dict[str, Any]) -> Any:
        return comp.decompress(payload["params"])

    def train(self, params: Any, round_id: int) -> Dict[str, Any]:
        raise NotImplementedError(
            "per-client training (the sequential engine) is not ported to "
            "repro_torch yet (ROADMAP M4); use "
            "resources.execution='batched'")

    def test(self, params: Any) -> Dict[str, float]:
        return evaluate(self.model, params, self.data.x, self.data.y)

    def compression(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Built-in update compression.  The batched engine runs the
        built-in methods in-program and never calls this stage; the
        per-client stage with error feedback is ROADMAP M4."""
        method = self.cfg.compression
        if method in ("none", "", None):
            return result
        raise NotImplementedError(
            f"the per-client compression stage ({method!r}) is not ported "
            f"to repro_torch yet (ROADMAP M4)")

    def encryption(self, result: Dict[str, Any]) -> Dict[str, Any]:
        return result  # hook for secure aggregation / HE plugins

    def upload(self, result: Dict[str, Any]) -> Dict[str, Any]:
        return result

    # ------------------------------------------------------------------
    def run_round(self, payload: Dict[str, Any], round_id: int) -> Dict[str, Any]:
        msg = self.download(payload)
        params = self.decompression(msg)
        result = self.train(params, round_id)
        result = self.compression(result)
        result = self.encryption(result)
        result["client_id"] = self.client_id
        return self.upload(result)

    def _batch_size(self) -> int:
        return self.batch_size


def _stable_hash(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 % (2**31)
    return h

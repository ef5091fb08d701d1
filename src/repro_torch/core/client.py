"""FL client with the granular training-flow stages (paper Fig. 3, right).

Stage pipeline per round:
    download -> decompression -> train (E local epochs) -> compression
    -> encryption -> upload

Subclass and override any stage to implement a new algorithm (§V-B); the
sequential engine runs every stage of every client.  The batched engine
vectorizes ``train`` across the cohort and runs the built-in compression
in-program, reading only the client's id, data, config, optimizer and
batch size.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import torch

from repro_torch.core import compression as comp
from repro_torch.core.config import (
    ClientConfig, validate_finetune_config, validate_optimizer_hparams,
)
from repro_torch.core.local_train import evaluate, local_train
from repro_torch.data.fed_data import ClientData
from repro_torch.models.small import FLModel
from repro_torch.optim import get_optimizer
from repro_torch.utils.tree import tree_map


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
        self._residual = None      # error-feedback state for compression

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def download(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return payload

    def decompression(self, payload: Dict[str, Any]) -> Any:
        return comp.decompress(payload["params"])

    def train(self, params: Any, round_id: int) -> Dict[str, Any]:
        global_params = params
        t0 = time.perf_counter()
        new_params, metrics = local_train(
            self.model, params, self.data.x, self.data.y,
            epochs=self.cfg.local_epochs, batch_size=self._batch_size(),
            optimizer=self.optimizer, proximal_mu=self.cfg.proximal_mu,
            max_grad_norm=self.cfg.max_grad_norm,
            seed=round_id * 9973 + _stable_hash(self.client_id),
            global_params=global_params)
        train_time = time.perf_counter() - t0
        update = tree_map(
            lambda n, g: n.to(torch.float32) - g.to(torch.float32),
            new_params, global_params)
        return {"update": update, "num_samples": len(self.data),
                "metrics": metrics, "train_time": train_time}

    def test(self, params: Any) -> Dict[str, float]:
        return evaluate(self.model, params, self.data.x, self.data.y)

    def compression(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Built-in update compression with error feedback.  The batched
        engine runs the same stage in-program (the same kernels, and a
        device-resident residual store with the semantics of
        ``self._residual``) and never calls this method."""
        method = self.cfg.compression
        if method in ("none", "", None):
            return result
        if self._residual is None:
            self._residual = comp.zero_residual(result["update"])
        compressed, self._residual = comp.compress_with_feedback(
            result["update"], self._residual, method, self.cfg.stc_sparsity)
        out = dict(result)
        out["update"] = compressed
        out["payload_bytes"] = comp.payload_bytes(compressed)
        return out

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

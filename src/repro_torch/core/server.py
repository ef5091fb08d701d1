"""FL server with the granular training-flow stages (paper Fig. 3, left).

Stage pipeline per round:
    selection -> compression -> distribution -> (clients run) -> aggregation

The server is executor-agnostic: ``distribution`` hands payloads to an
executor and gets client results back; the *scheduling* concern lives in
``core/rounds.py``.  ``selection`` draws from a numpy ``RandomState`` seeded
like the reference's, so both packages select the same cohorts.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core.aggregation import get_aggregator
from repro_torch.core.config import Config
from repro_torch.core.local_train import evaluate
from repro_torch.models.small import FLModel


class Server:
    def __init__(self, model: FLModel, cfg: Config, test_data=None,
                 rng: Optional[np.random.RandomState] = None):
        self.model = model
        self.cfg = cfg
        self.test_data = test_data
        self.rng = rng or np.random.RandomState(cfg.seed)
        self.params = None  # set by runtime (init or checkpoint)
        self._test_on = None   # (key, x, y): test split cached on device

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def selection(self, client_ids: Sequence[str], round_id: int) -> List[str]:
        k = min(self.cfg.server.clients_per_round, len(client_ids))
        if hasattr(client_ids, "sample"):
            # lazy id spaces (virtual million-client populations) provide
            # O(k) uniform sampling
            return client_ids.sample(self.rng, k)
        return list(self.rng.choice(list(client_ids), size=k, replace=False))

    def compression(self, params: Any) -> Any:
        return comp.compress(params, self.cfg.server.compression,
                             self.cfg.client.stc_sparsity)

    def distribution(self, selected: List[str]) -> Dict[str, Any]:
        """Build the payload distributed to every selected client."""
        payload = {"params": self.compression(self.params)}
        payload["payload_bytes"] = comp.payload_bytes(payload["params"])
        return payload

    def aggregation(self, results: List[Dict[str, Any]]) -> None:
        updates = [comp.decompress(r["update"]) for r in results]
        counts = [r["num_samples"] for r in results]
        agg = get_aggregator(self.cfg.server.aggregation)
        kw = dict(use_kernel=self.cfg.resources.aggregation_kernel,
                  topology=self.cfg.resources.aggregation_topology,
                  fanout=self.cfg.resources.aggregation_fanout)
        # custom registered aggregators may not take server_lr; only pass
        # it when it actually deviates from the neutral default
        if self.cfg.server.server_lr != 1.0:
            kw["server_lr"] = self.cfg.server.server_lr
        self.params = agg(self.params, updates, counts, **kw)

    def apply_delta(self, delta: Any,
                    server_lr: Optional[float] = None) -> None:
        """Apply a pre-aggregated update delta.  ``server_lr`` defaults to
        the configured ``server.server_lr``."""
        from repro_torch.core.aggregation import apply_delta
        if server_lr is None:
            server_lr = self.cfg.server.server_lr
        self.params = apply_delta(self.params, delta, server_lr)

    def finalize(self) -> None:
        """End-of-training hook; buffered-aggregation servers (FedBuff)
        flush leftover updates here."""

    # ------------------------------------------------------------------
    # checkpointing (ROADMAP M6)
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Serializable server state: params + the selection RNG."""
        return {"params": self.params, "rng": self.rng.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.params = state["params"]
        self.rng.set_state(tuple(state["rng"]))

    # ------------------------------------------------------------------
    def test(self) -> Dict[str, float]:
        if self.test_data is None:
            return {}
        from repro_torch.utils.tree import tree_leaves
        device = tree_leaves(self.params)[0].device
        key = (device, id(self.test_data))
        if self._test_on is None or self._test_on[0] != key:
            # upload the held-out split once per device, not every round
            self._test_on = (key,
                             torch.as_tensor(self.test_data.x, device=device),
                             torch.as_tensor(self.test_data.y, device=device))
        return evaluate(self.model, self.params, self._test_on[1],
                        self._test_on[2],
                        batch_size=self.cfg.data.test_batch_size)

"""FedBuff buffered asynchronous aggregation [Nguyen et al., AISTATS'22],
an *aggregation-stage* plugin with staleness weighting.

The server applies an aggregate as soon as K client updates have arrived,
weighting each by 1/(1+staleness)^a (model versions elapsed since the
update's base model; ``resources.staleness_power``, 0.5 by default).

Two runtimes drive this server:

* **Round-synchronous** (``execution`` sequential / batched): results come
  per round, so staleness starts from the virtual clock — a client slower
  than the round's median arrives one round stale — and then ages:
  updates left in the buffer because fewer than K have accumulated carry
  over, their staleness incremented once per round held.  ``finalize()``
  (called after the last round) flushes what remains, so no update is
  dropped.
* **Event-loop asynchronous** (``execution="async"``): the event loop in
  ``repro_torch.core.async_engine`` owns the buffer and the exact
  model-version staleness of each completion, and calls
  :meth:`buffered_apply` with ``_staleness`` already set."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core.aggregation import (
    apply_delta, staleness_weighted_delta,
)
from repro_torch.core.server import Server
from repro_torch.kernels.ops import get_device
from repro_torch.utils.tree import tree_map


class FedBuffServer(Server):
    buffer_size = 5          # K: aggregate whenever >= K updates buffered

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._buffer: List[Dict[str, Any]] = []
        if self.cfg.resources.buffer_size > 0:
            self.buffer_size = self.cfg.resources.buffer_size

    def aggregation(self, results: List[Dict[str, Any]]) -> None:
        # age the carried-over updates first: one more round has elapsed
        # since their base model
        for r in self._buffer:
            r["_staleness"] += 1
        # staleness from the virtual clock: slower than the median = 1
        times = np.array([r.get("train_time", 0.0) for r in results])
        med = float(np.median(times)) if len(times) else 0.0
        for r in results:
            r["_staleness"] = 1 if r.get("train_time", 0.0) > med else 0
            self._buffer.append(r)
        while len(self._buffer) >= self.buffer_size:
            batch, self._buffer = (self._buffer[: self.buffer_size],
                                   self._buffer[self.buffer_size:])
            self._apply(batch)
        # sub-K leftovers stay buffered into the next round

    def finalize(self) -> None:
        """End-of-training flush: apply whatever is still buffered."""
        if self._buffer:
            self._apply(self._buffer)
            self._buffer = []

    def buffered_client_ids(self) -> List[str]:
        """Client ids with a buffered-but-unaggregated update (a guard
        rejection must never sit in the buffer; leftover carry across
        rounds stays inspectable)."""
        return [r["client_id"] for r in self._buffer if "client_id" in r]

    def state_dict(self) -> Dict[str, Any]:
        """Server state plus the leftover buffer, updates decompressed to
        dense (``_apply`` decompresses anyway, so a resumed flush is
        value-identical)."""
        state = super().state_dict()
        state["buffer"] = [
            {**r, "update": comp.decompress(r["update"])}
            for r in self._buffer]
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict`; a checkpoint's buffered updates
        (host arrays) go back to the device the trainer runs on."""
        super().load_state_dict(state)
        device = get_device()
        self._buffer = [
            {**r, "update": tree_map(
                lambda a: torch.as_tensor(np.asarray(a), device=device)
                if not isinstance(a, torch.Tensor) else a.to(device),
                r["update"])}
            for r in state.get("buffer", [])]

    def buffered_apply(self, batch: List[Dict[str, Any]]) -> None:
        """Apply one buffer of results, each carrying ``_staleness``: the
        entry point of the async event loop, which keeps its own buffer
        and the true model-version staleness."""
        self._apply(batch)

    def _apply(self, batch: List[Dict[str, Any]]) -> None:
        updates = [comp.decompress(r["update"]) for r in batch]
        delta = staleness_weighted_delta(
            updates, [r["num_samples"] for r in batch],
            np.asarray([r["_staleness"] for r in batch], np.float32),
            power=self.cfg.resources.staleness_power,
            use_kernel=self.cfg.resources.aggregation_kernel)
        self.params = apply_delta(self.params, delta,
                                  self.cfg.server.server_lr)

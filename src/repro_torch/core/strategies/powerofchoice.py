"""Power-of-Choice client selection [Cho et al., arXiv:2010.01243], a
*selection-stage* plugin.

Sample a candidate set of size d > C, then pick the C candidates with the
highest last-known local loss (a bias toward under-fit clients).  The
losses come from the aggregation stage's own results."""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.server import Server


class PowerOfChoiceServer(Server):
    CANDIDATE_FACTOR = 3     # d = factor * C

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._last_loss = {}

    def selection(self, client_ids: Sequence[str], round_id: int) -> List[str]:
        C = min(self.cfg.server.clients_per_round, len(client_ids))
        d = min(self.CANDIDATE_FACTOR * C, len(client_ids))
        if hasattr(client_ids, "sample"):   # lazy id space: O(d) draw
            candidates = client_ids.sample(self.rng, d)
        else:
            candidates = list(self.rng.choice(list(client_ids), size=d,
                                              replace=False))
        # rank by last observed local loss; unseen clients rank first
        candidates.sort(key=lambda c: -self._last_loss.get(c, float("inf")))
        return candidates[:C]

    def aggregation(self, results) -> None:
        for r in results:
            self._last_loss[r["client_id"]] = float(r["metrics"]["loss"])
        super().aggregation(results)

"""Tiered per-client row storage: bounded device LRU tier + host backing.

The batched engine keeps two kinds of per-client rows — the data pool's
padded x/y rows and the error-feedback (EF) residuals.  A federation
touches about one cohort of clients per round, so the device tier is
bounded and everything else costs host bytes, or nothing:

* **hot tier** — per-leaf ``(alloc, *shape)`` device tensors holding up to
  ``capacity`` client rows, managed LRU.  Cohort assembly gathers only the
  selected rows; inserts and evictions are one batched scatter / fetch per
  leaf.  Rows are updated in place.
* **warm tier** (``spill="host"``) — rows evicted from the device tier are
  fetched once into host numpy copies and reloaded bit-identically on the
  next gather.  This is the EF residual path: residuals are *state*.
* **recompute** (``spill="drop"``) — evicted rows are discarded because the
  owner rebuilds them from its source of truth (the data pool re-pads from
  ``client.data``).

The device tier never evicts a row the *current* cohort pins, so a cohort
larger than ``capacity`` grows the tier to the cohort size for that round
(device memory is ``max(capacity, cohort)`` rows).  Row slots are recycled
through a free list; allocation grows by power-of-two doubling.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _bucket(n: int, floor: int = 1) -> int:
    b = max(1, floor)
    while b < n:
        b *= 2
    return b


class TieredRowStore:
    """Bounded device-resident LRU cache of per-client rows over host spill.

    Args:
        capacity: device-tier bound (rows); cohorts larger than this pin
            the tier open for the round.
        spill: ``"host"`` keeps evicted rows as host numpy copies (reloaded
            bit-identically); ``"drop"`` discards them — the caller's
            ``make_row`` recomputes on the next appearance.
        device: where the hot tier lives.
        name: label for error messages.
    """

    def __init__(self, capacity: int, spill: str = "host",
                 device: Optional[torch.device] = None, name: str = "store"):
        if spill not in ("host", "drop"):
            raise ValueError(f"unknown spill policy {spill!r}; "
                             f"expected 'host' or 'drop'")
        if capacity < 1:
            raise ValueError(f"{name}: capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.spill = spill
        self.device = torch.device("cpu") if device is None else device
        self.name = name
        self.leaves: List[torch.Tensor] = []   # device (alloc, *shape)
        self.rows: Dict[str, int] = {}         # id -> hot-tier row
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._free: List[int] = []
        self._host: Dict[str, List[np.ndarray]] = {}   # spilled rows
        self.stats = {"inserts": 0, "evictions": 0, "spills": 0,
                      "reloads": 0, "recomputes": 0}

    @property
    def alloc(self) -> int:
        return self.leaves[0].shape[0] if self.leaves else 0

    # ------------------------------------------------------------------
    def _grow(self, need: int, cap_eff: int) -> None:
        """Grow hot-tier allocation to hold ``need`` rows (<= cap_eff)."""
        new_alloc = max(min(_bucket(need, 8), cap_eff), need)
        old = self.alloc
        if new_alloc <= old:
            return
        self.leaves = [
            torch.cat([leaf, leaf.new_zeros((new_alloc - old,)
                                            + tuple(leaf.shape[1:]))])
            for leaf in self.leaves]
        self._free.extend(range(old, new_alloc))

    def _evict(self, count: int, pinned: set) -> None:
        """Evict ``count`` least-recently-used rows not pinned this round;
        evicted rows leave the device in ONE batched fetch per leaf (host
        spill) or are forgotten (drop / recompute)."""
        victims = []
        for cid in self._lru:
            if cid not in pinned:
                victims.append(cid)
                if len(victims) == count:
                    break
        if len(victims) < count:
            raise RuntimeError(
                f"{self.name}: cannot evict {count} rows — "
                f"{len(self._lru)} resident, {len(pinned)} pinned")
        if self.spill == "host":
            idx = torch.as_tensor([self.rows[c] for c in victims],
                                  device=self.device)
            fetched = [leaf.index_select(0, idx).cpu().numpy()
                       for leaf in self.leaves]
            for i, cid in enumerate(victims):
                self._host[cid] = [np.array(f[i]) for f in fetched]
            self.stats["spills"] += len(victims)
        for cid in victims:
            self._free.append(self.rows.pop(cid))
            self._lru.pop(cid)
        self.stats["evictions"] += len(victims)

    # ------------------------------------------------------------------
    def ensure(self, ids: Sequence[str],
               make_row: Callable[[str], List[np.ndarray]]) -> np.ndarray:
        """Make every id hot-tier resident; return their row indices.

        Missing ids are filled from the warm tier (bit-identical reload)
        when spilled, else from ``make_row(cid)`` — a list of per-leaf row
        values.  Evicts LRU rows as needed; ids in ``ids`` are pinned.
        All inserts land in one batched scatter per leaf.
        """
        ids = list(ids)
        pinned = set(ids)
        missing = [c for c in ids if c not in self.rows]
        if missing:
            cap_eff = max(self.capacity, len(pinned))
            values: List[List[np.ndarray]] = []
            for cid in missing:
                if cid in self._host:
                    values.append(self._host.pop(cid))
                    self.stats["reloads"] += 1
                else:
                    values.append([np.asarray(v) for v in make_row(cid)])
                    self.stats["recomputes"] += 1
            if not self.leaves:
                self.leaves = [
                    torch.zeros((0,) + v.shape, device=self.device,
                                dtype=torch.from_numpy(
                                    np.zeros(0, v.dtype)).dtype)
                    for v in values[0]]
            over = len(self.rows) + len(missing) - cap_eff
            if over > 0:
                self._evict(over, pinned)
            if len(missing) > len(self._free):
                self._grow(len(self.rows) + len(missing), cap_eff)
            slots = [self._free.pop() for _ in missing]
            sl = torch.as_tensor(slots, device=self.device)
            for li, leaf in enumerate(self.leaves):
                vals = np.stack([v[li] for v in values])
                leaf[sl] = torch.as_tensor(vals, device=self.device)
            for cid, slot in zip(missing, slots):
                self.rows[cid] = slot
            self.stats["inserts"] += len(missing)
        for cid in ids:                # refresh recency, newest last
            self._lru.pop(cid, None)
            self._lru[cid] = None
        return np.asarray([self.rows[c] for c in ids], np.int64)

    # ------------------------------------------------------------------
    def gather(self, ids: Sequence[str],
               make_row: Callable[[str], List[np.ndarray]]) -> List[Any]:
        """Device-side row gather of ``ids`` (ensuring residency first).

        Returns one ``(len(ids), *shape)`` device tensor per leaf."""
        rows = self.ensure(ids, make_row)
        idx = torch.as_tensor(rows, device=self.device)
        return [leaf.index_select(0, idx) for leaf in self.leaves]

    # ------------------------------------------------------------------
    def pad_dim1(self, new_size: int) -> None:
        """Grow every leaf's axis 1 (the sample dim of pooled data rows),
        zero-padding device leaves and spilled host rows alike."""
        if not self.leaves:
            return
        self.leaves = [
            F.pad(leaf, (0, 0) * (leaf.dim() - 2)
                  + (0, new_size - leaf.shape[1]))
            for leaf in self.leaves]
        for cid, rows in self._host.items():
            self._host[cid] = [
                np.pad(r, ((0, new_size - r.shape[0]),)
                       + ((0, 0),) * (r.ndim - 1)) for r in rows]

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
  fetched once into host tensors (pinned when the tier is on a CUDA
  device) and reloaded bit-identically on the next gather, with one
  ``non_blocking`` copy per leaf.  This is the EF residual path: residuals
  are *state*.
* **recompute** (``spill="drop"``) — evicted rows are discarded because the
  owner rebuilds them from its source of truth (the data pool re-pads from
  ``client.data``).

The device tier never evicts a row the *current* cohort pins, so a cohort
larger than ``capacity`` grows the tier to the cohort size for that round
(device memory is ``max(capacity, cohort)`` rows).  Row slots are recycled
through a free list; allocation grows by power-of-two doubling.

New rows come from one of two sources: ``make_row(cid)``, per-leaf host
rows (the data pool, whose rows are real data), or, without it, zeros of
``zero_shapes`` built on the device (the EF store: a new client's residual
is zero, so nothing crosses from the host).  Either way every insert of a
call lands in one ``index_copy_`` per leaf.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
        spill: ``"host"`` keeps evicted rows as host copies (reloaded
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
        self._host: Dict[str, List[torch.Tensor]] = {}   # spilled rows
        self._pin = self.device.type == "cuda"
        self.stats = {"inserts": 0, "evictions": 0, "spills": 0,
                      "reloads": 0, "recomputes": 0}

    def __contains__(self, cid: str) -> bool:
        return cid in self.rows or cid in self._host

    def __len__(self) -> int:
        return len(self.rows) + len(self._host)

    @property
    def alloc(self) -> int:
        return self.leaves[0].shape[0] if self.leaves else 0

    def spilled_ids(self):
        return self._host.keys()

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
            fetched = []
            for leaf in self.leaves:
                rows = leaf.index_select(0, idx)
                host = torch.empty(rows.shape, dtype=rows.dtype,
                                   pin_memory=self._pin)
                fetched.append(host.copy_(rows))
            # each client keeps views of the batch's pinned buffers
            for i, cid in enumerate(victims):
                self._host[cid] = [f[i] for f in fetched]
            self.stats["spills"] += len(victims)
        for cid in victims:
            self._free.append(self.rows.pop(cid))
            self._lru.pop(cid)
        self.stats["evictions"] += len(victims)

    # ------------------------------------------------------------------
    def ensure(self, ids: Sequence[str],
               make_row: Optional[Callable[[str], List[np.ndarray]]] = None,
               zero_shapes: Optional[Sequence[Tuple[int, ...]]] = None
               ) -> np.ndarray:
        """Make every id hot-tier resident; return their row indices.

        Missing ids are filled from the warm tier (bit-identical reload, one
        ``non_blocking`` copy per leaf from pinned memory) when spilled,
        else from ``make_row(cid)`` — a list of per-leaf host rows — or,
        with ``make_row`` None, as f32 zeros of ``zero_shapes`` (one shape
        per leaf) made on the device.  Evicts LRU rows as needed; ids in
        ``ids`` are pinned.  All inserts land in one ``index_copy_`` per
        leaf.
        """
        ids = list(ids)
        pinned = set(ids)
        missing = [c for c in ids if c not in self.rows]
        if missing:
            cap_eff = max(self.capacity, len(pinned))
            reloaded = [c for c in missing if c in self._host]
            fresh = [c for c in missing if c not in self._host]
            host_rows = {c: self._host.pop(c) for c in reloaded}
            made = ({c: [np.asarray(v) for v in make_row(c)] for c in fresh}
                    if make_row is not None else {})
            self.stats["reloads"] += len(reloaded)
            self.stats["recomputes"] += len(fresh)
            if not self.leaves:
                self.leaves = self._empty_leaves(made, zero_shapes)
            over = len(self.rows) + len(missing) - cap_eff
            if over > 0:
                self._evict(over, pinned)
            if len(missing) > len(self._free):
                self._grow(len(self.rows) + len(missing), cap_eff)
            slots = [self._free.pop() for _ in missing]
            sl = torch.as_tensor(slots, device=self.device)
            for li, leaf in enumerate(self.leaves):
                leaf.index_copy_(0, sl, self._new_rows(
                    li, leaf, missing, reloaded, host_rows, fresh, made))
            for cid, slot in zip(missing, slots):
                self.rows[cid] = slot
            self.stats["inserts"] += len(missing)
        for cid in ids:                # refresh recency, newest last
            self._lru.pop(cid, None)
            self._lru[cid] = None
        return np.asarray([self.rows[c] for c in ids], np.int64)

    def _empty_leaves(self, made, zero_shapes):
        """(0, *shape) device leaves shaped like the first row to insert."""
        if made:
            rows = next(iter(made.values()))
            return [torch.zeros((0,) + v.shape, device=self.device,
                                dtype=torch.from_numpy(v[:0]).dtype)
                    for v in rows]
        if zero_shapes is None:
            raise ValueError(f"{self.name}: new rows need make_row or "
                             f"zero_shapes")
        return [torch.zeros((0,) + tuple(shape), dtype=torch.float32,
                            device=self.device) for shape in zero_shapes]

    def _new_rows(self, li, leaf, missing, reloaded, host_rows, fresh, made):
        """Leaf ``li``'s (len(missing), *shape) values in ``missing`` order:
        device zeros, with reloaded and made rows copied in."""
        vals = leaf.new_zeros((len(missing),) + tuple(leaf.shape[1:]))
        pos = {c: i for i, c in enumerate(missing)}
        if reloaded:
            rows = [host_rows[c][li] for c in reloaded]
            buf = torch.empty((len(rows),) + tuple(rows[0].shape),
                              dtype=rows[0].dtype, pin_memory=self._pin)
            torch.stack(rows, out=buf)
            vals.index_copy_(0, torch.as_tensor([pos[c] for c in reloaded],
                                                device=self.device),
                             buf.to(self.device, non_blocking=True))
        if made:
            vals.index_copy_(0, torch.as_tensor([pos[c] for c in fresh],
                                                device=self.device),
                             torch.as_tensor(np.stack([made[c][li]
                                                       for c in fresh]),
                                             device=self.device))
        return vals

    # ------------------------------------------------------------------
    def gather(self, ids: Sequence[str],
               make_row: Optional[Callable[[str], List[np.ndarray]]] = None,
               zero_shapes: Optional[Sequence[Tuple[int, ...]]] = None
               ) -> List[torch.Tensor]:
        """Device-side row gather of ``ids`` (ensuring residency first, as
        :meth:`ensure`).  Returns one ``(len(ids), *shape)`` device tensor
        per leaf."""
        rows = self.ensure(ids, make_row, zero_shapes)
        idx = torch.as_tensor(rows, device=self.device)
        return [leaf.index_select(0, idx) for leaf in self.leaves]

    def scatter(self, ids: Sequence[str],
                leaves: Sequence[torch.Tensor]) -> None:
        """Write per-leaf ``(len(ids), *shape)`` values to the ids' hot rows
        in place.  Ids must be resident (callers scatter right after a
        gather)."""
        idx = torch.as_tensor([self.rows[c] for c in ids], device=self.device)
        for m, vals in zip(self.leaves, leaves):
            m.index_copy_(0, idx, vals.to(m.dtype))

    def drop(self, cid: str) -> None:
        """Forget one client's rows in every tier (data invalidation)."""
        if cid in self.rows:
            self._free.append(self.rows.pop(cid))
            self._lru.pop(cid, None)
        self._host.pop(cid, None)

    def reset(self) -> None:
        """Drop every tier."""
        self.leaves = []
        self.rows = {}
        self._lru = OrderedDict()
        self._free = []
        self._host = {}

    # ------------------------------------------------------------------
    def state(self) -> Dict[str, Dict[str, List[torch.Tensor]]]:
        """Checkpoint snapshot: every client's rows from BOTH tiers, as host
        tensors.  Hot rows leave the device in one batched fetch per leaf
        (each client keeps views of it); spilled rows are already on the
        host.  The snapshot is tier-agnostic: restored onto a device tier of
        any size it gives the same values bit for bit."""
        out: Dict[str, List[torch.Tensor]] = {}
        if self.rows:
            cids = list(self.rows)
            idx = torch.as_tensor([self.rows[c] for c in cids],
                                  device=self.device)
            fetched = [leaf.index_select(0, idx).cpu() for leaf in self.leaves]
            for i, cid in enumerate(cids):
                out[cid] = [f[i] for f in fetched]
        for cid, rows in self._host.items():
            out[cid] = list(rows)         # host rows are never written
        return {"clients": out}

    def load_state(self, state: Dict[str, Dict[str, List]]) -> None:
        """Restore :meth:`state` (host tensors or numpy rows) into the warm
        tier: each row re-heats onto the device at its next gather."""
        self.reset()
        for cid, rows in state.get("clients", {}).items():
            self._host[str(cid)] = [
                r if isinstance(r, torch.Tensor) else torch.from_numpy(
                    np.asarray(r)) for r in rows]

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
                F.pad(r, (0, 0) * (r.dim() - 1) + (0, new_size - r.shape[0]))
                for r in rows]

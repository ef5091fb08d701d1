"""Greedy Allocation with Adaptive Profiling — paper Algorithm 1 (§VI).

Problem (Eq. 1): given M devices and N >= M selected clients with training
times t_i, partition clients into M groups minimizing the makespan
``max_g sum_{i in g} t_i``.  NP-hard (multiprocessor scheduling); the paper
uses Longest-Processing-Time greedy: sort clients by (estimated) time
descending, place each on the device with the smallest current load — the
classic 4/3-approximation [Graham 1969].

Training times are unknown up front.  *Adaptive profiling*: clients get the
default time ``t`` until they first train; after each round, profiled times
are recorded and the default is updated by a moving average
``t <- avg(times)*m + t*(1-m)`` (Algorithm 1 lines 26-27).

The allocator is executor-agnostic: a "device" is whatever the runtime maps
a group to (a GPU in the paper).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


@dataclass
class ClientProfile:
    time: float
    profiled: bool = False


@dataclass
class GreedyAda:
    num_devices: int
    default_time: float = 1.0
    momentum: float = 0.5          # m in Algorithm 1
    profiles: Dict[str, ClientProfile] = field(default_factory=dict)

    # ---- Algorithm 1 lines 3-13: allocation ---------------------------
    def allocate(self, client_ids: Sequence[str]) -> List[List[str]]:
        est = {c: self._estimate(c) for c in client_ids}
        order = sorted(client_ids, key=lambda c: -est[c])        # LPT sort
        groups: List[List[str]] = [[] for _ in range(self.num_devices)]
        loads = np.zeros(self.num_devices)
        for c in order:
            g = int(np.argmin(loads))        # device with smallest total time
            groups[g].append(c)
            loads[g] += est[c]
        return groups

    def makespan(self, groups: List[List[str]],
                 times: Dict[str, float]) -> float:
        return max((sum(times[c] for c in g) for g in groups), default=0.0)

    # ---- Algorithm 1 lines 16-29: adaptive profiling ------------------
    def update(self, measured: Dict[str, float]) -> None:
        """Record measured per-client times after a round; refresh default."""
        for cid, t in measured.items():
            self.profiles[cid] = ClientProfile(time=float(t), profiled=True)
        if measured:
            t_avg = float(np.mean(list(measured.values())))
            self.default_time = (t_avg * self.momentum
                                 + self.default_time * (1.0 - self.momentum))

    def _estimate(self, cid: str) -> float:
        prof = self.profiles.get(cid)
        if prof is not None and prof.profiled:
            return prof.time
        return self.default_time


# ---------------------------------------------------------------------------
# Baseline allocators (paper Fig. 5 comparisons)
# ---------------------------------------------------------------------------


def random_allocation(client_ids: Sequence[str], num_devices: int,
                      seed: int = 0) -> List[List[str]]:
    rng = np.random.RandomState(seed)
    order = rng.permutation(list(client_ids))
    return [list(g) for g in np.array_split(order, num_devices)]


def slowest_allocation(client_ids: Sequence[str], num_devices: int,
                       times: Dict[str, float]) -> List[List[str]]:
    """Adversarial baseline: ~N/M slowest clients packed on one device."""
    order = sorted(client_ids, key=lambda c: -times.get(c, 0.0))
    return [list(g) for g in np.array_split(order, num_devices)]


def one_per_device(client_ids: Sequence[str]) -> List[List[str]]:
    """Standalone-style: each client its own device (requires M >= N)."""
    return [[c] for c in client_ids]


def make_allocator(name: str, num_devices: int, default_time: float = 1.0,
                   momentum: float = 0.5):
    if name == "greedy_ada":
        return GreedyAda(num_devices, default_time, momentum)
    return name  # handled by the runtime (random/slowest/one_per_device)

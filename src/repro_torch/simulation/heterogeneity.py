"""System-heterogeneity simulation (paper §V-A, "lightweight and realistic").

Clients are assigned device classes whose relative training speeds follow
the spread of mobile-SoC training throughput in AI-Benchmark [37].  During a
round, a client's *simulated* training time is

    time = base_time(samples, batches) * speed_ratio(client) + net_latency

The paper implements this with wall-clock sleeps before upload; here we
keep a **virtual clock** (sleeping an accelerator wastes it and is
non-deterministic — DESIGN.md §2, assumption 2).  The virtual times feed the
straggler analysis (Fig. 6) and GreedyAda scheduling identically.

Besides device *speeds*, the simulator also samples per-client **optimizer
hyperparameters** (``cfg.hyperparam_choices`` — FLGo-style optimizer
heterogeneity): each listed ``ClientConfig`` field is drawn uniformly per
client from its choice set, deterministically in the client id and
``cfg.seed`` (an FNV-1a hash, not Python's process-randomized ``hash``), so
a federation resamples identically across runs and processes.  The sampled
overrides are applied by ``Trainer.client`` when a client is materialized;
every sampleable field is vectorized by the batched/async cohort program,
so heterogeneity never forces the sequential engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np

from repro_torch.core.config import (
    FaultConfig, SystemHeterogeneityConfig, validate_fault_config,
    validate_hyperparam_choices,
)


def _stable_hash(s: str) -> int:
    """FNV-1a — deterministic across processes (unlike ``hash``)."""
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 % (2**31)
    return h


@dataclass
class SystemHeterogeneity:
    cfg: SystemHeterogeneityConfig
    assignment: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        validate_hyperparam_choices(self.cfg.hyperparam_choices)

    def hyperparam_overrides(self, client_id: str) -> Dict[str, Any]:
        """Per-client ``ClientConfig`` overrides sampled from
        ``cfg.hyperparam_choices`` (empty dict when the knob is unset).

        Fields are sampled independently, each from its own choice set,
        with native Python types preserved (``nesterov`` stays a bool)."""
        choices = self.cfg.hyperparam_choices
        if not choices:
            return {}
        rng = np.random.RandomState(
            (_stable_hash(client_id) ^ (self.cfg.seed * 2654435761)) % (2**31))
        return {name: choices[name][int(rng.randint(len(choices[name])))]
                for name in sorted(choices)}

    def speed_ratio(self, client_id: str) -> float:
        """Deterministic per-client device-class speed.

        Stateless by construction — the ratio is a pure function of
        ``(client_id, cfg.seed)`` via FNV-1a, so million-client populations
        cost O(1) memory here: nothing is cached, and cold clients never
        allocate a row.  ``assignment`` is consulted *first* as an explicit
        override map (tests and checkpoints may pin specific clients) but
        computed values are never written back into it."""
        if not self.cfg.enabled:
            return 1.0
        if client_id in self.assignment:
            return self.assignment[client_id]
        rng = np.random.RandomState(
            (_stable_hash(client_id) ^ (self.cfg.seed * 2654435761))
            % (2**31))
        return float(rng.choice(self.cfg.speed_ratios))

    def simulate_time(self, client_id: str, base_time: float) -> float:
        """Virtual wall-clock for one client's local round."""
        return base_time * self.speed_ratio(client_id) + self.cfg.network_latency

    def round_times(self, base_times: Dict[str, float]) -> Dict[str, float]:
        return {c: self.simulate_time(c, t) for c, t in base_times.items()}


# ---------------------------------------------------------------------------
# Client-failure injection (FLGo-style unreliability)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultPlan:
    """One client's sampled faults for one round (all-False = healthy)."""

    dropout: bool = False        # never responds this round
    crash: bool = False          # dies mid-training; partial time elapses
    crash_fraction: float = 1.0  # fraction of the round trained before dying
    straggler: bool = False      # slowed by cfg.straggler_slowdown
    nan_update: bool = False     # uploads a corrupted (non-finite) update

    @property
    def fails(self) -> bool:
        """True when no (valid or invalid) update can arrive at all."""
        return self.dropout or self.crash


NO_FAULT = FaultPlan()


@dataclass
class FaultInjector:
    """Deterministic per-(client, round) fault sampling.

    Stateless by construction: each draw seeds an ``np.random.RandomState``
    from an FNV-1a hash of ``(client_id, round_id, cfg.seed)`` (process-
    stable, unlike ``hash``), so fault schedules replay identically across
    runs, engines, and checkpoint/resume boundaries without any sampler
    state to persist.  Draws use a fixed order/count so individual
    probabilities stay independent knobs.  Dropout shadows crash shadows
    NaN-injection (a client that never responds cannot also upload
    garbage); stragglers compose with any of them."""

    cfg: FaultConfig

    def __post_init__(self):
        validate_fault_config(self.cfg)

    def plan(self, client_id: str, round_id: int) -> FaultPlan:
        f = self.cfg
        if not f.active:
            return NO_FAULT
        rng = np.random.RandomState(
            (_stable_hash(f"{client_id}|round{int(round_id)}")
             ^ (f.seed * 2654435761)) % (2**31))
        u = rng.random_sample(5)
        dropout = bool(u[0] < f.dropout_prob)
        crash = bool(not dropout and u[1] < f.crash_prob)
        straggler = bool(u[2] < f.straggler_prob)
        nan_update = bool(not dropout and not crash
                          and u[3] < f.nan_update_prob)
        return FaultPlan(dropout=dropout, crash=crash,
                         crash_fraction=float(u[4]), straggler=straggler,
                         nan_update=nan_update)


def straggler_stats(times: Dict[str, float]) -> Dict[str, float]:
    v = np.array(list(times.values()))
    return {
        "min": float(v.min()),
        "max": float(v.max()),
        "mean": float(v.mean()),
        "std": float(v.std()),
        "max_over_min": float(v.max() / max(v.min(), 1e-9)),
    }

"""Asynchronous overlapping-cohort execution (FedBuff) on the batched engine.

Synchronous rounds are a barrier: every selected client must finish before
the server aggregates, so the round's virtual duration is gated by its
slowest client.  This engine removes the barrier with a **discrete-event
simulation** over the virtual clock:

* Up to ``resources.max_concurrency`` clients are *in flight* at once.
  Each dispatched client receives the current global model and a
  heterogeneity-derived finish time ``now + speed_ratio * base_time``
  (``SystemHeterogeneity.simulate_time``).  Base time is the client's
  local step count times a calibrated **per-step cost**: the running
  minimum of ``wave wall / wave steps`` over all waves so far, frozen per
  event so that simultaneous waves stay tied.  A wave's wall is
  ``st["wall"]`` of :meth:`BatchedExecutor.run_cohort_stacked` (the
  blocking training time), not each wave's own cost, which would charge a
  size-1 replacement wave's whole dispatch overhead to one client.
* The event loop pops completions in finish-time order; every completion
  frees a slot that is refilled at once with replacement clients carrying
  the *current* (possibly newer) model.
* The server aggregates every buffer of ``K = resources.buffer_size``
  completions with staleness-discounted FedAvg weights
  (``w_i ∝ n_i / (1+s_i)^staleness_power``, FedBuff, Nguyen et al.,
  AISTATS'22), where ``s_i`` is the number of model versions that elapsed
  between update i's dispatch and its application.  The discount is a
  weight transform ahead of the same FedAvg (K1 under
  ``resources.aggregation_kernel``, or the hierarchical tree).

Each dispatch wave (the replacements freed by one event, or the initial
``max_concurrency`` cohort) runs through ``Trainer._run_batched`` as one
stacked micro-cohort.  Wave sizes are bucketed to powers of two inside the
executor, so the many size-1 replacement waves of a heterogeneous run
share one bucket.  Built-in ``client.compression`` (stc / int8) runs on the
stacked wave (K2, or K3a + K3b, with the executor's EF store keyed by
client id across waves), and the wave hands back each client's sent
update un-aggregated for the buffer.

Degenerate case: with ``K == max_concurrency == cohort size`` and uniform
client speeds, every wave completes at one virtual instant, every
staleness is 0 (``fold_staleness`` then reduces to plain FedAvg weights),
and replacement waves draw from the same selection RNG stream as
synchronous rounds, so the model trajectory matches the synchronous
batched path.

Bookkeeping: one history/tracking "round" per buffer aggregation, with
``round_time`` = virtual time since the previous aggregation,
``virtual_time`` = cumulative virtual clock, and per-client
``dispatch_time`` / ``finish_time`` / ``staleness`` in the tracker.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from repro_torch.core import compression as comp
from repro_torch.core.aggregation import (
    staleness_weighted_delta, weighted_train_loss,
)
from repro_torch.core.rounds import _poison_update, update_is_valid

__all__ = ["AsyncEngine", "InFlight"]

#: fault-accounting counters carried in the event-loop state and flushed
#: into each aggregation's metrics (cfg.faults)
FAULT_COUNTERS = ("dropped", "crashed", "straggled", "deadline_missed",
                  "rejected", "retried", "gave_up")


@dataclass(order=True)
class InFlight:
    """One dispatched-but-not-yet-aggregated client update.

    Heap-ordered by ``(finish_time, seq)``; ``seq`` is the global dispatch
    counter, so simultaneous completions pop in dispatch order and the
    degenerate uniform-speed case keeps the synchronous cohort order.

    ``kind``: ``"done"`` (a completion), ``"fail:dropped"`` /
    ``"fail:crashed"`` / ``"fail:deadline"`` (a non-completion, detected at
    ``finish_time``), or ``"retry"`` (a wake-up at a failed client's
    backoff expiry, so that ``_dispatch`` runs then)."""

    finish_time: float
    seq: int
    client_id: str = field(compare=False)
    dispatch_time: float = field(compare=False)
    version: int = field(compare=False)          # model version trained on
    result: Dict[str, Any] = field(compare=False)
    kind: str = field(compare=False, default="done")


class AsyncEngine:
    """Virtual-clock event loop driving overlapping cohorts.

    Built from a :class:`repro_torch.core.rounds.Trainer` (which owns the
    server, the :class:`repro_torch.core.batched.BatchedExecutor`, the
    heterogeneity simulator and the tracker); :meth:`run` executes the
    remaining ``cfg.server.rounds - len(trainer.history)`` buffer
    aggregations, appending each metrics dict to ``Trainer.history`` (so
    periodic checkpoints see them) and returning the new entries.  Starting
    the budget from ``len(history)`` is what lets :meth:`Trainer.resume`
    continue an async run: ``version == completed aggregations ==
    len(history)`` holds across a kill and restore.  Work in flight at the
    kill is lost and dispatched anew, so async resume is value-correct,
    not bit-identical."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.cfg = trainer.cfg
        self.server = trainer.server
        self.het = trainer.het
        self.tracker = trainer.tracker
        res = self.cfg.resources
        default_k = getattr(type(self.server), "buffer_size", 0)
        self.K = (res.buffer_size or default_k
                  or self.cfg.server.clients_per_round)
        self.max_concurrency = (res.max_concurrency
                                or self.cfg.server.clients_per_round)
        self.staleness_power = res.staleness_power
        # resume: history already holds the completed aggregations
        self.completed0 = len(trainer.history)
        self.version = self.completed0   # global model version (aggregations)
        self.target = max(self.cfg.server.rounds - self.completed0, 0)
        self.faults = trainer.faults
        # fault accounting is on if anything can fail a dispatch
        self._faulty = (self.cfg.faults.active
                        or self.cfg.resources.round_deadline > 0)
        self._guard = self.cfg.faults.active
        self._per_step_cost = None       # running-min wall/steps over waves
        # The event loop aggregates itself (staleness-weighted FedBuff) and
        # never calls Server.aggregation: refuse a custom aggregation setup
        # rather than ignore it.
        if self.cfg.server.aggregation != "fedavg":
            from repro_torch.core.aggregation import get_aggregator
            get_aggregator(self.cfg.server.aggregation)  # typos: KeyError
            raise ValueError(
                f'resources.execution="async" aggregates with '
                f"staleness-weighted FedAvg (FedBuff); "
                f"server.aggregation={self.cfg.server.aggregation!r} is not "
                f"consulted — use execution='sequential' or 'batched'")
        from repro_torch.core.server import Server
        if type(self.server).aggregation is not Server.aggregation and \
                not hasattr(type(self.server), "buffered_apply"):
            raise ValueError(
                f"{type(self.server).__name__}.aggregation is bypassed by "
                f'resources.execution="async" (the event loop aggregates '
                f"every buffer of K completions); implement "
                f"buffered_apply(batch) (see FedBuffServer) or use a "
                f"synchronous execution mode")

    # ------------------------------------------------------------------
    def _dispatch(self, now: float, state: Dict[str, Any]) -> None:
        """Fill free slots with replacement clients at virtual time ``now``.

        Each iteration trains one wave (<= ``server.clients_per_round``
        clients, the selection stage's draw size) as one stacked
        micro-cohort through ``Trainer._run_batched``; it loops until the
        concurrency cap, the remaining completion budget or the pool of
        idle clients is exhausted."""
        server, trainer = self.server, self.trainer
        heap, in_flight = state["heap"], state["in_flight"]
        f = self.cfg.faults
        deadline = self.cfg.resources.round_deadline
        event_cost = self._per_step_cost   # one cost per event: waves tie
        while True:
            free = self.max_concurrency - len(in_flight)
            budget = (state["total_needed"] - state["completed"]
                      - len(in_flight))
            all_ids = state["all_ids"]
            if hasattr(all_ids, "sample"):
                # virtual population: an O(cohort) draw that excludes busy
                # and cooling clients, no O(population) availability scan
                state["cooldown"] = {c: t for c, t
                                     in state["cooldown"].items() if t > now}
                busy = set(in_flight)
                busy.update(state["cooldown"])
                m = min(free, budget, len(all_ids) - len(busy),
                        self.cfg.server.clients_per_round)
                if m <= 0:
                    return
                wave = state["wave_id"]
                selected = all_ids.sample(server.rng, m, exclude=busy)
            else:
                avail = [c for c in all_ids if c not in in_flight
                         and state["cooldown"].get(c, 0.0) <= now]
                m = min(free, budget, len(avail))
                if m <= 0:
                    return
                wave = state["wave_id"]
                selected = server.selection(avail, wave)[:m]
            if not selected:
                return
            payload = server.distribution(selected)
            state["down_bytes"] += (payload.get("payload_bytes", 0)
                                    * len(selected))
            # an async wave never takes the fused round (the event loop
            # owns aggregation): aggregated is False, finish None
            results, _, _ = trainer._run_batched(selected, payload, wave)
            state["wave_id"] += 1
            wall = sum(r["train_time"] for r in results)
            steps = sum(r["metrics"]["batches"] for r in results)
            cost = wall / max(steps, 1.0)
            self._per_step_cost = (cost if self._per_step_cost is None
                                   else min(self._per_step_cost, cost))
            if event_cost is None:
                event_cost = self._per_step_cost
            # one batched host sync for the wave's wire accounting (the
            # in-program compression stamped payload_bytes from its nnz)
            missing = [r for r in results if "payload_bytes" not in r]
            if missing:
                for r, pb in zip(missing, comp.payload_bytes_many(
                        [r["update"] for r in missing])):
                    r["payload_bytes"] = pb
            for res in results:
                cid = res["client_id"]
                plan = self.faults.plan(cid, wave) if f.active else None
                base = res["metrics"]["batches"] * event_cost
                if plan is not None and plan.straggler:
                    base *= f.straggler_slowdown
                    state["straggled"] += 1
                duration = self.het.simulate_time(cid, base)
                kind, finish = "done", now + duration
                if plan is not None and plan.dropout:
                    # never responds; detected at the response deadline
                    # when one is set, else when the reply was due
                    kind = "fail:dropped"
                    state["dropped"] += 1
                    if deadline > 0:
                        finish = now + min(duration, deadline)
                elif plan is not None and plan.crash:
                    kind = "fail:crashed"
                    state["crashed"] += 1
                    finish = now + duration * plan.crash_fraction
                elif deadline > 0 and duration > deadline:
                    # the reply would land after the server stops waiting
                    kind = "fail:deadline"
                    state["deadline_missed"] += 1
                    finish = now + deadline
                elif plan is not None and plan.nan_update:
                    res["update"] = _poison_update(res["update"])
                if kind == "done":
                    state["up_bytes"] += res["payload_bytes"]
                heapq.heappush(heap, InFlight(
                    finish_time=finish, seq=state["seq"],
                    client_id=cid, dispatch_time=now,
                    version=self.version, result=res, kind=kind))
                state["seq"] += 1
                in_flight.add(cid)

    # ------------------------------------------------------------------
    def _note_failure(self, e: InFlight, now: float,
                      state: Dict[str, Any]) -> None:
        """Bounded retry with exponential backoff after a failed dispatch.

        The failed client cools down for ``retry_backoff * 2**(attempt-1)``
        virtual seconds; a ``"retry"`` wake-up at the cooldown's end keeps
        the heap non-empty so that ``_dispatch`` runs then.  After
        ``max_retries`` failed attempts the server gives up on this episode
        and the attempt counter resets, so a later selection starts
        fresh."""
        f = self.cfg.faults
        state["failures"] += 1
        if state["failures"] > state["failure_cap"]:
            raise ValueError(
                f"async fault injection: {state['failures']} failed "
                f"dispatches against {state['completed']} completions — "
                f"failure rates this high cannot make progress; lower "
                f"faults.dropout_prob/crash_prob/nan_update_prob or raise "
                f"resources.round_deadline")
        attempt = state["attempts"].get(e.client_id, 0) + 1
        state["attempts"][e.client_id] = attempt
        if attempt <= f.max_retries:
            delay = f.retry_backoff * (2 ** (attempt - 1))
            state["cooldown"][e.client_id] = now + delay
            state["retried"] += 1
            heapq.heappush(state["heap"], InFlight(
                finish_time=now + delay, seq=state["seq"],
                client_id=e.client_id, dispatch_time=now,
                version=self.version, result={}, kind="retry"))
            state["seq"] += 1
        else:
            state["attempts"][e.client_id] = 0
            state["gave_up"] += 1

    # ------------------------------------------------------------------
    def _aggregate(self, batch: List[InFlight], now: float,
                   state: Dict[str, Any]) -> Dict[str, float]:
        """Apply one buffer of K completions; returns the round metrics."""
        staleness = np.asarray([self.version - e.version for e in batch],
                               np.float32)
        results = [e.result for e in batch]
        if hasattr(type(self.server), "buffered_apply"):
            # FedBuff-family servers own the weighted application
            for e, s in zip(batch, staleness):
                e.result["_staleness"] = float(s)  # flcheck: ignore[FLC102]  -- host np scalar
            self.server.buffered_apply(results)
        else:
            updates = [comp.decompress(r["update"]) for r in results]
            delta = staleness_weighted_delta(
                updates, [r["num_samples"] for r in results], staleness,
                power=self.staleness_power,
                use_kernel=self.cfg.resources.aggregation_kernel,
                topology=self.cfg.resources.aggregation_topology,
                fanout=self.cfg.resources.aggregation_fanout)
            self.server.apply_delta(delta)
        self.version += 1

        agg_id = self.version - 1
        wall = time.perf_counter() - state["t_wall"]
        state["t_wall"] = time.perf_counter()
        metrics = {
            "round_time": now - state["last_agg_time"],
            "virtual_time": now,
            "wall_time": wall,
            "clients": len(batch),
            "comm_down_bytes": state["down_bytes"],
            "comm_up_bytes": state["up_bytes"],
            "train_loss": weighted_train_loss(results),
            "staleness_mean": float(staleness.mean()),
            "staleness_max": float(staleness.max()),
            "in_flight": len(state["in_flight"]),
        }
        state["last_agg_time"] = now
        state["down_bytes"] = 0
        state["up_bytes"] = 0
        if self._faulty:
            # flush the window's fault counters into this aggregation's
            # metrics (faults off: no extra keys)
            for k in FAULT_COUNTERS:
                metrics[k] = state[k]
                state[k] = 0
        if self.cfg.server.test_every and \
           (agg_id + 1) % self.cfg.server.test_every == 0:
            metrics.update(self.server.test())
        if self.cfg.tracking.enabled:
            self.tracker.track_round(self.cfg.task_id, agg_id, **metrics)
            for e, s in zip(batch, staleness):
                self.tracker.track_client(
                    self.cfg.task_id, agg_id, e.client_id,
                    train_time=e.result["train_time"],
                    simulated_time=e.finish_time - e.dispatch_time,
                    dispatch_time=e.dispatch_time,
                    finish_time=e.finish_time,
                    staleness=float(s),  # flcheck: ignore[FLC102]  -- host np scalar
                    **e.result["metrics"])
        return metrics

    # ------------------------------------------------------------------
    def _finish_round(self, metrics: Dict[str, float],
                      history: List[Dict[str, float]]) -> None:
        """Record one aggregation in the engine's history and
        ``Trainer.history`` and run the checkpoint hook (``self.version``
        equals the completed aggregations after ``_aggregate``)."""
        history.append(metrics)
        self.trainer.history.append(metrics)
        self.trainer._maybe_checkpoint(self.version)

    # ------------------------------------------------------------------
    def run(self) -> List[Dict[str, float]]:
        """Run the remaining buffer aggregations; returns the new entries.

        The completion budget drains exactly: ``target * K`` successful
        completions are dispatched in total and no trained update is
        discarded.  If the client pool is too small to fill a buffer (the
        loop starves), the partial buffer is flushed at the end.  Failed
        dispatches (dropout, crash, deadline, guard rejection) are
        non-completions: their slot frees on detection and the budget
        grows back, so replacements dispatch until the target is met or
        the failure cap trips."""
        target = self.target
        # lazy id spaces (virtual populations) stay lazy: the dispatch
        # loop samples them in O(cohort)
        ids = self.trainer.fed_data.client_ids
        state: Dict[str, Any] = {
            "heap": [], "in_flight": set(),
            "all_ids": ids if hasattr(ids, "sample") else list(ids),
            "seq": 0, "wave_id": 0, "completed": 0,
            "total_needed": target * self.K,
            "down_bytes": 0, "up_bytes": 0,
            "last_agg_time": 0.0, "t_wall": time.perf_counter(),
            "cooldown": {}, "attempts": {}, "failures": 0,
            "failure_cap": 100 + 10 * max(target * self.K, 1),
        }
        state.update({k: 0 for k in FAULT_COUNTERS})
        heap = state["heap"]
        buffer: List[InFlight] = []
        history: List[Dict[str, float]] = []
        now = 0.0

        self._dispatch(0.0, state)
        while len(history) < target and heap:
            # pop the earliest completion and every tie (the whole wave in
            # the uniform-speed case), so aggregation happens before their
            # replacements dispatch
            entry = heapq.heappop(heap)
            ties = [entry]
            while heap and heap[0].finish_time == entry.finish_time:
                ties.append(heapq.heappop(heap))
            now = entry.finish_time
            for e in ties:
                state["in_flight"].discard(e.client_id)
                if e.kind == "retry":
                    continue   # cooldown expiry wake-up; dispatch below
                if e.kind != "done":
                    self._note_failure(e, now, state)
                    continue
                if self._guard and not update_is_valid(
                        e.result["update"], self.cfg.faults.max_update_norm):
                    # a corrupted upload never enters the buffer (a buffered
                    # copy plus a re-dispatch would count the client twice)
                    state["rejected"] += 1
                    self._note_failure(e, now, state)
                    continue
                state["attempts"].pop(e.client_id, None)
                state["completed"] += 1
                buffer.append(e)
            while len(buffer) >= self.K and len(history) < target:
                batch, buffer = buffer[: self.K], buffer[self.K:]
                self._finish_round(self._aggregate(batch, now, state),
                                   history)
            self._dispatch(now, state)
        if buffer and len(history) < target:
            self._finish_round(self._aggregate(buffer, now, state), history)
        return history

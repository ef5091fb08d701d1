"""Round orchestration: the runtime behind ``repro_torch.run()``.

Combines the platform modules per the FL life cycle (§III): simulation
manager (heterogeneity) + data manager + server/client stages +
distribution manager (GreedyAda, §VI) + tracking manager (§V-C).

Timing model: each client's measured local-training time is recorded; the
system-heterogeneity simulator scales it by the client's device-class
speed ratio (virtual clock).  The round's virtual duration is the makespan
of the device groups, Eq. 1:

    T_round = max_g  sum_{c in g} simulated_time(c)

Two engines are ported.  ``resources.execution="sequential"`` (the
default) runs every stage of every selected client in turn — each stage
overridable — then ``Server.aggregation``.  ``"batched"`` with
``round_fusion="auto"`` runs the fused round program
(``core/batched.py``).  Both run flat aggregation, no faults or deadlines,
synchronous rounds; LoRA runs under ``batched``.  Every configuration
outside that raises ``NotImplementedError`` naming the ROADMAP item that
ports it — at construction, never as a silent detour.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core.aggregation import weighted_train_loss
from repro_torch.core.batched import BatchedExecutor
from repro_torch.core.client import Client
from repro_torch.core.config import Config, validate_config
from repro_torch.core.server import Server
from repro_torch.data.fed_data import FederatedDataset
from repro_torch.kernels.ops import get_device
from repro_torch.sched.greedyada import (
    GreedyAda, one_per_device, random_allocation, slowest_allocation,
)
from repro_torch.simulation.heterogeneity import (
    FaultInjector, SystemHeterogeneity,
)
from repro_torch.tracking import Tracker
from repro_torch.utils.tree import tree_leaves


def dense_update_bytes(params) -> int:
    """Wire size of one dense (uncompressed) update of ``params``' shape,
    from each leaf's own item size."""
    return sum(comp.array_nbytes(leaf) for leaf in tree_leaves(params))


def unported_config(cfg: Config) -> List[str]:
    """Every setting of ``cfg`` outside the ported engines, each with the
    ROADMAP item that ports it (empty when they cover ``cfg``)."""
    res = cfg.resources
    batched = res.execution == "batched"
    out = []
    if res.execution == "async":
        out.append("resources.execution='async' (ROADMAP M7)")
    if res.execution == "sequential" and cfg.client.finetune == "lora":
        out.append("client.finetune='lora' under resources.execution="
                   "'sequential' (ROADMAP M8)")
    if batched and res.round_fusion != "auto":
        out.append(f"resources.round_fusion={res.round_fusion!r}, the staged "
                   f"batched path (ROADMAP M5)")
    if batched and res.distributed != "none":
        out.append(f"resources.distributed={res.distributed!r} (ROADMAP M5)")
    if res.aggregation_topology != "flat":
        out.append(f"resources.aggregation_topology="
                   f"{res.aggregation_topology!r} (ROADMAP M5)")
    if cfg.faults.active:
        out.append("fault injection, cfg.faults (ROADMAP M6)")
    if res.round_deadline > 0:
        out.append("resources.round_deadline > 0 (ROADMAP M6)")
    if cfg.checkpoint.every:
        out.append("checkpointing, checkpoint.every > 0 (ROADMAP M6)")
    if not cfg.tracking.round_sync:
        out.append("tracking.round_sync=False (ROADMAP M5)")
    if cfg.server.aggregation == "fedbuff":
        out.append("server.aggregation='fedbuff', buffered asynchronous "
                   "aggregation (ROADMAP M7)")
    elif batched and cfg.server.aggregation != "fedavg":
        out.append(f"server.aggregation={cfg.server.aggregation!r} under "
                   f"resources.execution='batched', the gathering path "
                   f"(ROADMAP M5.4); execution='sequential' runs it")
    return out


class Trainer:
    def __init__(self, config: Config, model, fed_data: FederatedDataset,
                 tracker: Optional[Tracker] = None,
                 server: Optional[Server] = None,
                 client_cls=Client):
        self.cfg = config
        validate_config(config)
        for method in (config.client.compression, config.server.compression):
            if method not in ("none", "stc", "int8"):
                raise ValueError(f"unknown compression {method!r}")
        missing = unported_config(config)
        if missing:
            raise NotImplementedError(
                "not ported to repro_torch yet: " + "; ".join(missing))
        if config.resources.execution == "batched":
            if server is not None and (
                    type(server).aggregation is not Server.aggregation
                    or type(server).apply_delta is not Server.apply_delta):
                raise NotImplementedError(
                    "Server.aggregation / Server.apply_delta overrides under "
                    "resources.execution='batched' need the gathering and "
                    "staged paths (ROADMAP M5.4); the fused round applies "
                    "FedAvg in-program.  execution='sequential' runs them")
            for stage in ("compression", "encryption", "upload"):
                if getattr(client_cls, stage) is not getattr(Client, stage):
                    raise NotImplementedError(
                        f"a Client.{stage} override under resources."
                        f"execution='batched' needs the gathering path "
                        f"(ROADMAP M5.4); the fused round compresses "
                        f"in-program.  execution='sequential' runs it")
        self.device = get_device()
        if config.client.finetune == "lora":
            # Freeze the base model and train low-rank adapters only: the
            # wrapper is an FLModel whose param tree holds just the A/B
            # factors, so the round program, compression and byte
            # accounting below see adapters only.  The base is initialized
            # once from cfg.seed and closed over — one copy on the device,
            # shared by every client of the cohort.
            from repro_torch.models.lora import lora_wrap
            wrapped = lora_wrap(
                model, model.init(torch.Generator().manual_seed(config.seed),
                                  self.device),
                config.client.lora_rank, config.client.lora_alpha,
                config.client.lora_targets)
            if not wrapped.defs:
                raise ValueError(
                    f"client.finetune='lora' with lora_targets="
                    f"{config.client.lora_targets!r} matched no eligible "
                    f"matrix leaves of model {model.name!r} (eligible: "
                    f">= 2 dims beyond a stacked 'layers' axis) — nothing "
                    f"to train")
            model = wrapped
            if server is not None:
                # a caller-built server was constructed around the base
                # model; evaluation must see the adapter model
                server.model = model
        self.model = model
        self.fed_data = fed_data
        self.tracker = tracker or Tracker(
            config.tracking.backend, config.tracking.out_dir,
            client_history_rounds=config.tracking.client_history_rounds)
        self.server = server or Server(model, config, fed_data.test)
        self.client_cls = client_cls
        self.clients: Dict[str, Client] = {}
        # inactive here (faults are outside the slice); constructed for the
        # same validation as the reference
        self.faults = FaultInjector(config.faults)
        # the sequential engine needs no data pool or EF store on the device
        self.engine = (BatchedExecutor(
            model, self.device, distributed=config.resources.distributed)
            if config.resources.execution == "batched" else None)
        self.het = SystemHeterogeneity(config.system_heterogeneity)
        self.scheduler = GreedyAda(
            num_devices=max(1, config.resources.num_devices),
            default_time=config.resources.default_client_time,
            momentum=config.resources.momentum)
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------
    # Materialized-Client cache bound: virtual populations grow the
    # touched-client set every round, so Client objects are evicted FIFO
    # past this bound — except clients carrying error-feedback residuals
    # (sequential compression), which are state, not recomputable.
    CLIENT_CACHE_MAX = 4096

    def client(self, cid: str) -> Client:
        if cid not in self.clients:
            if len(self.clients) >= self.CLIENT_CACHE_MAX:
                for old in [c for c, cl in self.clients.items()
                            if cl._residual is None][
                                : len(self.clients) - self.CLIENT_CACHE_MAX + 1]:
                    del self.clients[old]
            ccfg = self.cfg.client
            overrides = self.het.hyperparam_overrides(cid)
            if overrides:
                # per-client optimizer heterogeneity, sampled
                # deterministically from system_heterogeneity.
                # hyperparam_choices — vectorized by the cohort program
                ccfg = dataclasses.replace(ccfg, **overrides)
            self.clients[cid] = self.client_cls(
                cid, self.model, self.fed_data.clients[cid],
                ccfg, batch_size=self.cfg.data.batch_size)
        return self.clients[cid]

    def _allocate(self, selected: List[str], round_id: int) -> List[List[str]]:
        name = self.cfg.resources.allocation
        M = max(1, self.cfg.resources.num_devices)
        if name == "greedy_ada":
            return self.scheduler.allocate(selected)
        if name == "random":
            return random_allocation(selected, M, seed=round_id)
        if name == "slowest":
            est = {c: self.scheduler._estimate(c) for c in selected}
            return slowest_allocation(selected, M, est)
        if name == "one_per_device":
            return one_per_device(selected)
        raise ValueError(f"unknown allocation {name!r}")

    def _effective_time(self, cid: str, base: float) -> float:
        """Virtual response time (no fault plan: faults are ROADMAP M6)."""
        return self.het.simulate_time(cid, base)

    # ------------------------------------------------------------------
    def _run_batched(self, selected: List[str], payload: Dict[str, Any],
                     round_id: int) -> List[Dict[str, Any]]:
        """The fused round: ONE dispatch trains the cohort, compresses
        in-program with error feedback, aggregates and applies the server
        update; one batched device->host fetch returns metrics and
        per-leaf STC counts.  Returns per-client result dicts (metrics,
        ``train_time``, ``payload_bytes``; no ``update``).  The pre-train
        stages run once, through the first client, as in the reference."""
        clients = [self.client(c) for c in selected]
        for stage in ("download", "decompression", "train"):
            impls = {getattr(type(c), stage) for c in clients}
            if len(impls) > 1 or (stage == "train"
                                  and impls != {Client.train}):
                raise ValueError(
                    f"batched execution cannot vectorize per-client "
                    f"{stage!r} overrides ({[type(c).__name__ for c in clients]}); "
                    f"use resources.execution='sequential'")
        global_params = clients[0].decompression(clients[0].download(payload))
        method = self.cfg.client.compression
        st, new_params = self.engine.run_round_fused(
            clients, global_params, round_id,
            method=method, stc_sparsity=self.cfg.client.stc_sparsity,
            use_kernel=self.cfg.resources.aggregation_kernel,
            server_lr=self.cfg.server.server_lr)
        self.server.params = new_params

        total_steps = max(int(st["n_steps"][: len(clients)].sum()), 1)
        steps_f = st["n_steps"].astype(np.float64).tolist()
        loss, acc = st["loss"].tolist(), st["acc"].tolist()
        if method != "none":
            payloads = self.engine.per_client_payload_bytes(st)
        else:
            # dense update wire size from each leaf's real dtype
            payloads = [dense_update_bytes(global_params)] * len(clients)
        return [
            {"client_id": c.client_id, "num_samples": len(c.data),
             "train_time": st["wall"] * steps_f[i] / total_steps,
             "metrics": {"loss": loss[i], "accuracy": acc[i],
                         "batches": steps_f[i]},
             "payload_bytes": payloads[i]}
            for i, c in enumerate(clients)]

    # ------------------------------------------------------------------
    def _run_sequential(self, selected: List[str], payload: Dict[str, Any],
                        round_id: int, groups: List[List[str]]):
        """Every stage of every client, in the allocator's group order.
        -> (results in selection order, wall times, simulated times)."""
        results, wall_times, sim_times = [], {}, {}
        for group in groups:
            for cid in group:
                res = self.client(cid).run_round(payload, round_id)
                results.append(res)
                wall_times[cid] = res["train_time"]
                sim_times[cid] = self._effective_time(cid, res["train_time"])
        # canonical selection order, not scheduler-group order: the groups
        # follow measured times, so without this the FedAvg summation
        # order (and the params, by an ulp) would vary from run to run
        order = {cid: i for i, cid in enumerate(selected)}
        results.sort(key=lambda r: order[r["client_id"]])
        return results, wall_times, sim_times

    def run_round(self, round_id: int) -> Dict[str, float]:
        """Run round ``round_id`` and return its metrics."""
        server = self.server
        selected = server.selection(self.fed_data.client_ids, round_id)
        payload = server.distribution(selected)
        groups = self._allocate(selected, round_id)

        t_wall0 = time.perf_counter()
        down_bytes = payload.get("payload_bytes", 0) * len(selected)
        if self.engine is not None:
            results = self._run_batched(selected, payload, round_id)
            wall_times = {r["client_id"]: r["train_time"] for r in results}
            sim_times = {cid: self._effective_time(cid, t)
                         for cid, t in wall_times.items()}
        else:
            results, wall_times, sim_times = self._run_sequential(
                selected, payload, round_id, groups)
        # Eq. 1 makespan under the virtual clock
        round_virtual = max(
            (sum(sim_times[c] for c in g) for g in groups if g), default=0.0)
        self.scheduler.update(sim_times)
        if self.engine is None:
            server.aggregation(results)
        wall = time.perf_counter() - t_wall0

        # one batched host sync for the wire accounting of the results a
        # custom stage left without payload_bytes
        up_bytes = sum(r["payload_bytes"] for r in results
                       if "payload_bytes" in r)
        missing = [r for r in results if "payload_bytes" not in r]
        if missing:
            up_bytes += sum(comp.payload_bytes_many(
                [r["update"] for r in missing]))
        metrics = {
            "round_time": round_virtual,
            "wall_time": wall,
            "clients": len(selected),
            "comm_down_bytes": down_bytes,
            "comm_up_bytes": up_bytes,
            "train_loss": weighted_train_loss(results),
        }
        if self.cfg.server.test_every and \
           (round_id + 1) % self.cfg.server.test_every == 0:
            metrics.update(server.test())
        if self.cfg.tracking.enabled:
            self.tracker.track_round(self.cfg.task_id, round_id, **metrics)
            for r in results:
                self.tracker.track_client(
                    self.cfg.task_id, round_id, r["client_id"],
                    train_time=wall_times[r["client_id"]],
                    simulated_time=sim_times[r["client_id"]],
                    **r["metrics"])
        self.history.append(metrics)
        return metrics

    # ------------------------------------------------------------------
    def save_checkpoint(self, completed: int) -> str:
        raise NotImplementedError(
            "checkpoints are not ported to repro_torch yet (ROADMAP M6)")

    def resume(self, callback: Optional[Callable] = None,
               step: Optional[int] = None) -> Dict[str, Any]:
        raise NotImplementedError(
            "checkpoint/resume is not ported to repro_torch yet (ROADMAP M6)")

    # ------------------------------------------------------------------
    def run(self, callback: Optional[Callable] = None) -> Dict[str, Any]:
        """Train for ``server.rounds`` rounds.  Parameters already set on
        ``self.server.params`` (injected weights) are honored; otherwise the
        model is initialized from ``cfg.seed`` on the trainer's device."""
        if self.server.params is None:
            gen = torch.Generator().manual_seed(self.cfg.seed)
            self.server.params = self.model.init(gen, self.device)
        if self.cfg.tracking.enabled:
            from repro_torch.core.config import to_dict
            self.tracker.create_task(self.cfg.task_id, to_dict(self.cfg))
        return self._run(callback, start_round=0)

    def _run(self, callback: Optional[Callable],
             start_round: int) -> Dict[str, Any]:
        for r in range(start_round, self.cfg.server.rounds):
            self.run_round(r)
        self.server.finalize()
        summary = {
            "task_id": self.cfg.task_id,
            "rounds": self.cfg.server.rounds,
            "final": self.history[-1] if self.history else {},
            "history": self.history,
            "params": self.server.params,
        }
        if callback is not None:
            callback(summary)
        return summary

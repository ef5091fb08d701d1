"""Round orchestration: the runtime behind ``repro_torch.run()``.

Combines the platform modules per the FL life cycle (§III): simulation
manager (heterogeneity) + data manager + server/client stages +
distribution manager (GreedyAda, §VI) + tracking manager (§V-C).

Timing model: each client's local-training time is its step-count share
of the measured round time; the system-heterogeneity simulator scales it by
the client's device-class speed ratio (virtual clock).  The round's virtual
duration is the makespan of the device groups, Eq. 1:

    T_round = max_g  sum_{c in g} simulated_time(c)

The ported slice is the fused batched round: ``resources.execution=
"batched"`` with ``round_fusion="auto"``, flat FedAvg, no faults or
deadlines, synchronous rounds, and full or LoRA fine-tuning.  Every
configuration outside it raises ``NotImplementedError`` naming the ROADMAP
item that ports it — at construction, never as a silent detour.
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


def unported_config(cfg: Config) -> List[str]:
    """Every setting of ``cfg`` outside the ported slice, each with the
    ROADMAP item that ports it (empty when the slice covers ``cfg``)."""
    res = cfg.resources
    out = []
    if res.execution == "sequential":
        out.append("resources.execution='sequential' (ROADMAP M4)")
    elif res.execution == "async":
        out.append("resources.execution='async' (ROADMAP M7)")
    if res.round_fusion != "auto":
        out.append(f"resources.round_fusion={res.round_fusion!r}, the staged "
                   f"batched path (ROADMAP M5)")
    if res.distributed != "none":
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
    if cfg.server.compression != "none":
        out.append(f"server.compression={cfg.server.compression!r} "
                   f"(ROADMAP M4)")
    if cfg.server.aggregation != "fedavg":
        out.append(f"server.aggregation={cfg.server.aggregation!r}, the "
                   f"gathering path (ROADMAP M4)")
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
        if server is not None and (
                type(server).aggregation is not Server.aggregation
                or type(server).apply_delta is not Server.apply_delta):
            raise NotImplementedError(
                "Server.aggregation / Server.apply_delta overrides need the "
                "gathering and staged paths (ROADMAP M4, M5); the fused "
                "round applies FedAvg in-program")
        for stage in ("download", "decompression", "train", "compression",
                      "encryption", "upload"):
            if getattr(client_cls, stage) is not getattr(Client, stage):
                raise NotImplementedError(
                    f"a Client.{stage} override needs the sequential or "
                    f"gathering path (ROADMAP M4); the fused batched round "
                    f"vectorizes training and compresses in-program")
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
        self.engine = BatchedExecutor(model, self.device,
                                      distributed=config.resources.distributed)
        self.het = SystemHeterogeneity(config.system_heterogeneity)
        self.scheduler = GreedyAda(
            num_devices=max(1, config.resources.num_devices),
            default_time=config.resources.default_client_time,
            momentum=config.resources.momentum)
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------
    # Materialized-Client cache bound (virtual populations grow the
    # touched-client set every round)
    CLIENT_CACHE_MAX = 4096

    def client(self, cid: str) -> Client:
        if cid not in self.clients:
            if len(self.clients) >= self.CLIENT_CACHE_MAX:
                for old in list(self.clients)[
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

    # ------------------------------------------------------------------
    def _run_batched(self, selected: List[str], payload: Dict[str, Any],
                     round_id: int) -> List[Dict[str, Any]]:
        """The fused round: ONE dispatch trains the cohort, compresses
        in-program with error feedback, aggregates and applies the server
        update; one batched device->host fetch returns metrics and
        per-leaf STC counts.  Returns per-client result dicts (metrics,
        ``train_time``, ``payload_bytes``; no ``update``)."""
        clients = [self.client(c) for c in selected]
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
            payloads = [comp.payload_bytes(global_params)] * len(clients)
        return [
            {"client_id": c.client_id, "num_samples": len(c.data),
             "train_time": st["wall"] * steps_f[i] / total_steps,
             "metrics": {"loss": loss[i], "accuracy": acc[i],
                         "batches": steps_f[i]},
             "payload_bytes": payloads[i]}
            for i, c in enumerate(clients)]

    # ------------------------------------------------------------------
    def run_round(self, round_id: int) -> Dict[str, float]:
        """Run round ``round_id`` and return its metrics."""
        server = self.server
        selected = server.selection(self.fed_data.client_ids, round_id)
        payload = server.distribution(selected)
        groups = self._allocate(selected, round_id)

        t_wall0 = time.perf_counter()
        down_bytes = payload.get("payload_bytes", 0) * len(selected)
        results = self._run_batched(selected, payload, round_id)
        wall_times = {r["client_id"]: r["train_time"] for r in results}
        sim_times = {cid: self.het.simulate_time(cid, t)
                     for cid, t in wall_times.items()}
        # Eq. 1 makespan under the virtual clock
        round_virtual = max(
            (sum(sim_times[c] for c in g) for g in groups if g), default=0.0)
        self.scheduler.update(sim_times)
        wall = time.perf_counter() - t_wall0

        metrics = {
            "round_time": round_virtual,
            "wall_time": wall,
            "clients": len(selected),
            "comm_down_bytes": down_bytes,
            "comm_up_bytes": sum(r["payload_bytes"] for r in results),
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

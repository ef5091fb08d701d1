"""Round orchestration: the runtime behind ``repro_torch.run()``.

Combines the platform modules per the FL life cycle (§III): simulation
manager (heterogeneity) + data manager + server/client stages +
distribution manager (GreedyAda, §VI) + tracking manager (§V-C).

Timing model: each client's measured local-training time is recorded; the
system-heterogeneity simulator scales it by the client's device-class
speed ratio (virtual clock).  The round's virtual duration is the makespan
of the device groups, Eq. 1:

    T_round = max_g  sum_{c in g} simulated_time(c)

Three engines are ported.  ``resources.execution="sequential"`` (the
default) runs every stage of every selected client in turn — each stage
overridable — then ``Server.aggregation``.  ``"async"`` replaces the round
loop with the FedBuff event loop (``core/async_engine.py``), whose waves
train on the batched engine.  ``"batched"`` trains the
cohort as one stacked program (``core/batched.py``) and takes one of three
paths, as the reference does: the fused round (``round_fusion="auto"``),
the staged path (``"off"``, or a round with a ``Server.apply_delta``
override) and the gathering path (a non-FedAvg aggregator, a
``Server.aggregation`` override or a ``Client`` compression / encryption /
upload override: each client's own post-train stages, then
``Server.aggregation``).  Both engines run flat or hierarchical FedAvg;
``tracking.round_sync=False`` defers each round's metric fetch behind the
next round's dispatch; ``resources.distributed="data"`` shards the batched
cohort over ``repro_torch.get_devices()`` on all three paths; LoRA
(``client.finetune="lora"``) runs under every engine.  Every engine takes the
fault layer (``cfg.faults``: dropout, crash, straggler, NaN uploads, the
NaN/norm guard and the survivor floor; under async, retry with backoff),
``resources.round_deadline`` and checkpoint/resume (``cfg.checkpoint``) as
the reference does.  Every configuration the reference accepts runs.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
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
    ClientProfile, GreedyAda, one_per_device, random_allocation,
    slowest_allocation,
)
from repro_torch.simulation.heterogeneity import (
    FaultInjector, FaultPlan, SystemHeterogeneity,
)
from repro_torch.tracking import Tracker
from repro_torch.utils.tree import tree_leaves, tree_map


def _poison_update(update):
    """Corrupt an uploaded update with NaNs (``faults.nan_update_prob``).

    Applied *after* the compression stage — the model is a corrupted wire
    payload, so the client's error-feedback residual stays clean.  For
    ``CompressedTensor`` leaves the structure (and so the byte accounting)
    is kept: float payloads are poisoned directly, int8 payloads through
    their dequantization scale."""
    nan = float("nan")

    def one(x):
        if isinstance(x, comp.CompressedTensor):
            if x.kind == "int8":
                return comp.CompressedTensor(x.kind, x.data, x.scale * nan,
                                             x.nnz)
            return comp.CompressedTensor(
                x.kind, x.data.to(torch.float32) * nan, x.scale, x.nnz)
        return x.to(torch.float32) * nan

    return tree_map(one, update)


def update_is_valid(update, max_norm: float = 0.0) -> bool:
    """Host-side NaN/Inf + norm-outlier guard for a gathered update: the
    twin of the fused round's guard for the sequential engine and the
    gathering path.  ``max_norm`` bounds the update's global L2 norm (0
    disables the bound); the squares are summed in float64 and compared
    with ``max_norm ** 2``, as the reference does."""
    dense = comp.decompress(update)
    sq = 0.0
    for leaf in tree_leaves(dense):
        a = leaf.to(torch.float32)
        if not bool(torch.isfinite(a).all()):
            return False
        if max_norm > 0:
            sq += float(torch.sum(torch.square(a.to(torch.float64))))
    return not (max_norm > 0 and sq > float(max_norm) ** 2)


def _on(device):
    """Leaf converter of checkpoint trees: numpy arrays (or host tensors)
    -> tensors on ``device``."""
    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return torch.as_tensor(np.asarray(a), device=device)
    return put


def dense_update_bytes(params) -> int:
    """Wire size of one dense (uncompressed) update of ``params``' shape,
    from each leaf's own item size."""
    return sum(comp.array_nbytes(leaf) for leaf in tree_leaves(params))


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
        self.faults = FaultInjector(config.faults)
        if config.faults.active and \
                config.faults.min_clients_per_round > \
                config.server.clients_per_round:
            raise ValueError(
                f"faults.min_clients_per_round="
                f"{config.faults.min_clients_per_round} can never be met: "
                f"only server.clients_per_round="
                f"{config.server.clients_per_round} clients are selected "
                f"per round")
        # the sequential engine needs no data pool or EF store on the
        # device; async waves run through the batched executor
        self.engine = (BatchedExecutor(
            model, self.device, distributed=config.resources.distributed)
            if config.resources.execution in ("batched", "async") else None)
        self.het = SystemHeterogeneity(config.system_heterogeneity)
        self.scheduler = GreedyAda(
            num_devices=max(1, config.resources.num_devices),
            default_time=config.resources.default_client_time,
            momentum=config.resources.momentum)
        self.history: List[Dict[str, float]] = []
        # error-feedback residuals loaded from a checkpoint, applied when
        # the owning client is materialized
        self._pending_residuals: Dict[str, Any] = {}
        # one loud warning per trainer when round_fusion="auto" cannot fuse
        # a batched round
        self._fusion_warned = False

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
            if cid in self._pending_residuals:
                # checkpointed error-feedback state of the sequential
                # engine (the batched one keeps its own in the executor)
                self.clients[cid]._residual = tree_map(
                    _on(self.device), self._pending_residuals.pop(cid))
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
    # fault injection (cfg.faults)
    # ------------------------------------------------------------------
    def _plan_cohort(self, selected: List[str], round_id: int):
        """Sample each selected client's :class:`FaultPlan`; when fewer
        than ``faults.min_clients_per_round`` clients would survive the
        failures known up front (dropout, crash), re-select the cohort
        (bounded attempts, then a loud ``ValueError``).  Deadline misses
        and guard rejections are known only after the fact and do not
        re-select.  -> (selected, plans, reselections)."""
        f = self.cfg.faults
        floor = min(f.min_clients_per_round, len(selected))
        attempts = 0
        reselections = 0
        while True:
            plans = {c: self.faults.plan(c, round_id) for c in selected}
            alive = sum(1 for p in plans.values() if not p.fails)
            if alive >= floor:
                return selected, plans, reselections
            attempts += 1
            if attempts > 20:
                raise ValueError(
                    f"faults.min_clients_per_round="
                    f"{f.min_clients_per_round}: could not assemble a "
                    f"cohort with >= {floor} surviving clients after "
                    f"{attempts} selection attempts in round {round_id} "
                    f"(last draw: {alive}/{len(selected)} survivors); "
                    f"lower dropout/crash probabilities or the floor")
            reselections += 1
            selected = self.server.selection(self.fed_data.client_ids,
                                             round_id)

    def _effective_time(self, cid: str, base: float,
                        plan: Optional[FaultPlan] = None) -> float:
        """Virtual response time under a fault plan: a straggler's training
        time is scaled before the heterogeneity simulation, a crash elapses
        only ``crash_fraction`` of it, and a dropout never responds (0
        towards the makespan)."""
        if plan is None:
            return self.het.simulate_time(cid, base)
        if plan.dropout:
            return 0.0
        f = self.cfg.faults
        t = base * (f.straggler_slowdown if plan.straggler else 1.0)
        t = self.het.simulate_time(cid, t)
        if plan.crash:
            t *= plan.crash_fraction
        return t

    # ------------------------------------------------------------------
    def _run_batched(self, selected: List[str], payload: Dict[str, Any],
                     round_id: int,
                     plans: Optional[Dict[str, FaultPlan]] = None,
                     counts: Optional[Dict[str, int]] = None):
        """Train the cohort as one stacked program and finish the round on
        one of three paths.  -> ``(results, aggregated, finish)``.

        * **fused** (``round_fusion="auto"``, default stages, FedAvg, no
          ``Server`` override, no ``round_deadline``): ONE dispatch trains,
          compresses in-program with error feedback, applies the fault
          mask and the NaN/norm guard, aggregates and applies the server
          update; one batched fetch returns metrics, the guard's verdicts
          and per-leaf STC counts.  ``finish`` is None, or under
          ``tracking.round_sync=False`` the closure that runs that fetch
          and fills ``metrics`` and ``payload_bytes`` later.
        * **staged** (``round_fusion="off"``, a ``Server.apply_delta``
          override, or a ``round_deadline``): the same arithmetic in three
          stages (``run_cohort_stacked``, ``compress_stacked``,
          ``aggregate_stacked``), then ``Server.apply_delta``; deadline
          misses are decided from the measured training time.
        * **gathering** (a ``Client`` compression / encryption / upload
          override, a non-FedAvg aggregator or a ``Server.aggregation``
          override): per-client updates through each client's own
          post-train stages; ``aggregated`` is False and the caller runs
          ``Server.aggregation``.

        Under faults (``plans``) a dropped or crashed client still trains
        at full bucketed width (no new program): on the fused and staged
        paths it still writes its EF residual and only its weight goes to
        0; on the gathering path its post-train stages are skipped, so its
        residual stays untouched.  NaN uploads are poisoned after
        compression.  The pre-train stages run once, through the first
        client, as in the reference.

        An async wave (``execution="async"``) never fuses: with default
        stages and built-in stc / int8 it compresses in-program
        (``run_cohort_stacked`` -> ``compress_stacked``, residuals keyed by
        client id across waves) and hands back each client's sent update;
        otherwise it takes the gathering path.  Either way ``aggregated``
        is False: the event loop buffers the updates."""
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
        res_cfg = self.cfg.resources
        method = self.cfg.client.compression
        default_post = all(
            type(c).compression is Client.compression
            and type(c).encryption is Client.encryption
            and type(c).upload is Client.upload for c in clients)
        is_async = res_cfg.execution == "async"
        fuse_agg = (not is_async and default_post
                    and self.cfg.server.aggregation == "fedavg"
                    and type(self.server).aggregation is Server.aggregation)
        # a deadline needs the round's own measured time, which does not
        # exist until the single dispatch completes
        fuse_round = (fuse_agg and res_cfg.round_fusion == "auto"
                      and res_cfg.round_deadline == 0
                      and type(self.server).apply_delta is Server.apply_delta)
        if not is_async and not fuse_round \
                and res_cfg.round_fusion == "auto" \
                and not self._fusion_warned:
            reasons = []
            if not default_post:
                reasons.append("per-client compression/encryption/upload "
                               "stage overrides")
            if self.cfg.server.aggregation != "fedavg":
                reasons.append(f"server.aggregation="
                               f"{self.cfg.server.aggregation!r} (non-FedAvg)")
            if type(self.server).aggregation is not Server.aggregation:
                reasons.append("a Server.aggregation override")
            if type(self.server).apply_delta is not Server.apply_delta:
                reasons.append("a Server.apply_delta override")
            if res_cfg.round_deadline > 0:
                reasons.append("resources.round_deadline > 0 (deadline "
                               "masking needs the measured round time)")
            self._fusion_warned = True
            warnings.warn(
                "resources.round_fusion='auto' cannot fuse this round into "
                "one program (" + "; ".join(reasons) + "); falling back to "
                "the staged batched path — set round_fusion='off' to "
                "silence (docs/perf.md)", stacklevel=3)

        def payloads(st):
            if method != "none":
                return self.engine.per_client_payload_bytes(st)
            # dense update wire size from each leaf's real dtype
            return [dense_update_bytes(global_params)] * len(clients)

        def label_rejected(results, labels, ok):
            """Fault labels of the round; unlabelled clients the guard
            rejected become ``"rejected"``."""
            for i, res in enumerate(results):
                lab = labels.get(res["client_id"])
                if lab is None and not ok[i]:
                    lab = "rejected"
                    counts["rejected"] += 1
                if lab is not None:
                    res["_fault"] = lab

        labels: Dict[str, str] = {}
        if fuse_round:
            mask, nan_rows = None, []
            if plans is not None:
                # dropout and crash are known before the round runs, so
                # the survival mask is an input of the single dispatch
                mask = np.ones((len(clients),), np.float32)
                for i, client in enumerate(clients):
                    p = plans[client.client_id]
                    if p.dropout:
                        mask[i], labels[client.client_id] = 0.0, "dropped"
                    elif p.crash:
                        mask[i], labels[client.client_id] = 0.0, "crashed"
                nan_rows = [i for i, c in enumerate(clients)
                            if plans[c.client_id].nan_update]
            st, new_params, fetch = self.engine.run_round_fused(
                clients, global_params, round_id,
                method=method, stc_sparsity=self.cfg.client.stc_sparsity,
                use_kernel=res_cfg.aggregation_kernel,
                topology=res_cfg.aggregation_topology,
                fanout=res_cfg.aggregation_fanout,
                use_faults=plans is not None, mask=mask, nan_rows=nan_rows,
                max_update_norm=(self.cfg.faults.max_update_norm
                                 if plans is not None else 0.0),
                server_lr=self.cfg.server.server_lr,
                sync=self.cfg.tracking.round_sync)
            self.server.params = new_params
            total_steps = max(int(st["n_steps"][: len(clients)].sum()), 1)
            steps_f = st["n_steps"].astype(np.float64).tolist()
            results = [
                {"client_id": c.client_id, "num_samples": len(c.data),
                 "train_time": st["wall"] * steps_f[i] / total_steps}
                for i, c in enumerate(clients)]

            def complete():
                """Metrics, wire bytes and fault labels from the round's
                single fetch."""
                if fetch is not None:
                    fetch()
                loss, acc = st["loss"].tolist(), st["acc"].tolist()
                for i, (res, pb) in enumerate(zip(results, payloads(st))):
                    res["metrics"] = {"loss": loss[i], "accuracy": acc[i],
                                      "batches": steps_f[i]}
                    res["payload_bytes"] = pb
                if plans is not None:
                    label_rejected(results, labels, st["guard_ok"])

            if fetch is None:
                complete()
                return results, True, None
            return results, True, complete
        if fuse_agg:
            st = self.engine.run_cohort_stacked(clients, global_params,
                                                round_id)
            if method != "none":
                st = self.engine.compress_stacked(
                    st, clients, method, self.cfg.client.stc_sparsity)
            # failed and deadline-missing clients are zero-weighted out of
            # FedAvg and NaN uploads are poisoned after compression (the
            # residuals stay clean) for the guard to reject; the cohort
            # trains at full bucketed width all the same
            mask = None
            if plans is not None:
                mask = np.ones((len(clients),), np.float32)
                total_steps = max(int(st["n_steps"][: len(clients)].sum()),
                                  1)
                steps_f = np.asarray(st["n_steps"], dtype=np.float64)
                deadline = res_cfg.round_deadline
                for i, client in enumerate(clients):
                    p = plans[client.client_id]
                    base = st["wall"] * steps_f[i] / total_steps
                    eff = self._effective_time(client.client_id, base, p)
                    if p.dropout:
                        mask[i], labels[client.client_id] = 0.0, "dropped"
                    elif p.crash:
                        mask[i], labels[client.client_id] = 0.0, "crashed"
                    elif deadline > 0 and eff > deadline:
                        mask[i], labels[client.client_id] = 0.0, "deadline"
                        counts["deadline_missed"] += 1
                nan_rows = [i for i, c in enumerate(clients)
                            if plans[c.client_id].nan_update]
                if nan_rows:
                    self.engine.poison_rows(st, nan_rows)
            self.server.apply_delta(self.engine.aggregate_stacked(
                st, use_kernel=res_cfg.aggregation_kernel, mask=mask,
                guard=plans is not None,
                max_update_norm=(self.cfg.faults.max_update_norm
                                 if plans is not None else 0.0),
                topology=res_cfg.aggregation_topology,
                fanout=res_cfg.aggregation_fanout))
            results = self.engine.per_client_results(clients, st,
                                                     include_update=False)
            for client, res, pb in zip(clients, results, payloads(st)):
                res["client_id"] = client.client_id
                res["payload_bytes"] = pb
            if plans is not None:
                # one small host sync (N_b bools), only under faults
                label_rejected(results, labels,
                               st["guard_ok"].cpu().numpy())
            return results, True, None
        if is_async and default_post and method in ("stc", "int8"):
            # async wave: compress in-program, hand back each client's sent
            # (dense) update for the FedBuff buffer
            st = self.engine.compress_stacked(
                self.engine.run_cohort_stacked(clients, global_params,
                                               round_id),
                clients, method, self.cfg.client.stc_sparsity)
            results = self.engine.per_client_results(clients, st)
            for client, res, pb in zip(clients, results, payloads(st)):
                res["client_id"] = client.client_id
                res["payload_bytes"] = pb
            return results, False, None

        results = []
        for client, res in zip(clients, self.engine.run_cohort(
                clients, global_params, round_id)):
            p = plans.get(client.client_id) if plans is not None else None
            if p is not None and p.fails:
                # the update never arrives: skip the post-train stages so
                # the client's residual stays untouched; the round
                # zero-weights it by its label
                res.pop("update", None)
                res["client_id"] = client.client_id
                res["_fault"] = "dropped" if p.dropout else "crashed"
                results.append(res)
                continue
            res = client.compression(res)
            res = client.encryption(res)
            res["client_id"] = client.client_id
            res = client.upload(res)
            if p is not None and p.nan_update:
                res["update"] = _poison_update(res["update"])
            results.append(res)
        return results, False, None

    # ------------------------------------------------------------------
    def _run_sequential(self, selected: List[str], payload: Dict[str, Any],
                        round_id: int, groups: List[List[str]],
                        plans: Optional[Dict[str, FaultPlan]] = None):
        """Every stage of every client, in the allocator's group order.
        Under faults a dropout never trains (0 time), a crash trains but
        its update and post-train stages never happen (its residual stays
        untouched; partial virtual time elapses) and a NaN upload is
        poisoned after compression.
        -> (results in selection order, wall times, simulated times)."""
        results, wall_times, sim_times = [], {}, {}
        for group in groups:
            for cid in group:
                p = plans[cid] if plans is not None else None
                if p is not None and p.dropout:
                    wall_times[cid] = sim_times[cid] = 0.0
                    continue
                if p is not None and p.crash:
                    c = self.client(cid)
                    res = c.train(c.decompression(c.download(payload)),
                                  round_id)
                    res.pop("update")
                    res["client_id"] = cid
                    res["_fault"] = "crashed"
                else:
                    res = self.client(cid).run_round(payload, round_id)
                    if p is not None and p.nan_update:
                        res["update"] = _poison_update(res["update"])
                results.append(res)
                wall_times[cid] = res["train_time"]
                sim_times[cid] = self._effective_time(cid, res["train_time"],
                                                      p)
        # canonical selection order, not scheduler-group order: the groups
        # follow measured times, so without this the FedAvg summation
        # order (and the params, by an ulp) would vary from run to run and
        # break bit-identical resume
        order = {cid: i for i, cid in enumerate(selected)}
        results.sort(key=lambda r: order[r["client_id"]])
        return results, wall_times, sim_times

    def run_round(self, round_id: int) -> Dict[str, float]:
        """Run round ``round_id`` and return its metrics: the dispatch and
        its finalize back to back (see :meth:`_dispatch_round`)."""
        return self._dispatch_round(round_id)()

    def _dispatch_round(self, round_id: int
                        ) -> Callable[[], Dict[str, float]]:
        """Run round ``round_id`` up to its metrics; return the finalize
        closure that fetches them (a deferred fused round's single batched
        fetch), accounts bytes, tests ``server.params`` as this round left
        them, tracks and appends the history entry.  ``_run`` defers it
        behind the next dispatch under ``tracking.round_sync=False``."""
        if self.cfg.resources.execution == "async":
            raise ValueError(
                'resources.execution="async" replaces the synchronous round '
                "loop with an event loop; call Trainer.run()")
        server = self.server
        f = self.cfg.faults
        deadline = self.cfg.resources.round_deadline
        selected = server.selection(self.fed_data.client_ids, round_id)
        plans = counts = None
        # a deadline alone (faults off) takes the degradation path too:
        # every plan is healthy, only misses zero-weight
        if f.active or deadline > 0:
            selected, plans, reselections = self._plan_cohort(selected,
                                                              round_id)
            counts = {"deadline_missed": 0, "rejected": 0,
                      "reselections": reselections,
                      "dropped": sum(p.dropout for p in plans.values()),
                      "crashed": sum(p.crash for p in plans.values()),
                      "straggled": sum(p.straggler
                                       for p in plans.values())}
        payload = server.distribution(selected)
        groups = self._allocate(selected, round_id)

        t_wall0 = time.perf_counter()
        down_bytes = payload.get("payload_bytes", 0) * len(selected)
        aggregated, finish = False, None
        if self.engine is not None:
            results, aggregated, finish = self._run_batched(
                selected, payload, round_id, plans=plans, counts=counts)
            wall_times = {r["client_id"]: r["train_time"] for r in results}
            sim_times = {cid: self._effective_time(
                cid, t, plans[cid] if plans is not None else None)
                for cid, t in wall_times.items()}
        else:
            results, wall_times, sim_times = self._run_sequential(
                selected, payload, round_id, groups, plans)
        if plans is not None and not aggregated:
            # the gathered paths' degradation (the stacked paths weighted
            # on the device): deadline misses and guard rejections are
            # known only now
            for res in results:
                cid = res["client_id"]
                if res.get("_fault") is not None:
                    continue
                if deadline > 0 and sim_times[cid] > deadline:
                    res["_fault"] = "deadline"
                    counts["deadline_missed"] += 1
                elif not update_is_valid(res["update"], f.max_update_norm):
                    res["_fault"] = "rejected"
                    counts["rejected"] += 1
        survivors = [r for r in results if r.get("_fault") is None]
        # Eq. 1 makespan under the virtual clock (the server stops waiting
        # at the deadline, so each client's share caps there)
        capped = (sim_times if plans is None or deadline <= 0 else
                  {c: min(t, deadline) for c, t in sim_times.items()})
        round_virtual = max(
            (sum(capped[c] for c in g) for g in groups if g), default=0.0)
        if plans is None:
            self.scheduler.update(sim_times)
        else:
            # a dropped client's 0.0 is no observation of its speed
            self.scheduler.update({c: t for c, t in sim_times.items()
                                   if not plans[c].dropout})
        if not aggregated and (plans is None or survivors):
            server.aggregation(survivors if plans is not None else results)
        wall = time.perf_counter() - t_wall0
        # the params this round produced: a deferred finalize tests these
        # even after the next round has replaced server.params
        params_r = server.params

        def finalize() -> Dict[str, float]:
            if finish is not None:
                finish()
            survivors = [r for r in results if r.get("_fault") is None]
            # crashed, dropped and deadline-missing uploads never reached
            # the server, so their bytes do not count; one batched host
            # sync for the results a custom stage left without
            # payload_bytes
            arrived = (results if plans is None else
                       [r for r in results
                        if r.get("_fault") in (None, "rejected")])
            up_bytes = sum(r["payload_bytes"] for r in arrived
                           if "payload_bytes" in r)
            missing = [r for r in arrived if "payload_bytes" not in r]
            if missing:
                up_bytes += sum(comp.payload_bytes_many(
                    [r["update"] for r in missing]))
            train_loss = weighted_train_loss(
                survivors if plans is not None else results) \
                if plans is None or survivors else float("nan")
            metrics = {
                "round_time": round_virtual,
                "wall_time": wall,
                "clients": len(selected),
                "comm_down_bytes": down_bytes,
                "comm_up_bytes": up_bytes,
                "train_loss": train_loss,
            }
            if plans is not None:
                metrics.update(
                    survivors=len(survivors),
                    survivor_fraction=len(survivors) / max(len(selected), 1),
                    **counts)
            if self.cfg.server.test_every and \
               (round_id + 1) % self.cfg.server.test_every == 0:
                saved, server.params = server.params, params_r
                try:
                    metrics.update(server.test())
                finally:
                    server.params = saved
            if self.cfg.tracking.enabled:
                self.tracker.track_round(self.cfg.task_id, round_id,
                                         **metrics)
                for r in results:
                    extra = ({} if r.get("_fault") is None
                             else {"fault": r["_fault"]})
                    self.tracker.track_client(
                        self.cfg.task_id, round_id, r["client_id"],
                        train_time=wall_times[r["client_id"]],
                        simulated_time=sim_times[r["client_id"]],
                        **r["metrics"], **extra)
            self.history.append(metrics)
            return metrics

        return finalize

    # ------------------------------------------------------------------
    # checkpoint / resume (cfg.checkpoint — repro_torch.checkpoint.store)
    # ------------------------------------------------------------------
    def _maybe_checkpoint(self, completed: int) -> None:
        ck = self.cfg.checkpoint
        if ck.every and completed % ck.every == 0:
            self.save_checkpoint(completed)

    def save_checkpoint(self, completed: int) -> str:
        """Atomically persist everything a fresh ``Trainer`` needs to
        continue from round ``completed``, in the reference's format 1:
        server params and selection RNG (and a FedBuff server's buffer,
        decompressed), round index (under async: the model version, the
        aggregations completed), history, the
        heterogeneity speed assignments, the scheduler profiles, and the
        error-feedback residuals of both engines (the sequential clients'
        and the batched executor's store, both tiers; residuals a resume
        restored whose clients have not trained since are kept too).  The
        fault sampler is stateless and needs nothing persisted."""
        from repro_torch.checkpoint.store import save_checkpoint

        state: Dict[str, Any] = {
            "format": 1,
            "round": int(completed),
            "execution": self.cfg.resources.execution,
            "finetune": self.cfg.client.finetune,
            "server": self.server.state_dict(),
            "history": self.history,
            "het_assignment": dict(self.het.assignment),
            "scheduler": {
                "default_time": float(self.scheduler.default_time),
                "profiles": {cid: [float(p.time), bool(p.profiled)]
                             for cid, p in self.scheduler.profiles.items()},
            },
            # residuals restored by a resume but not yet materialized are
            # state too (the reference drops them from the next save);
            # ids sorted, so the file does not depend on the order clients
            # were materialized in
            "client_residuals": dict(sorted({
                **self._pending_residuals,
                **{cid: c._residual for cid, c in self.clients.items()
                   if c._residual is not None}}.items())),
        }
        if self.engine is not None:
            state["ef"] = self.engine.ef_state()
        ck = self.cfg.checkpoint
        return save_checkpoint(ck.dir, state, step=completed, keep=ck.keep)

    def resume(self, callback: Optional[Callable] = None,
               step: Optional[int] = None) -> Dict[str, Any]:
        """Load the latest (or ``step``) checkpoint from
        ``cfg.checkpoint.dir`` and continue training to completion.

        The synchronous engines continue bit-identically to the
        uninterrupted run (every source of randomness is either restored —
        selection RNG, speed assignments, EF residuals — or deterministic:
        data shuffles, the fault sampler), except under a
        ``round_deadline``, whose misses depend on measured wall time.
        The async engine resumes its remaining buffer aggregations from the
        checkpointed model and version; work in flight at the kill is
        dispatched anew, so its trajectory is value-correct, not
        bit-identical."""
        from repro_torch.checkpoint.store import load_checkpoint

        state = load_checkpoint(self.cfg.checkpoint.dir, step)
        if state.get("execution") != self.cfg.resources.execution:
            raise ValueError(
                f"checkpoint was written by a "
                f"{state.get('execution')!r}-execution run; this trainer "
                f"uses {self.cfg.resources.execution!r} — resume with the "
                f"same engine")
        if state.get("finetune", "full") != self.cfg.client.finetune:
            raise ValueError(
                f"checkpoint was written by a finetune="
                f"{state.get('finetune', 'full')!r} run; this trainer uses "
                f"finetune={self.cfg.client.finetune!r} — the parameter "
                f"trees are incompatible (LoRA adapters vs full weights)")
        completed = int(state["round"])
        self.server.load_state_dict(state["server"])
        self.server.params = tree_map(_on(self.device), self.server.params)
        self.history = list(state.get("history", []))
        self.het.assignment = {str(k): float(v) for k, v in
                               state.get("het_assignment", {}).items()}
        sched = state.get("scheduler", {})
        self.scheduler.default_time = float(
            sched.get("default_time", self.scheduler.default_time))
        for cid, (t, profiled) in sched.get("profiles", {}).items():
            self.scheduler.profiles[str(cid)] = ClientProfile(
                time=float(t), profiled=bool(profiled))
        self._pending_residuals = dict(state.get("client_residuals", {}))
        if self.engine is not None and "ef" in state:
            self.engine.load_ef_state(state["ef"])
        if self.cfg.tracking.enabled:
            from repro_torch.core.config import to_dict
            self.tracker.create_task(self.cfg.task_id, to_dict(self.cfg))
        return self._run(callback, start_round=completed)

    def _run_rounds(self, start_round: int) -> None:
        """The synchronous round loop of :meth:`_run`."""
        defer = not self.cfg.tracking.round_sync
        ck = self.cfg.checkpoint
        te = self.cfg.server.test_every
        pending: Optional[Callable[[], Dict[str, float]]] = None
        for r in range(start_round, self.cfg.server.rounds):
            fin = self._dispatch_round(r)
            if pending is not None:
                pending()
                pending = None
            eager = (ck.every and (r + 1) % ck.every == 0) or \
                    (te and (r + 1) % te == 0)
            if defer and not eager:
                pending = fin
            else:
                fin()
                self._maybe_checkpoint(r + 1)
        if pending is not None:
            pending()

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
        """Round loop shared by :meth:`run` (from 0) and :meth:`resume`.

        ``tracking.round_sync=False`` runs a one-deep pipeline: round R's
        finalize (its metric fetch) waits until round R+1 is dispatched,
        so the card never idles on that sync.  Checkpoint and test rounds
        finalize at once: a checkpoint must hold the round's history, and
        a test must see the params the round produced.  Under async the
        event loop runs instead; it appends each aggregation to
        ``self.history`` itself and sizes its remaining budget from it."""
        if self.cfg.resources.execution == "async":
            from repro_torch.core.async_engine import AsyncEngine
            AsyncEngine(self).run()
        else:
            self._run_rounds(start_round)
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

"""Hierarchical tracking manager (paper §V-C).

Three metric levels: **task** -> **rounds** -> **clients** — "a training task
comprises metrics of rounds where a round contains metrics of clients".
Two backends: in-memory (standalone/distributed training, *local tracking*)
and JSONL (queryable on disk; a remote tracking service forwards metrics to
one of these via API calls: ``launch.service``'s tracker role).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ClientMetrics:
    client_id: str
    metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class RoundMetrics:
    round_id: int
    metrics: Dict[str, float] = field(default_factory=dict)
    clients: Dict[str, ClientMetrics] = field(default_factory=dict)


@dataclass
class TaskMetrics:
    task_id: str
    config: Dict[str, Any] = field(default_factory=dict)
    rounds: Dict[int, RoundMetrics] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)


class Tracker:
    """Local tracking backend + query API (also serves remote tracking)."""

    def __init__(self, backend: str = "memory",
                 out_dir: str = "artifacts/tracking",
                 client_history_rounds: int = 0):
        self.backend = backend
        self.out_dir = out_dir
        # Retention bound for *client-level* rows in the memory backend:
        # 0 keeps everything; N > 0 keeps per-client metrics only for the
        # most recent N rounds (round-level metrics are always kept, so a
        # million-client sweep doesn't accrete O(rounds * cohort) dicts).
        # The JSONL backend is append-only and unaffected — history
        # remains queryable on disk via ``load_jsonl``.
        self.client_history_rounds = int(client_history_rounds)
        self.tasks: Dict[str, TaskMetrics] = {}
        if backend == "jsonl":
            os.makedirs(out_dir, exist_ok=True)

    # ---- write API ----------------------------------------------------
    def create_task(self, task_id: str, config: Optional[Dict] = None) -> None:
        self.tasks[task_id] = TaskMetrics(task_id, config or {})
        self._persist("task", {"task_id": task_id, "config": config or {}})

    def track_round(self, task_id: str, round_id: int, **metrics) -> None:
        task = self.tasks.setdefault(task_id, TaskMetrics(task_id))
        rnd = task.rounds.setdefault(round_id, RoundMetrics(round_id))
        rnd.metrics.update({k: _to_float(v) for k, v in metrics.items()})
        self._persist("round", {"task_id": task_id, "round": round_id,
                                "metrics": rnd.metrics})

    def track_client(self, task_id: str, round_id: int, client_id: str,
                     **metrics) -> None:
        task = self.tasks.setdefault(task_id, TaskMetrics(task_id))
        rnd = task.rounds.setdefault(round_id, RoundMetrics(round_id))
        cm = rnd.clients.setdefault(client_id, ClientMetrics(client_id))
        cm.metrics.update({k: _to_float(v) for k, v in metrics.items()})
        self._persist("client", {"task_id": task_id, "round": round_id,
                                 "client": client_id, "metrics": cm.metrics})
        self._prune_clients(task, round_id)

    def _prune_clients(self, task: TaskMetrics, round_id: int) -> None:
        n = self.client_history_rounds
        if n <= 0:
            return
        cutoff = round_id - n
        for rid, rnd in task.rounds.items():
            if rid <= cutoff and rnd.clients:
                rnd.clients = {}

    # ---- query API (command-line tools / dashboards build on these) ----
    def get_task(self, task_id: str) -> TaskMetrics:
        return self.tasks[task_id]

    def round_series(self, task_id: str, key: str) -> List[float]:
        task = self.tasks[task_id]
        return [task.rounds[r].metrics.get(key, float("nan"))
                for r in sorted(task.rounds)]

    def client_series(self, task_id: str, round_id: int,
                      key: str) -> Dict[str, float]:
        rnd = self.tasks[task_id].rounds[round_id]
        return {cid: cm.metrics.get(key, float("nan"))
                for cid, cm in rnd.clients.items()}

    def best_round(self, task_id: str, key: str, mode: str = "max") -> int:
        series = self.round_series(task_id, key)
        fn = max if mode == "max" else min
        best = fn(range(len(series)), key=lambda i: series[i])
        return sorted(self.tasks[task_id].rounds)[best]

    def summary(self, task_id: str) -> Dict[str, Any]:
        task = self.tasks[task_id]
        out = {"task_id": task_id, "rounds": len(task.rounds)}
        if task.rounds:
            last = task.rounds[max(task.rounds)]
            out["last_round"] = dict(last.metrics)
        return out

    # ---- persistence ----------------------------------------------------
    def _persist(self, kind: str, record: Dict) -> None:
        if self.backend != "jsonl":
            return
        path = os.path.join(self.out_dir, "events.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps({"kind": kind, "ts": time.time(), **record}) + "\n")

    @staticmethod
    def load_jsonl(out_dir: str) -> "Tracker":
        t = Tracker(backend="memory")
        path = os.path.join(out_dir, "events.jsonl")
        if not os.path.exists(path):
            return t
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                kind = rec.pop("kind")
                rec.pop("ts", None)
                if kind == "task":
                    t.create_task(rec["task_id"], rec.get("config"))
                elif kind == "round":
                    t.track_round(rec["task_id"], rec["round"], **rec["metrics"])
                elif kind == "client":
                    t.track_client(rec["task_id"], rec["round"], rec["client"],
                                   **rec["metrics"])
        return t


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v

"""Service discovery (paper §VII, Fig. 4b): registor + registry.

Clients don't know their own addresses inside containers; a *registor*
observes them and writes to a *registry* the server queries.  The paper's
two stacks (Kubernetes Pod/Service+DNS, docker-gen+etcd) are modeled by one
etcd-like consistent KV store with TTL leases + watch, which both the
in-process and socket deployments use.  ``repro_torch.deploy.manifests``
emits the k8s/docker artifacts this maps onto in production.  Pure host
code: no tensor and no device is touched here.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class Registration:
    client_id: str
    address: Tuple[str, int]
    metadata: Dict[str, str] = field(default_factory=dict)
    expires_at: float = float("inf")


class Registry:
    """etcd-like KV with leases and watchers (the *registry*)."""

    def __init__(self, default_ttl: Optional[float] = None):
        self._data: Dict[str, Registration] = {}
        self._lock = threading.Lock()
        self._watchers: List[Callable[[str, Optional[Registration]], None]] = []
        self.default_ttl = default_ttl

    def register(self, client_id: str, address: Tuple[str, int],
                 ttl: Optional[float] = None, **metadata) -> None:
        ttl = ttl if ttl is not None else self.default_ttl
        exp = time.time() + ttl if ttl else float("inf")
        reg = Registration(client_id, tuple(address), dict(metadata), exp)
        with self._lock:
            self._data[client_id] = reg
            watchers = list(self._watchers)
        for w in watchers:
            w(client_id, reg)

    def heartbeat(self, client_id: str, ttl: Optional[float] = None) -> bool:
        with self._lock:
            reg = self._data.get(client_id)
            if reg is None:
                return False
            ttl = ttl if ttl is not None else self.default_ttl
            reg.expires_at = time.time() + ttl if ttl else float("inf")
            return True

    def deregister(self, client_id: str) -> None:
        with self._lock:
            self._data.pop(client_id, None)
            watchers = list(self._watchers)
        for w in watchers:
            w(client_id, None)

    def lookup(self, client_id: str) -> Optional[Registration]:
        self._expire()
        with self._lock:
            return self._data.get(client_id)

    def list(self) -> List[Registration]:
        """All live clients — what the server queries when scaling up."""
        self._expire()
        with self._lock:
            return list(self._data.values())

    def watch(self, fn: Callable[[str, Optional[Registration]], None]) -> None:
        with self._lock:
            self._watchers.append(fn)

    def _expire(self) -> None:
        now = time.time()
        with self._lock:
            dead = [k for k, v in self._data.items() if v.expires_at < now]
            for k in dead:
                del self._data[k]
            watchers = list(self._watchers) if dead else []
        for k in dead:
            for w in watchers:
                w(k, None)


class Registor:
    """Fetches a client's (container) address and registers it (the
    *registor*: a k8s Pod sidecar or docker-gen in the paper)."""

    def __init__(self, registry: Registry, heartbeat_interval: float = 0.0):
        self.registry = registry
        self.heartbeat_interval = heartbeat_interval
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def register_service(self, client_id: str, address: Tuple[str, int],
                         **metadata) -> None:
        self.registry.register(client_id, address, **metadata)
        if self.heartbeat_interval:
            t = threading.Thread(
                target=self._beat, args=(client_id,), daemon=True)
            t.start()
            self._threads.append(t)

    def _beat(self, client_id: str) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            if not self.registry.heartbeat(client_id):
                return

    def stop(self) -> None:
        self._stop.set()

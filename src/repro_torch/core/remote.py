"""Remote training services (paper §VII): server/client as RPC services.

``RemoteClient`` wraps a :class:`Client` behind an RPC server and registers
itself with the service registry (the registor role).  ``RemoteServer``
queries the registry for live clients, fans training requests out in
parallel (asynchronous requests, Fig. 4a), and runs the same stage pipeline
as the standalone runtime — the training-flow abstraction decouples training
from communication, so this file contains *no* algorithm logic.

Messages carry numpy arrays (the reference's wire, ``repro.core.remote``),
so port and reference services mix.  Each side moves them to its device
at the boundary, one copy a leaf: a client trains on tensors on its
device, and the server's aggregation (K1 under
``resources.aggregation_kernel``) reads updates already in device memory.
Every device is explicit, never the calling thread's current one: the
RPC handlers run in threads of their own, and take turns on their
device (:meth:`RemoteClient._handle`).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.comm.serialize import estimate_message_bytes
from repro_torch.comm.transport import (
    RPCServer, SocketTransport, parallel_requests,
)
from repro_torch.core import compression as comp
from repro_torch.core.aggregation import weighted_train_loss
from repro_torch.core.client import Client
from repro_torch.core.config import Config
from repro_torch.core.server import Server
from repro_torch.deploy.discovery import Registry
from repro_torch.kernels.ops import get_device
from repro_torch.tracking import Tracker
from repro_torch.utils.capture import device_lock
from repro_torch.utils.tree import tree_map

# shared in-process registry default (a real deploy points at etcd/k8s DNS)
DEFAULT_REGISTRY = Registry()


class RemoteClient:
    """Client service: start_client(args)."""

    def __init__(self, client: Client, registry: Optional[Registry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 latency: float = 0.0):
        self.client = client
        self.registry = registry or DEFAULT_REGISTRY
        self.latency = latency
        self.device = get_device()     # fixed here: handlers run in threads
        self.rpc = RPCServer(self._handle, host=host, port=port)

    def start(self) -> "RemoteClient":
        self.rpc.start()
        # registor: fetch own address, register with the registry (Fig. 4b)
        self.registry.register(self.client.client_id, self.rpc.address,
                               role="client")
        return self

    def stop(self) -> None:
        self.registry.deregister(self.client.client_id)
        self.rpc.stop()

    def _handle(self, method: str, payload: Any) -> Any:
        """One request, on a thread of the RPC server.  A handler's work
        on the device (the upload, the client's stages, the download)
        runs under the device's lock: one handler at a time on a device,
        whose captured steps (``core/local_train.py``) neither share
        their buffers nor capture or replay beside another thread's
        work."""
        if self.latency:
            time.sleep(self.latency)
        if method == "train":
            with device_lock(self.device):
                msg = dict(payload["payload"])
                msg["params"] = _to_device(msg["params"], self.device)
                result = self.client.run_round(msg, payload["round_id"])
                return _to_numpy(result)
        if method == "test":
            with device_lock(self.device):
                params = comp.decompress(_to_device(payload["params"],
                                                    self.device))
                return self.client.test(params)
        if method == "ping":
            return {"client_id": self.client.client_id, "ok": True}
        raise ValueError(f"unknown method {method}")


class RemoteServer:
    """Server service: start_server(args)."""

    def __init__(self, server: Server, cfg: Config,
                 registry: Optional[Registry] = None,
                 tracker: Optional[Tracker] = None):
        self.server = server
        self.cfg = cfg
        self.registry = registry or DEFAULT_REGISTRY
        self.tracker = tracker or Tracker()
        self.device = get_device()
        self.transports: Dict[str, SocketTransport] = {}
        self.history: List[Dict[str, float]] = []

    def start(self) -> "RemoteServer":
        """Initialize the params as ``Trainer.run`` does (from
        ``cfg.seed`` on the server's device), unless already set."""
        if self.server.params is None:
            gen = torch.Generator().manual_seed(self.cfg.seed)
            self.server.params = self.server.model.init(gen, self.device)
        return self

    def discover(self) -> List[str]:
        """Query the registry for live clients; connect transports."""
        regs = [r for r in self.registry.list()
                if r.metadata.get("role") == "client"]
        for r in regs:
            if r.client_id not in self.transports:
                self.transports[r.client_id] = SocketTransport(r.address)
        return sorted(r.client_id for r in regs)

    def run_round(self, round_id: int) -> Dict[str, float]:
        client_ids = self.discover()
        selected = self.server.selection(client_ids, round_id)
        payload = self.server.distribution(selected)
        wire = {"payload": _to_numpy(payload), "round_id": round_id}
        t0 = time.perf_counter()
        transports = [self.transports[c] for c in selected]
        results = parallel_requests(transports, "train",
                                    [wire] * len(selected))
        dist_latency = time.perf_counter() - t0
        results = [_update_to_device(r, self.device) for r in results]
        self.server.aggregation(results)
        metrics = {
            "round_time": dist_latency,
            "clients": len(selected),
            "comm_down_bytes": _wire_bytes(wire) * len(selected),
            # after the aggregation, as the reference counts (a buffering
            # server's bookkeeping keys included)
            "comm_up_bytes": sum(_wire_bytes(r) for r in results),
            "train_loss": weighted_train_loss(results),
        }
        metrics.update(self.server.test())
        self.tracker.track_round(self.cfg.task_id, round_id, **metrics)
        self.history.append(metrics)
        return metrics

    def run(self, rounds: Optional[int] = None) -> List[Dict[str, float]]:
        for r in range(rounds or self.cfg.server.rounds):
            self.run_round(r)
        self.server.finalize()    # buffered aggregators (FedBuff) flush here
        return self.history

    def stop(self) -> None:
        for t in self.transports.values():
            t.close()


def _to_numpy(tree):
    """Tensors (any device) -> host numpy arrays; every other leaf as it
    is.  Dicts come back in sorted key order, as the reference's
    ``jax.tree_util.tree_map`` gives them, so messages match its bytes."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def _to_device(tree, device: torch.device):
    """Arrays -> tensors on ``device``, one host-to-device copy a leaf."""
    return tree_map(lambda x: torch.as_tensor(x, device=device)
                    if isinstance(x, (np.ndarray, torch.Tensor)) else x,
                    tree)


def _update_to_device(result: Dict[str, Any], device: torch.device):
    """A client's result with its update on ``device``."""
    out = dict(result)
    out["update"] = _to_device(result["update"], device)
    return out


def _wire_bytes(tree) -> int:
    """O(number of leaves) message-size accounting, without serializing;
    compressed leaves fall back to the compression-aware accounting."""
    try:
        return estimate_message_bytes(tree)
    except TypeError:
        return comp.payload_bytes(tree)

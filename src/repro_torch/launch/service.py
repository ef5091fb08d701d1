"""Container entrypoint (the Dockerfile's ``python -m
repro_torch.launch.service``).

One image, four roles (paper §VII deployment):

    service server   --registry host:2379 [--tracker host:9000] [--rounds N]
    service client   --client-id client_0003 --registry host:2379
    service registry --port 2379
    service tracker  --port 9000

``registry`` serves the etcd-like discovery KV over the socket RPC
protocol; ``tracker`` is the remote-tracking service (§V-C); server/client
wrap :class:`repro_torch.core.remote.RemoteServer` / ``RemoteClient`` and
run on ``repro_torch.get_device()`` (the CUDA card; without one they
raise).  Registry and tracker are host code and never initialize CUDA.
Every role prints one line when it is up ("... listening on host:port",
"client ... on host:port", naming its device), and a serving role one
more when it is stopped by an interrupt; the server prints its result as
one JSON line.  On a cluster each role runs in its own container
(``repro_torch.deploy.manifests``); locally the same module wires them over
127.0.0.1.  Flags and messages are the reference's
(``repro.launch.service``), so port and reference services mix.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Tuple

import torch

from repro_torch.comm.transport import RPCServer, SocketTransport
from repro_torch.deploy.discovery import Registration, Registry
from repro_torch.tracking import Tracker


# ---------------------------------------------------------------------------
# registry service: the discovery KV behind an RPC boundary
# ---------------------------------------------------------------------------


class RegistryService:
    def __init__(self, host="127.0.0.1", port=0, default_ttl=None):
        self.registry = Registry(default_ttl=default_ttl)
        self.rpc = RPCServer(self._handle, host=host, port=port)

    def start(self):
        self.rpc.start()
        return self

    def stop(self):
        self.rpc.stop()

    @property
    def address(self):
        return self.rpc.address

    def _handle(self, method: str, p: Any) -> Any:
        if method == "register":
            self.registry.register(p["client_id"], tuple(p["address"]),
                                   **p.get("metadata", {}))
            return {"ok": True}
        if method == "heartbeat":
            return {"ok": self.registry.heartbeat(p["client_id"])}
        if method == "deregister":
            self.registry.deregister(p["client_id"])
            return {"ok": True}
        if method == "list":
            return {"clients": [
                {"client_id": r.client_id, "address": list(r.address),
                 "metadata": r.metadata} for r in self.registry.list()]}
        raise ValueError(method)


class RemoteRegistry:
    """Registry client facade with the in-process Registry interface, so
    RemoteServer/RemoteClient work against a registry *service*."""

    def __init__(self, address: Tuple[str, int]):
        self._t = SocketTransport(address)

    def register(self, client_id, address, ttl=None, **metadata):
        self._t.request("register", {"client_id": client_id,
                                     "address": list(address),
                                     "metadata": metadata})

    def heartbeat(self, client_id, ttl=None):
        return self._t.request("heartbeat", {"client_id": client_id})["ok"]

    def deregister(self, client_id):
        self._t.request("deregister", {"client_id": client_id})

    def list(self):
        return [Registration(c["client_id"], tuple(c["address"]),
                             c["metadata"])
                for c in self._t.request("list", {})["clients"]]

    def close(self):
        self._t.close()


# ---------------------------------------------------------------------------
# tracker service: remote tracking (§V-C) over the same RPC protocol
# ---------------------------------------------------------------------------


class TrackerService:
    def __init__(self, host="127.0.0.1", port=0, backend="memory",
                 out_dir="artifacts/tracking"):
        self.tracker = Tracker(backend=backend, out_dir=out_dir)
        self.rpc = RPCServer(self._handle, host=host, port=port)

    def start(self):
        self.rpc.start()
        return self

    def stop(self):
        self.rpc.stop()

    @property
    def address(self):
        return self.rpc.address

    def _handle(self, method: str, p: Any) -> Any:
        if method == "create_task":
            self.tracker.create_task(p["task_id"], p.get("config"))
            return {"ok": True}
        if method == "track_round":
            self.tracker.track_round(p["task_id"], p["round"], **p["metrics"])
            return {"ok": True}
        if method == "track_client":
            self.tracker.track_client(p["task_id"], p["round"], p["client"],
                                      **p["metrics"])
            return {"ok": True}
        if method == "round_series":
            return {"series": self.tracker.round_series(p["task_id"],
                                                        p["key"])}
        if method == "summary":
            return self.tracker.summary(p["task_id"])
        raise ValueError(method)


class RemoteTracker:
    """Tracker facade forwarding to a tracker service (remote tracking)."""

    def __init__(self, address: Tuple[str, int]):
        self._t = SocketTransport(address)

    def create_task(self, task_id, config=None):
        self._t.request("create_task", {"task_id": task_id, "config":
                                        _jsonable(config)})

    def track_round(self, task_id, round_id, **metrics):
        self._t.request("track_round", {"task_id": task_id,
                                        "round": round_id,
                                        "metrics": _jsonable(metrics)})

    def track_client(self, task_id, round_id, client_id, **metrics):
        self._t.request("track_client", {"task_id": task_id,
                                         "round": round_id,
                                         "client": client_id,
                                         "metrics": _jsonable(metrics)})

    def round_series(self, task_id, key):
        return self._t.request("round_series", {"task_id": task_id,
                                                "key": key})["series"]

    def summary(self, task_id):
        return self._t.request("summary", {"task_id": task_id})

    def close(self):
        self._t.close()


def _jsonable(tree):
    if tree is None:
        return {}
    return json.loads(json.dumps(tree, default=float))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_addr(s: str) -> Tuple[str, int]:
    host, port = s.rsplit(":", 1)
    return host, int(port)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.service")
    ap.add_argument("role", choices=["server", "client", "registry",
                                     "tracker"])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--registry", default="", help="host:port")
    ap.add_argument("--tracker", default="", help="host:port")
    ap.add_argument("--client-id", default="client_0000")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--config", default="", help="json config string/file")
    ap.add_argument("--oneshot", action="store_true",
                    help="exit after the run (tests); default serves forever")
    args = ap.parse_args(argv)

    configs: Dict[str, Any] = {}
    if args.config:
        try:
            configs = json.loads(args.config)
        except json.JSONDecodeError:
            with open(args.config) as f:
                configs = json.load(f)

    if args.role in ("registry", "tracker"):
        cls = RegistryService if args.role == "registry" else TrackerService
        svc = cls(host=args.host, port=args.port).start()
        print(f"{args.role} listening on {svc.address[0]}:{svc.address[1]} "
              f"(device: host)", flush=True)
        _serve_forever(args, svc)
        return svc

    import repro_torch as easyfl
    easyfl.init(configs)
    registry = RemoteRegistry(_parse_addr(args.registry)) \
        if args.registry else None

    if args.role == "client":
        svc = easyfl.start_client({"client_id": args.client_id,
                                   "registry": registry,
                                   "host": args.host, "port": args.port})
        print(f"client {args.client_id} on "
              f"{svc.rpc.address[0]}:{svc.rpc.address[1]} "
              f"(device: {svc.device})", flush=True)
        _serve_forever(args, svc)
        return svc

    # server
    srv = easyfl.start_server({"registry": registry} if registry else {})
    if args.tracker:
        srv.tracker = RemoteTracker(_parse_addr(args.tracker))
        srv.tracker.create_task(srv.cfg.task_id, configs)
    rounds = args.rounds or None
    hist = srv.run(rounds)
    print(json.dumps({"rounds": len(hist), "final": hist[-1] if hist else {},
                      "device": str(srv.device)}, default=float), flush=True)
    srv.stop()
    return srv


def _serve_forever(args, svc):
    if args.oneshot:
        return
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        svc.stop()
        print(f"stopped (cuda initialized: {torch.cuda.is_initialized()})",
              flush=True)


if __name__ == "__main__":
    main()

"""Remote training and deployment (paper §VII) of ``repro_torch`` against the
reference: the transports, discovery, the deployment artifacts,
``start_client`` / ``start_server`` (``RemoteServer.run``), mixed port and
reference services, and the service CLI (``repro_torch.launch.service``).

Arrays cross between the packages as numpy; the port's initial params are
the reference's (``convert.params_from_jax``).  Bars: params within 1e-5,
``train_loss`` and ``accuracy`` within 1e-4 (the reference's
engine-parity tolerances); ``clients`` and the wire byte counters exact.
Against the port's own sequential run the remote run is bit for bit.
Every test stops its services in ``finally``.
"""
import dataclasses
import json
import os
import socket
import sys
import threading
import time

import jax
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import repro as ref  # noqa: E402
import repro_torch as pt  # noqa: E402
from repro.comm import transport as ref_transport  # noqa: E402
from repro.core.client import Client as RefClient  # noqa: E402
from repro.core.strategies import FedBuffServer as RefFedBuffServer  # noqa: E402
from repro.deploy.discovery import Registry as RefRegistry  # noqa: E402
from repro.launch import service as ref_service  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comm.transport import (  # noqa: E402
    InProcessTransport, RPCServer, SocketTransport, _recv_exact,
    parallel_requests,
)
from repro_torch.core import api as pt_api  # noqa: E402
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.core.remote import RemoteServer  # noqa: E402
from repro_torch.core.strategies import FedBuffServer  # noqa: E402
from repro_torch.deploy import (  # noqa: E402
    Registor, Registry, compose, dockerfile, k8s_manifests, write_artifacts,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import service as svc  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

pt.set_device("cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are small, and
    under a loaded parallel test run torch's thread pool made such runs
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    ref.reset()
    pt.reset()
    yield
    ref.reset()
    pt.reset()


LINEAR = {
    "model": "linear",
    "data": {"dataset": "synthetic", "num_clients": 3, "batch_size": 32},
    "server": {"rounds": 2, "clients_per_round": 2},
    "client": {"local_epochs": 1, "lr": 0.1},
}
FEMNIST = {
    "model": "femnist_cnn",
    "data": {"dataset": "femnist", "num_clients": 3, "data_amount": 0.01,
             "batch_size": 16},
    "server": {"rounds": 2, "clients_per_round": 2},
    "client": {"local_epochs": 1, "lr": 0.003},
}
CONFIGS = {"linear": LINEAR, "femnist_cnn": FEMNIST}
IDS = [f"client_{i:04d}" for i in range(3)]
TEST_CUT = 256     # femnist's held-out samples each evaluation reads


def _init(api, cfg):
    """``api.init(cfg)``; a femnist run evaluates on the first
    ``TEST_CUT`` held-out samples (in both packages alike): at the CPU
    tests' size the 4,000-sample evaluation took most of a round."""
    api.init(cfg)
    if cfg["model"] == "femnist_cnn":
        ctx = api.core.api._ctx
        test = ctx.fed_data.test
        ctx.fed_data = dataclasses.replace(ctx.fed_data, test=type(test)(
            test.x[:TEST_CUT], test.y[:TEST_CUT]))


def _echo(method, payload):
    return {"method": method, "payload": payload}


def _boom(method, payload):
    raise RuntimeError("client exploded mid-round")


# ---------------------------------------------------------------------------
# transports (tests/test_transport.py, tests/test_tracking_and_infra.py)
# ---------------------------------------------------------------------------


def test_inprocess_roundtrip_tracks_stats_and_latency():
    tr = InProcessTransport(_echo, latency=0.01)
    out = tr.request("train", {"x": np.arange(3, dtype=np.float32)})
    assert out["method"] == "train"
    np.testing.assert_array_equal(out["payload"]["x"],
                                  np.arange(3, dtype=np.float32))
    assert tr.stats.requests == 1
    assert tr.stats.bytes_sent > 0 and tr.stats.bytes_received > 0
    assert tr.stats.total_latency >= 0.01   # injected network latency


def test_inprocess_transport_serializes_both_ways():
    tr = InProcessTransport(lambda m, p: {"echo": p["x"] * 2})
    out = tr.request("f", {"x": np.ones(4, np.float32)})
    np.testing.assert_array_equal(out["echo"], 2 * np.ones(4))
    assert tr.stats.bytes_sent > 0 and tr.stats.bytes_received > 0


def test_inprocess_handler_error_propagates():
    tr = InProcessTransport(_boom)
    with pytest.raises(RuntimeError, match="exploded"):
        tr.request("train", {})
    # a failed request is not silently counted as delivered
    assert tr.stats.requests == 0


@pytest.mark.parametrize("handler,field,want", [
    (_echo, "payload", [{"i": 0}, {"i": 1}, {"i": 2}]),
    (lambda m, p: {"sq": p["i"] ** 2}, "sq", [0, 1, 4]),
], ids=["echo", "square"])
def test_socket_parallel_requests_answer_in_input_order(handler, field,
                                                        want):
    server = RPCServer(handler).start()
    trs = []
    try:
        trs = [SocketTransport(server.address) for _ in range(3)]
        outs = parallel_requests(trs, "ping", [{"i": i} for i in range(3)])
        assert [o[field] for o in outs] == want
        assert all(t.stats.requests == 1 for t in trs)
    finally:
        for t in trs:
            t.close()
        server.stop()


def test_server_dying_mid_request_raises_connection_error():
    """A server that accepts, reads part of the request, then dies: the
    reply stream ends mid-message and surfaces as ``ConnectionError``."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def drop():
        conn, _ = lsock.accept()
        conn.recv(16)
        conn.close()

    th = threading.Thread(target=drop, daemon=True)
    th.start()
    tr = SocketTransport(lsock.getsockname())
    try:
        with pytest.raises((ConnectionError, OSError)):
            tr.request("ping", {"i": 2})
    finally:
        tr.close()
        lsock.close()
        th.join(timeout=5)
    assert not th.is_alive()


def test_socket_request_after_local_close_raises():
    server = RPCServer(_echo).start()
    try:
        tr = SocketTransport(server.address)
        tr.close()
        with pytest.raises(OSError):
            tr.request("ping", {})
        tr.close()   # close is idempotent
    finally:
        server.stop()


def test_recv_exact_raises_on_truncated_stream():
    a, b = socket.socketpair()
    try:
        a.sendall(b"abc")
        a.close()               # stream ends before the 8 requested bytes
        with pytest.raises(ConnectionError, match="socket closed"):
            _recv_exact(b, 8)
    finally:
        b.close()


def test_large_message_crosses_the_wire_intact_both_ways():
    """A 4 MB array through a port server from a reference client and the
    other way round: the echo comes back as it was sent, frame for frame."""
    x = np.random.RandomState(0).randn(1 << 20).astype(np.float32)
    for server_cls, tr_cls in ((RPCServer, ref_transport.SocketTransport),
                               (ref_transport.RPCServer, SocketTransport)):
        server = server_cls(_echo).start()
        tr = tr_cls(server.address)
        try:
            out = tr.request("big", {"x": x})
            np.testing.assert_array_equal(out["payload"]["x"], x)
            assert tr.stats.bytes_sent == tr.stats.bytes_received
        finally:
            tr.close()
            server.stop()


def test_socket_transport_is_thread_safe_under_contention():
    """The per-transport lock serializes request/reply pairs: concurrent
    callers on ONE socket never interleave frames (16 threads, a switch
    interval of 1 us)."""
    server = RPCServer(_echo).start()
    tr = SocketTransport(server.address)
    old = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        outs = [None] * 16

        def hit(i):
            outs[i] = tr.request("ping", {"i": i})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert [o["payload"]["i"] for o in outs] == list(range(16))
        assert tr.stats.requests == 16
    finally:
        sys.setswitchinterval(old)
        tr.close()
        server.stop()


class _Exploding(Client):
    def train(self, params, round_id):
        raise RuntimeError("client exploded mid-round")


def test_a_failing_client_makes_the_fan_out_and_the_round_raise():
    """A request that fails is never a silent ``None``: the port's
    ``parallel_requests`` re-raises the handler's error in process and a
    ``ConnectionError`` naming the address over a socket, and so
    ``RemoteServer.run_round`` raises.  The reference's fan-out leaves
    ``None`` in that slot (ROADMAP queue 3)."""
    good = InProcessTransport(_echo)
    with pytest.raises(RuntimeError, match="exploded"):
        parallel_requests([good, InProcessTransport(_boom)], "train",
                          [{}, {}])
    server = RPCServer(_boom).start()
    trs = [SocketTransport(server.address) for _ in range(2)]
    try:
        with pytest.raises(ConnectionError,
                           match=str(server.address[1])):
            parallel_requests(trs, "train", [{}, {}])
    finally:
        for t in trs:
            t.close()
        server.stop()

    ref_server = ref_transport.RPCServer(_boom).start()
    ref_good = ref_transport.RPCServer(_echo).start()
    trs = [ref_transport.SocketTransport(ref_good.address),
           ref_transport.SocketTransport(ref_server.address)]
    try:
        out = ref_transport.parallel_requests(trs, "train", [{}, {}])
        assert out[0] is not None and out[1] is None
    finally:
        for t in trs:
            t.close()
        ref_server.stop()
        ref_good.stop()

    pt.init(LINEAR)
    pt.register_client(_Exploding)
    reg = Registry()
    clients = [pt.start_client({"client_id": c, "registry": reg})
               for c in IDS]
    srv = pt.start_server({"registry": reg})
    try:
        with pytest.raises(ConnectionError, match="'train' request"):
            srv.run_round(0)
        assert srv.history == []
    finally:
        for c in clients:
            c.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# discovery and manifests (tests/test_tracking_and_infra.py)
# ---------------------------------------------------------------------------


def test_registry_register_lookup_deregister():
    reg = Registry()
    reg.register("c0", ("127.0.0.1", 5000), role="client")
    assert reg.lookup("c0").address == ("127.0.0.1", 5000)
    assert len(reg.list()) == 1
    reg.deregister("c0")
    assert reg.lookup("c0") is None


def test_registry_ttl_expiry():
    reg = Registry(default_ttl=0.05)
    reg.register("c0", ("127.0.0.1", 5000))
    assert reg.lookup("c0") is not None
    time.sleep(0.08)
    assert reg.lookup("c0") is None     # dropped out (paper: clients churn)
    reg.register("c1", ("127.0.0.1", 5001))
    assert reg.heartbeat("c1")
    assert not reg.heartbeat("c0")


def test_registry_watch_events():
    reg = Registry()
    events = []
    reg.watch(lambda cid, r: events.append((cid, r is not None)))
    reg.register("c0", ("h", 1))
    reg.deregister("c0")
    assert events == [("c0", True), ("c0", False)]


def test_registor_registers_service():
    reg = Registry()
    r = Registor(reg)
    r.register_service("c9", ("10.0.0.9", 1234), role="client")
    assert reg.lookup("c9").metadata["role"] == "client"


def test_manifests_structurally_valid(tmp_path):
    """The reference's structure case, plus the port's image: a CUDA devel
    base, the port's entry point, only files the repository has, one GPU
    for the server and each client, none for registry and tracker."""
    df = dockerfile()
    assert "-devel" in df.splitlines()[0] and "cuda" in df.splitlines()[0]
    assert 'ENTRYPOINT ["python", "-m", "repro_torch.launch.service"]' in df
    assert "PYTHONPATH=/app/src" in df and "REPRO_TORCH_BUILD_DIR" in df
    assert "pyproject.toml" not in df and "pip install -e" not in df
    for line in df.splitlines():
        if line.startswith("COPY "):
            assert os.path.exists(os.path.join(ROOT, line.split()[1])), line
    c = compose(num_clients=3, network_latency_ms=20)
    assert len([s for s in c["services"] if s.startswith("client")]) == 3
    assert "cap_add" in c["services"]["client0"]
    for name, s in c["services"].items():
        gpus = s.get("deploy", {}).get("resources", {}).get(
            "reservations", {}).get("devices", [])
        want = name == "server" or name.startswith("client")
        assert [d["count"] for d in gpus] == ([1] if want else []), name
    ms = k8s_manifests(num_clients=5)
    kinds = [m["kind"] for m in ms]
    assert kinds.count("Deployment") == 2
    client_dep = [m for m in ms if m["metadata"]["name"] == "easyfl-client"][0]
    assert client_dep["spec"]["replicas"] == 5
    env = client_dep["spec"]["template"]["spec"]["containers"][0]["env"]
    assert any(e["name"] == "POD_IP" for e in env)   # downward-API registor
    for m in ms:
        if m["kind"] == "Deployment":
            (ct,) = m["spec"]["template"]["spec"]["containers"]
            assert ct["resources"]["limits"]["nvidia.com/gpu"] == 1
    paths = write_artifacts(str(tmp_path), 2)
    for p in paths:
        assert os.path.exists(p)
    with open(os.path.join(str(tmp_path), "k8s.yaml")) as f:
        docs = list(yaml.safe_load_all(f))
    assert len(docs) == 3
    with open(os.path.join(str(tmp_path), "docker-compose.yaml")) as f:
        assert yaml.safe_load(f) == compose(2)


def test_manifests_pass_the_reference_flags_the_cli_does_not_define():
    """Reference caveat (ROADMAP queue 3), ported as it is: the k8s client
    passes ``--server`` and the compose client with latency
    ``--netem-latency-ms``, flags neither package's service CLI defines."""
    for main in (svc.main, ref_service.main):
        for flag in (["--server", "easyfl-server:8000"],
                     ["--netem-latency-ms", "20"]):
            with pytest.raises(SystemExit):
                main(["client", "--oneshot"] + flag)


# ---------------------------------------------------------------------------
# thread-safe kernel loading
# ---------------------------------------------------------------------------


def test_concurrent_first_use_builds_and_loads_a_library_once(monkeypatch):
    """Client services first use a kernel from several threads at once:
    ``build.load`` builds and loads each library once."""
    builds, loads = [], []

    def fake_build_all(names):
        builds.append(list(names))
        time.sleep(0.05)           # a build takes time: others arrive

    class _Lib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, fn):
            ns = type("Fn", (), {})()
            object.__setattr__(self, fn, ns)
            return ns

    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", _Lib)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", "/nonexistent-build-dir")
    start = threading.Barrier(8)
    got = [None] * 8

    def first_use(i):
        start.wait(timeout=10)
        got[i] = build.load("fedavg_agg")

    threads = [threading.Thread(target=first_use, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["fedavg_agg"]] and len(loads) == 1
    assert all(g is got[0] for g in got)


# ---------------------------------------------------------------------------
# remote training against the reference
# ---------------------------------------------------------------------------


def _ref_init(cfg):
    """The reference's initial params of ``cfg`` as numpy."""
    from repro.core.config import Config as RefConfig
    from repro.models.registry import get_model as ref_get_model
    rcfg = RefConfig.make(cfg)
    return jax.tree_util.tree_map(np.asarray, ref_get_model(rcfg.model).init(
        jax.random.PRNGKey(rcfg.seed)))


def _ref_clients(ids, registry):
    return [ref.start_client({"client_id": c, "registry": registry})
            for c in ids]


def _port_clients(ids, registry):
    return [pt.start_client({"client_id": c, "registry": registry})
            for c in ids]


def _run_remote(package, p0, clients_of, registry, rounds):
    """Start ``package``'s server over ``registry`` (clients already
    started by ``clients_of``) from ``p0`` -> (history, params as numpy)."""
    api = ref if package == "ref" else pt
    srv = api.start_server({"registry": registry})
    if package == "ref":
        srv.server.params = jax.tree_util.tree_map(jax.numpy.asarray, p0)
    else:
        srv.server.params = convert.params_from_jax(p0)
    try:
        hist = srv.run(rounds)
    finally:
        srv.stop()
        for c in clients_of:
            c.stop()
    if package == "ref":
        leaves = [np.asarray(x) for x in
                  jax.tree_util.tree_leaves(srv.server.params)]
    else:
        leaves = [x.numpy() for x in tree_leaves(srv.server.params)]
    return hist, leaves


def _pinned(client_cls):
    """``client_cls`` with each client's ``train_time`` pinned: FedBuff's
    staleness compares measured times, which differ run to run."""
    class Pinned(client_cls):
        def train(self, params, round_id):
            out = super().train(params, round_id)
            out["train_time"] = 0.1 * (1 + IDS.index(self.client_id))
            return out
    return Pinned


def _remote(package, cfg, p0, fedbuff=False):
    """``package``'s remote run of ``cfg`` (3 clients, 2 rounds) from
    ``p0``; ``fedbuff`` registers its ``FedBuffServer`` and pinned
    clients."""
    api = ref if package == "ref" else pt
    _init(api, cfg)
    if fedbuff:
        api.register_server(RefFedBuffServer if package == "ref"
                            else FedBuffServer)
        api.register_client(_pinned(RefClient if package == "ref"
                                    else Client))
    reg = RefRegistry() if package == "ref" else Registry()
    clients = (_ref_clients if package == "ref" else _port_clients)(IDS,
                                                                    reg)
    return _run_remote(package, p0, clients, reg, 2)


def _assert_close(ref_out, port_out, exact=("clients", "comm_up_bytes",
                                            "comm_down_bytes")):
    (h_ref, p_ref), (h_port, p_port) = ref_out, port_out
    for a, b in zip(p_ref, p_port):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    assert [list(h) for h in h_port] == [list(h) for h in h_ref]
    for key in ("train_loss", "accuracy", "loss"):
        np.testing.assert_allclose([h[key] for h in h_port],
                                   [h[key] for h in h_ref],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    for key in exact:
        assert [h[key] for h in h_port] == [h[key] for h in h_ref], key


@pytest.mark.parametrize("model,server", [
    ("linear", "fedavg"), ("femnist_cnn", "fedavg"), ("linear", "fedbuff"),
])
def test_remote_run_matches_the_reference(model, server):
    """``start_client`` x 3 and ``start_server().run(2)`` in both packages
    from the reference's init: the same params, losses, accuracy, and the
    same wire bytes (FedBuff's bookkeeping key counted as the reference
    counts it)."""
    cfg = CONFIGS[model]
    p0 = _ref_init(cfg)
    fedbuff = server == "fedbuff"
    _assert_close(_remote("ref", cfg, p0, fedbuff),
                  _remote("port", cfg, p0, fedbuff))


@pytest.mark.parametrize("model", ["linear", "femnist_cnn"])
def test_remote_run_is_the_sequential_run_bit_for_bit(model):
    """The port's remote run ends at its own ``init(); run()`` params bit
    for bit, with equal losses and accuracy — what the reference shows of
    itself.  Only the byte counters differ: remote counts wire messages."""
    cfg = CONFIGS[model]
    _init(pt, cfg)
    seq = pt.run()
    pt.reset()
    _init(pt, cfg)
    reg = Registry()
    clients = _port_clients(IDS, reg)
    srv = pt.start_server({"registry": reg})
    try:
        hist = srv.run(2)
    finally:
        srv.stop()
        for c in clients:
            c.stop()
    for a, b in zip(tree_leaves(seq["params"]),
                    tree_leaves(srv.server.params)):
        assert torch.equal(a, b)
    for key in ("train_loss", "accuracy", "loss", "clients"):
        assert [h[key] for h in hist] == \
            [h[key] for h in seq["history"]], key


@pytest.mark.parametrize("server", ["port", "ref"])
def test_mixed_deployment_trains_as_the_reference(server):
    """One port ``RegistryService``; a reference client registers through
    the reference's ``RemoteRegistry`` facade beside port clients (under
    the port's server), or a port client beside reference clients (under
    the reference's server).  The mixed cohort ends within 1e-5 of the
    all-reference run."""
    cfg = LINEAR
    p0 = _ref_init(cfg)
    want = _remote("ref", cfg, p0)
    ref.reset()
    _init(ref, cfg)
    _init(pt, cfg)
    registry = svc.RegistryService().start()
    facades = [svc.RemoteRegistry(registry.address),
               ref_service.RemoteRegistry(registry.address)]
    port_ids, ref_ids = ((IDS[1:], IDS[:1]) if server == "port"
                         else (IDS[:1], IDS[1:]))
    try:
        clients = (_port_clients(port_ids, facades[0])
                   + _ref_clients(ref_ids, facades[1]))
        assert sorted(r.client_id for r in facades[0].list()) == IDS
        got = _run_remote(server, p0, clients, facades[0], 2)
    finally:
        for f in facades:
            f.close()
        registry.stop()
    _assert_close(want, got)


def test_client_test_and_ping_methods_answer_as_the_reference():
    cfg = LINEAR
    p0 = _ref_init(cfg)
    _init(ref, cfg)
    _init(pt, cfg)
    reg = Registry()
    (port_c,) = _port_clients(IDS[:1], reg)
    (ref_c,) = _ref_clients(IDS[:1], RefRegistry())
    trs = [SocketTransport(port_c.rpc.address),
           SocketTransport(ref_c.rpc.address)]
    try:
        got, want = (t.request("test", {"params": p0}) for t in trs)
        assert list(got) == list(want)
        np.testing.assert_allclose([got[k] for k in want],
                                   [want[k] for k in want], rtol=1e-5)
        assert trs[0].request("ping", {}) == trs[1].request("ping", {})
    finally:
        for t in trs:
            t.close()
        port_c.stop()
        ref_c.stop()


# ---------------------------------------------------------------------------
# service CLI (tests/test_service_cli.py)
# ---------------------------------------------------------------------------


def test_full_deployment_topology():
    cfg_json = json.dumps({
        "model": "linear", "dataset": "synthetic",
        "data": {"num_clients": 3, "batch_size": 32},
        "server": {"rounds": 2, "clients_per_round": 2},
        "client": {"local_epochs": 1, "lr": 0.1},
    })
    registry = svc.main(["registry", "--oneshot"])
    tracker = svc.main(["tracker", "--oneshot"])
    reg_addr = f"{registry.address[0]}:{registry.address[1]}"
    trk_addr = f"{tracker.address[0]}:{tracker.address[1]}"
    clients = []
    try:
        for cid in IDS:
            clients.append(svc.main([
                "client", "--client-id", cid,
                "--registry", reg_addr, "--config", cfg_json, "--oneshot"]))
        assert all(c.device == torch.device("cpu") for c in clients)
        rr = svc.RemoteRegistry(svc._parse_addr(reg_addr))
        names = sorted(r.client_id for r in rr.list())
        rr.close()
        assert names == IDS

        server = svc.main(["server", "--registry", reg_addr,
                           "--tracker", trk_addr, "--config", cfg_json,
                           "--rounds", "2", "--oneshot"])
        assert len(server.history) == 2
        assert server.history[-1]["accuracy"] > 0.2
        rt = svc.RemoteTracker(svc._parse_addr(trk_addr))
        series = rt.round_series(server.cfg.task_id, "accuracy")
        rt.close()
        assert len(series) == 2
    finally:
        for c in clients:
            c.stop()
        registry.stop()
        tracker.stop()


def test_registry_service_roundtrip():
    registry = svc.main(["registry", "--oneshot"])
    try:
        rr = svc.RemoteRegistry(registry.address)
        rr.register("cX", ("10.0.0.1", 5555), role="client")
        assert rr.heartbeat("cX")
        regs = rr.list()
        assert regs[0].address == ("10.0.0.1", 5555)
        rr.deregister("cX")
        assert rr.list() == []
        rr.close()
    finally:
        registry.stop()


# ---------------------------------------------------------------------------
# semantics (tests/test_round_semantics.py) and what the wire cannot carry
# ---------------------------------------------------------------------------


def test_remote_server_run_flushes_buffered_aggregators(monkeypatch):
    """``RemoteServer.run`` finalizes the server, so FedBuff leftovers are
    not dropped in the service deployment path."""
    pt.init({"model": "linear", "dataset": "synthetic",
             "data": {"num_clients": 4, "batch_size": 32},
             "tracking": {"enabled": False}})
    ctx = pt_api._ctx
    srv = FedBuffServer(ctx.model, ctx.config, ctx.fed_data.test)
    srv.params = ctx.model.init(torch.Generator().manual_seed(0), "cpu")
    zero = tree_map(torch.zeros_like, srv.params)
    rs = RemoteServer(srv, ctx.config, registry=Registry())
    monkeypatch.setattr(rs, "run_round", lambda r: srv.aggregation(
        [{"update": zero, "num_samples": 10, "train_time": 0.1 * i}
         for i in range(3)]))
    flushed = []
    monkeypatch.setattr(srv, "_apply", lambda b: flushed.append(len(b)))
    rs.run(rounds=1)
    assert flushed == [3]          # 3 < K=5 deferred, finalize flushed them


@pytest.mark.parametrize("section,method", [
    ("client", "stc"), ("client", "int8"), ("server", "int8"),
])
def test_compressed_remote_training_raises_at_start(section, method):
    """The wire format has no encoding for a compressed tensor: the port's
    ``start_client`` (compressed updates) or ``start_server`` (compressed
    params) refuses at start; the reference's services start, the message
    fails to serialize mid-round, and its server then fails on the
    ``None`` the fan-out left (ROADMAP queue 3)."""
    cfg = dict(LINEAR, **{section: {**LINEAR.get(section, {}),
                                    "compression": method}})
    pt.init(cfg)
    start = pt.start_client if section == "client" else pt.start_server
    with pytest.raises(ValueError, match="queue 3"):
        start({"registry": Registry()})

    ref.init(cfg)
    reg = RefRegistry()
    clients = _ref_clients(IDS, reg)
    srv = ref.start_server({"registry": reg})
    try:
        with pytest.raises(TypeError):
            srv.run(1)
    finally:
        srv.stop()
        for c in clients:
            c.stop()


def test_result_messages_have_the_reference_keys_and_types():
    """The wire parity the byte counters rest on: a port client's result
    message has the reference's keys in the reference's order and the same
    leaf types (metrics as floats, the update as f32 arrays)."""
    cfg = LINEAR
    p0 = _ref_init(cfg)
    _init(ref, cfg)
    _init(pt, cfg)
    (port_c,) = _port_clients(IDS[:1], Registry())
    (ref_c,) = _ref_clients(IDS[:1], RefRegistry())
    wire = {"payload": {"params": p0, "payload_bytes": 0}, "round_id": 0}
    trs = [SocketTransport(port_c.rpc.address),
           SocketTransport(ref_c.rpc.address)]
    try:
        got, want = (t.request("train", wire) for t in trs)
    finally:
        for t in trs:
            t.close()
        port_c.stop()
        ref_c.stop()

    def shape(tree):
        if isinstance(tree, dict):
            return [(k, shape(v)) for k, v in tree.items()]
        if isinstance(tree, np.ndarray):
            return (tree.dtype.str, tree.shape)
        return type(tree).__name__

    assert shape(got) == shape(want)
    assert trs[0].stats.bytes_received == trs[1].stats.bytes_received

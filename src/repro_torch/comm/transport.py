"""Remote-communication tier (paper §VII, Fig. 4a).

Three-tier server/client architecture: RPC <-> Protocol <-> Handler.
Two interchangeable transports with identical semantics:

* ``InProcessTransport`` — function-call loopback; still round-trips
  through the Protocol serializer so message sizes are tracked as on the
  wire.
* ``SocketTransport`` — length-prefixed messages over TCP sockets with a
  thread-per-connection server (``RPCServer``).

The wire is the reference's (``repro.comm.transport``): an 8-byte
big-endian length, then the msgpack body of :mod:`repro_torch.comm.
serialize`, so port and reference services talk to each other.  Failures
are loud and typed: ``ConnectionError`` for a dead socket, the handler's
own exception for an application error in process, and
:func:`parallel_requests` never returns ``None`` for a request that
failed.  Received messages are read into one preallocated buffer
(``recv_into``), so a 26 MB model arrives in time linear in its size.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Tuple

from repro_torch.comm import serialize

Handler = Callable[[str, Any], Any]


class Transport:
    """Message interface: request(method, payload) -> response."""

    def request(self, method: str, payload: Any) -> Any:
        raise NotImplementedError

    def close(self) -> None:
        pass


@dataclass
class TransportStats:
    requests: int = 0
    bytes_sent: int = 0
    bytes_received: int = 0
    total_latency: float = 0.0


class InProcessTransport(Transport):
    """Loopback transport; serializes both ways to emulate the wire."""

    def __init__(self, handler: Handler, latency: float = 0.0):
        self.handler = handler
        self.latency = latency
        self.stats = TransportStats()

    def request(self, method: str, payload: Any) -> Any:
        t0 = time.perf_counter()
        wire = serialize.dumps({"method": method, "payload": payload})
        self.stats.bytes_sent += len(wire)
        if self.latency:
            time.sleep(self.latency)
        msg = serialize.loads(wire)
        result = self.handler(msg["method"], msg["payload"])
        back = serialize.dumps(result)
        self.stats.bytes_received += len(back)
        self.stats.requests += 1
        self.stats.total_latency += time.perf_counter() - t0
        return serialize.loads(back)


# ---------------------------------------------------------------------------
# Socket transport
# ---------------------------------------------------------------------------


def _send_msg(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack(">Q", len(data)) + data)


def _recv_msg(sock: socket.socket) -> bytearray:
    (length,) = struct.unpack(">Q", _recv_exact(sock, 8))
    return _recv_exact(sock, length)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly ``n`` bytes, read into one buffer allocated up front;
    ``ConnectionError("socket closed")`` when the stream ends first."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("socket closed")
        got += k
    return buf


class RPCServer:
    """Thread-per-connection RPC server (the paper's *RPC Server* tier)."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 port: int = 0):
        self.handler = handler
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        data = _recv_msg(self.request)
                        msg = serialize.loads(data)
                        result = outer.handler(msg["method"], msg["payload"])
                        _send_msg(self.request, serialize.dumps(result))
                except (ConnectionError, OSError):
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self) -> "RPCServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class SocketTransport(Transport):
    """RPC client over TCP with the msgpack protocol; one connection,
    request/reply pairs serialized by a lock."""

    def __init__(self, address: Tuple[str, int], latency: float = 0.0):
        self.address = tuple(address)
        self.latency = latency
        self.stats = TransportStats()
        self._sock = socket.create_connection(self.address)
        self._lock = threading.Lock()

    def request(self, method: str, payload: Any) -> Any:
        t0 = time.perf_counter()
        wire = serialize.dumps({"method": method, "payload": payload})
        if self.latency:
            time.sleep(self.latency)
        with self._lock:
            _send_msg(self._sock, wire)
            back = _recv_msg(self._sock)
        self.stats.requests += 1
        self.stats.bytes_sent += len(wire)
        self.stats.bytes_received += len(back)
        self.stats.total_latency += time.perf_counter() - t0
        return serialize.loads(back)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def parallel_requests(transports, method: str, payloads) -> list:
    """Asynchronous fan-out (paper: 'requests are asynchronous ... clients
    take a long time to execute').  Returns responses in input order.

    Every request runs to its end before anything is raised; then the first
    failure in input order is re-raised: a dead connection as a
    ``ConnectionError`` naming the transport's address, any other error as
    itself."""
    results = [None] * len(transports)
    errors = [None] * len(transports)

    def run(i, tr, pl):
        try:
            results[i] = tr.request(method, pl)
        except Exception as e:      # re-raised below, after every join
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i, tr, pl))
               for i, (tr, pl) in enumerate(zip(transports, payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tr, e in zip(transports, errors):
        if isinstance(e, OSError):      # ConnectionError is an OSError
            raise ConnectionError(
                f"{method!r} request to {getattr(tr, 'address', tr)} "
                f"failed: {e}") from e
        if e is not None:
            raise e
    return results

"""Message serialization (the reference's wire and checkpoint format) and
the transports that carry it (the paper's RPC tier)."""
from repro_torch.comm.serialize import (  # noqa: F401
    array_nbytes, dumps, estimate_message_bytes, loads, message_bytes,
)
from repro_torch.comm.transport import (  # noqa: F401
    InProcessTransport, RPCServer, SocketTransport, Transport,
    TransportStats, parallel_requests,
)

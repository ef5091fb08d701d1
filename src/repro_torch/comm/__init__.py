"""Message serialization (the reference's wire and checkpoint format).

Only the serializer is ported; the transports (``repro.comm.transport``)
are ROADMAP M10."""
from repro_torch.comm.serialize import (  # noqa: F401
    array_nbytes, dumps, estimate_message_bytes, loads, message_bytes,
)

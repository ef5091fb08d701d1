"""Device selection and the public kernel entry points.

The port runs on CUDA.  :func:`set_device` is the one switch a caller uses
to run it elsewhere (``set_device("cpu")``, which the CPU tests call) — the
twin of the reference's ``set_interpret``.  Without that call and without a
CUDA device, :func:`get_device` raises instead of falling back quietly to
the CPU.

The kernel entry points re-exported here (``fedavg_aggregate``,
``fedavg_aggregate_tree``, ``stc_compress_batched``, ``int8_roundtrip_batched``, ``stc_compress``,
``quantize``, ``dequantize``, ``flash_attention``, ``wkv6``) take the device from their input tensors: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the plain PyTorch version beside
it, anything else raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import (
    attention, fedavg_agg, quant, rwkv6_scan, stc_topk,
)
from repro_torch.kernels.attention import flash_attention  # noqa: F401
from repro_torch.kernels.fedavg_agg import (  # noqa: F401
    fedavg_aggregate, fedavg_aggregate_tree,
)
from repro_torch.kernels.quant import (  # noqa: F401
    dequantize, int8_roundtrip_batched, quantize,
)
from repro_torch.kernels.rwkv6_scan import wkv6  # noqa: F401
from repro_torch.kernels.stc_topk import (  # noqa: F401
    stc_compress, stc_compress_batched,
)

_DEVICE: Optional[torch.device] = None


def set_device(device) -> None:
    """Run entry points on ``device`` (``"cuda"``, ``"cuda:1"``, ``"cpu"``);
    ``None`` restores the default: the current CUDA device, or an error."""
    global _DEVICE
    _DEVICE = None if device is None else torch.device(device)


def get_device() -> torch.device:
    """The device entry points run on (see :func:`set_device`)."""
    dev = _DEVICE
    if dev is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA and no CUDA device is available; "
                "call repro_torch.set_device('cpu') to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch.set_device({str(dev)!r}) but no CUDA device is "
            f"available")
    return dev


def launch_counts() -> Dict[str, int]:
    """CUDA-kernel launches per kernel in this process."""
    return {"fedavg_agg": fedavg_agg.launches,
            "fedavg_agg_tree": fedavg_agg.grouped_launches,
            "stc_batched": stc_topk.launches,
            "int8_rowmax": quant.rowmax_launches,
            "int8_qdq": quant.qdq_launches,
            "flash_fwd": attention.fwd_launches,
            "flash_dq": attention.dq_launches,
            "flash_dkv": attention.dkv_launches,
            "stc_dense": stc_topk.dense_launches,
            "int8_quantize": quant.quantize_launches,
            "int8_dequantize": quant.dequantize_launches,
            "wkv6": rwkv6_scan.launches}


def reset_launch_counts() -> None:
    fedavg_agg.launches = 0
    fedavg_agg.grouped_launches = 0
    stc_topk.launches = 0
    quant.rowmax_launches = 0
    quant.qdq_launches = 0
    attention.fwd_launches = 0
    attention.dq_launches = 0
    attention.dkv_launches = 0
    stc_topk.dense_launches = 0
    quant.quantize_launches = 0
    quant.dequantize_launches = 0
    rwkv6_scan.launches = 0

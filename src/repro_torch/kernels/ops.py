"""Device selection and the public kernel entry points.

The port runs on CUDA.  :func:`set_device` is the one switch a caller uses
to run it elsewhere (``set_device("cpu")``, which the CPU tests call) — the
twin of the reference's ``set_interpret``.  Without that call and without a
CUDA device, :func:`get_device` raises instead of falling back quietly to
the CPU.

:func:`set_devices` sets the list of devices the sharded cohort
(``resources.distributed = "data"``) spreads over, one shard an entry —
the counterpart of the reference's ``jax.devices()``.  A device may
repeat: ``set_devices(["cpu"] * 4)`` gives the CPU tests four shards, as
the reference's tests get them from forced host devices, and
``set_devices(["cuda:0"] * 2)`` two shards on one card.

The kernel entry points here (``fedavg_aggregate``,
``fedavg_aggregate_tree``, ``fedavg_aggregate_sharded``,
``stc_compress_batched``, ``int8_roundtrip_batched`` — both with
``mesh=`` for the sharded route —, ``stc_compress``, ``quantize``,
``dequantize``, ``flash_attention``, ``wkv6``) take the device from their
input tensors: a CUDA tensor launches the hand-written kernel, a CPU
tensor takes the plain PyTorch version beside it, anything else raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.kernels import (
    attention, fedavg_agg, quant, rwkv6_scan, stc_topk,
)
from repro_torch.kernels.attention import flash_attention  # noqa: F401
from repro_torch.kernels.fedavg_agg import (  # noqa: F401
    fedavg_aggregate, fedavg_aggregate_sharded, fedavg_aggregate_tree,
)
from repro_torch.kernels.quant import dequantize, quantize  # noqa: F401
from repro_torch.kernels.rwkv6_scan import wkv6  # noqa: F401
from repro_torch.kernels.stc_topk import stc_compress  # noqa: F401

_DEVICE: Optional[torch.device] = None
_DEVICES: Optional[List[torch.device]] = None


def stc_compress_batched(x, keep_frac: float = 0.01, mesh=None):
    """Stacked-cohort STC: (N, D) -> (sparsified (N, D), nnz (N,)); with
    ``mesh`` each shard compresses its own rows (``kernels.mesh``)."""
    if mesh is not None:
        return stc_topk.stc_compress_batched_sharded(x, float(keep_frac),
                                                     mesh)
    return stc_topk.stc_compress_batched(x, float(keep_frac))


def int8_roundtrip_batched(x, mesh=None):
    """Stacked-cohort int8 round trip with per-client scales: (N, D) ->
    (sent (N, D), scale (N,)); per shard's rows under ``mesh``."""
    if mesh is not None:
        return quant.int8_roundtrip_batched_sharded(x, mesh)
    return quant.int8_roundtrip_batched(x)


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


def set_devices(devices) -> None:
    """Shard the cohort of ``resources.distributed="data"`` over
    ``devices`` (one shard an entry; an entry may repeat); ``None``
    restores the default (:func:`get_devices`)."""
    global _DEVICES
    _DEVICES = None if devices is None else [torch.device(d)
                                             for d in devices]


def get_devices() -> List[torch.device]:
    """The devices the sharded cohort spreads over: the list given to
    :func:`set_devices`; else ``[get_device()]`` when :func:`set_device`
    chose a device; else every CUDA device."""
    if _DEVICES is not None:
        if any(d.type == "cuda" for d in _DEVICES) and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch.set_devices() names CUDA devices but no CUDA "
                "device is available")
        return list(_DEVICES)
    if _DEVICE is not None:
        return [get_device()]
    get_device()                   # no CUDA and no choice: raises
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


#: each kernel's launch counter: (module, attribute)
_COUNTERS = {"fedavg_agg": (fedavg_agg, "launches"),
             "fedavg_agg_tree": (fedavg_agg, "grouped_launches"),
             "stc_batched": (stc_topk, "launches"),
             "int8_rowmax": (quant, "rowmax_launches"),
             "int8_qdq": (quant, "qdq_launches"),
             "flash_fwd": (attention, "fwd_launches"),
             "flash_dq": (attention, "dq_launches"),
             "flash_dkv": (attention, "dkv_launches"),
             "stc_dense": (stc_topk, "dense_launches"),
             "int8_quantize": (quant, "quantize_launches"),
             "int8_dequantize": (quant, "dequantize_launches"),
             "wkv6": (rwkv6_scan, "launches")}


def launch_counts() -> Dict[str, int]:
    """CUDA-kernel launches per kernel in this process (a replayed CUDA
    graph adds the launches its capture recorded: ``add_launch_counts``)."""
    return {k: getattr(m, a) for k, (m, a) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for m, a in _COUNTERS.values():
        setattr(m, a, 0)


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel -> launches) to the counters: the wrappers
    count in Python, which a CUDA-graph replay does not run, so the
    replaying code adds what its capture launched."""
    for k, n in counts.items():
        m, a = _COUNTERS[k]
        setattr(m, a, getattr(m, a) + n)

"""Roofline terms of a dry-run step, on NVIDIA H100 SXM constants.

Hardware model (NVIDIA H100 SXM5 80GB, per card):
    peak dense bf16 tensor-core compute : 989 TFLOP/s
    HBM3 bandwidth                      : 3.35 TB/s
    NVLink 4 bandwidth                  : 450 GB/s a direction
    inter-node (one 400 Gb/s NDR port a card): 50 GB/s

Terms per (arch x shape x mesh), in seconds, from per-device quantities:
    compute    = flops            / 989e12
    memory     = hbm_bytes        / 3.35e12
    collective = (collective_bytes - inter_node_bytes) / 450e9
                 + inter_node_bytes / 50e9

Unlike the reference (``repro.launch.roofline``, whose quantities come
from the compiled HLO), the port's come from tracing the step on fake
tensors (``repro_torch.launch.dryrun``): FLOPs from
``torch.utils.flop_counter.FlopCounterMode``, HBM bytes as every eager
op's inputs read once and outputs written once, and collective bytes from
the resolved partition specs (torch has no partitioned program to read
them from).  The reference's HLO collective parser has no twin here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

CARD = "NVIDIA H100 SXM5 80GB"
PEAK_FLOPS = 989e12          # dense bf16, tensor cores, a card
HBM_BW = 3.35e12             # B/s, HBM3, a card
NVLINK_BW = 450e9            # B/s a direction, NVLink 4, a card
INTER_NODE_BW = 50e9         # B/s, one 400 Gb/s NDR InfiniBand port a card


@dataclass
class Roofline:
    """Roofline terms from *per-device* quantities (a balanced program:
    the global counts divided by the chips)."""

    flops: float                  # per-device FLOPs
    hbm_bytes: float              # per-device HBM traffic estimate
    collective_bytes: float       # per-device collective bytes moved
    chips: int
    model_flops: float = 0.0      # global 6·N·D (2·N·D for inference)
    dcn_bytes: float = 0.0        # subset of collective bytes crossing pods

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def dcn_s(self) -> float:
        """Inter-pod share at the inter-node bandwidth."""
        return self.dcn_bytes / INTER_NODE_BW

    @property
    def collective_s(self) -> float:
        return (self.collective_bytes - self.dcn_bytes) / NVLINK_BW \
            + self.dcn_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_compute_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): catches remat/redundancy."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "card": CARD,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dcn_bytes": self.dcn_bytes,
            "dcn_s": self.dcn_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "useful_compute_ratio": self.useful_compute_ratio,
        }


def model_flops(cfg, shape, text_len: Optional[int] = None) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params)."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * (text_len or shape.seq_len)
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * (text_len or shape.seq_len)
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per sequence

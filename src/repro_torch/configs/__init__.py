"""Architecture registry: published hyperparameters by id.

``get_arch(name)`` resolves an id (dashes or underscores) to its
``ArchConfig``; ``get_arch(name, reduced=True)`` returns the smoke-test
variant (<= 2 layers, d_model <= 256, <= 4 experts).  All ten of the
reference's ids are ported: the dense GQA decoders ``glm4-9b``,
``internlm2-20b``, ``phi3-medium-14b`` and ``nemotron-4-340b``, the MoE
decoders ``qwen3-moe-30b-a3b`` and ``deepseek-v2-lite-16b`` (MLA), the VLM
``paligemma-3b``, the hybrid ``recurrentgemma-9b`` (RG-LRU and local
attention), the encoder-decoder ``whisper-small`` and ``rwkv6-1.6b``.
``shapes`` holds the reference's input shapes.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.core.config import ArchConfig

ARCH_IDS = [
    "rwkv6_1p6b",
    "internlm2_20b",
    "paligemma_3b",
    "whisper_small",
    "glm4_9b",
    "phi3_medium_14b",
    "nemotron4_340b",
    "qwen3_moe_30b_a3b",
    "recurrentgemma_9b",
    "deepseek_v2_lite_16b",
]
# public ids use dashes
_ALIASES = {
    "rwkv6-1.6b": "rwkv6_1p6b",
    "internlm2-20b": "internlm2_20b",
    "paligemma-3b": "paligemma_3b",
    "whisper-small": "whisper_small",
    "glm4-9b": "glm4_9b",
    "phi3-medium-14b": "phi3_medium_14b",
    "nemotron-4-340b": "nemotron4_340b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "p")
    if name in _ALIASES:
        return _ALIASES[name]
    if key in ARCH_IDS:
        return key
    raise KeyError(f"unknown architecture {name!r}; known: {sorted(_ALIASES)}")


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    key = canonical(name)
    cfg: ArchConfig = importlib.import_module(f"repro_torch.configs.{key}").ARCH
    return cfg.reduced() if reduced else cfg


def list_archs() -> List[str]:
    return sorted(_ALIASES)

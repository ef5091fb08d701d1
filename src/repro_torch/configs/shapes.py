"""Assigned input shapes (the reference's ``repro.configs.shapes``).

Four global shapes; ``decode_32k`` and ``long_500k`` are one new token
against a KV cache / recurrent state, the others are full sequences
(``train`` and ``prefill``).  ``Model.input_specs`` turns a shape into the
model's inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]

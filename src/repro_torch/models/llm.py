"""Transformer LLMs as federated :class:`FLModel`\\ s.

Bridges the decoder stack (``repro_torch.models.transformer``) into the FL
runtime's model interface, so an LLM cohort runs through the batched engine
like the paper's small models — and, under ``client.finetune = "lora"``,
trains only low-rank adapters (``repro_torch.models.lora``) over a frozen
base shared by every client.

``tiny_lm`` is the CPU-fast registered default (2 layers, d_model 32,
vocab 64) paired with the ``tiny_lm`` synthetic token dataset; bigger
variants come from :func:`transformer_lm` on any ported ``ArchConfig``
(e.g. ``repro_torch.configs.get_arch("glm4-9b")``).
"""
from __future__ import annotations

import functools

from repro_torch.core.config import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.small import FLModel

TINY_LM_VOCAB = 64
TINY_LM_SEQ_LEN = 16


def transformer_lm(arch: ArchConfig, name: str = None) -> FLModel:
    """Wrap a decoder-only dense ``ArchConfig`` as an :class:`FLModel`
    whose ``loss_and_metrics`` is next-token cross-entropy
    (``is_sequence=True``)."""
    if arch.family != "dense":
        if arch.family == "moe":
            raise NotImplementedError(
                "transformer_lm of a moe arch is not ported to repro_torch "
                "yet (ROADMAP M9)")
        raise ValueError(
            f"transformer_lm supports dense/moe decoder archs, got "
            f"family={arch.family!r}")
    if arch.encoder_layers:
        raise ValueError("transformer_lm is decoder-only")
    defs = transformer.model_defs(arch)

    def apply(p, x):
        return transformer.forward(arch, p, x)[0]

    return FLModel(name or arch.name, defs, apply, arch.vocab,
                   (arch.max_seq_len,), is_sequence=True)


@functools.lru_cache(maxsize=1)
def tiny_lm() -> FLModel:
    """The registered CPU-fast LLM (one instance per process)."""
    arch = ArchConfig(
        name="tiny_lm", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab=TINY_LM_VOCAB, max_seq_len=TINY_LM_SEQ_LEN,
        dtype="float32")
    return transformer_lm(arch)

"""PaliGemma-3B — VLM: SigLIP vision encoder + Gemma-2B language backbone.

Hyperparameters from arXiv:2407.07726.  Backbone (Gemma-2B): 18 layers,
d_model 2048, 8 query heads with 1 KV head (MQA), head_dim 256, FFN 16384
(GeGLU), vocab 257216 (Gemma SentencePiece + location/segmentation tokens).

The SigLIP ViT + linear projector frontend is a STUB per assignment:
``input_specs`` supplies 256 precomputed patch embeddings (224px/14px patches
-> 16x16) which are prepended to the text tokens.
"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    reference="arXiv:2407.07726 (PaliGemma); Gemma backbone arXiv:2403.08295",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    act="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,     # Gemma ties input/output embeddings
    n_frames=256,            # vision patch embeddings (stub input)
)

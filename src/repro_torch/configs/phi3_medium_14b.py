"""Phi-3-medium 14B — dense decoder, RoPE + SwiGLU + GQA.

Hyperparameters from arXiv:2404.14219: 40 layers, d_model 5120, 40 query
heads with 10 KV heads, FFN 17920 (SwiGLU), vocab 100352.
"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    reference="arXiv:2404.14219 (Phi-3)",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab=100352,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

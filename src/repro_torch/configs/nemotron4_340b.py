"""Nemotron-4-340B — dense decoder with GQA and squared-ReLU MLP.

Hyperparameters from arXiv:2402.16819 / arXiv:2406.11704: 96 layers,
d_model 18432, 96 query heads with 8 KV heads, FFN 73728 (squared ReLU,
no gating), vocab 256000, RoPE.
"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    reference="arXiv:2402.16819 (Nemotron-4)",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    act="sq_relu",
    norm="layernorm",
    rope_theta=10_000.0,
)

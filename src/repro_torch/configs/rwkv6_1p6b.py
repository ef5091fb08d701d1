"""RWKV-6 "Finch" 1.6B — attention-free SSM with data-dependent decay.

Hyperparameters from arXiv:2404.05892 (RWKV-6 World 1.6B): 24 layers,
d_model 2048, FFN 7168 (ReLU^2-gated channel-mix), vocab 65536, head dim 64.
"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    reference="arXiv:2404.05892 (RWKV-6 Finch, World-1.6B)",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    act="relu_sq_gate",   # RWKV channel-mix: relu(x)^2 with receptance gate
    norm="layernorm",
    pos_embedding="none", # recurrence carries position
    rope_theta=0.0,
    rwkv_head_dim=64,
    tie_embeddings=False,
    supports_long_context=True,   # O(1) state decode
)

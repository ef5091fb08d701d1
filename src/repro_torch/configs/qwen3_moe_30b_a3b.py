"""Qwen3-30B-A3B — MoE decoder: 128 experts, top-8, GQA, QK-norm.

Hyperparameters from hf:Qwen/Qwen3-30B-A3B: 48 layers, d_model 2048,
32 query heads with 4 KV heads, head_dim 128, per-expert FFN 768 (SwiGLU),
128 routed experts top-8 (no shared expert), vocab 151936, RMSNorm with
per-head q/k normalization.
"""
from repro_torch.core.config import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    reference="hf:Qwen/Qwen3-30B-A3B (Qwen3 MoE)",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                 # == moe.d_expert (kept for 6·N·D bookkeeping)
    vocab=151936,
    act="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_experts=128,
        top_k=8,
        n_shared=0,
        d_expert=768,
        aux_loss_weight=0.001,
    ),
)

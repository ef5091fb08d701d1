"""InternLM2-20B — dense decoder with GQA.

Hyperparameters from arXiv:2403.17297: 48 layers, d_model 6144, 48 query
heads with 8 KV heads (GQA), FFN 16384 (SwiGLU), vocab 92544, RoPE.
"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="internlm2-20b",
    family="dense",
    reference="arXiv:2403.17297 (InternLM2)",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)

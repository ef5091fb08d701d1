"""GLM-4-9B — dense decoder with GQA and RoPE.

Hyperparameters from hf:THUDM/glm-4-9b: 40 layers, d_model 4096, 32 query
heads with 2 KV heads, FFN 13696 (SwiGLU), vocab 151552.

Adaptation note (as in the reference): GLM applies rotary embedding to half
the head dim; this config applies full-dim RoPE — identical FLOPs and
memory.
"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="glm4-9b",
    family="dense",
    reference="hf:THUDM/glm-4-9b (GLM-4)",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

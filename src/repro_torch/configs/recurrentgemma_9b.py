"""RecurrentGemma-9B — Griffin-style hybrid: RG-LRU + local attention (1:2).

Hyperparameters from arXiv:2402.19427 (Griffin) / arXiv:2404.07839
(RecurrentGemma): 38 layers, d_model 4096, pattern (rglru, rglru,
local_attn) cycled, local-attention window 2048, 16 heads with 1 KV head
(MQA), head_dim 256, FFN 12288 (GeGLU), vocab 256000, lru_width 4096.
"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    reference="arXiv:2402.19427 (Griffin); arXiv:2404.07839 (RecurrentGemma)",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    act="geglu",
    norm="rmsnorm",
    pos_embedding="rope",     # used by the local-attention layers
    rope_theta=10_000.0,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    lru_width=4096,
    conv1d_width=4,
    tie_embeddings=True,
    supports_long_context=True,   # recurrent state + windowed attention
)

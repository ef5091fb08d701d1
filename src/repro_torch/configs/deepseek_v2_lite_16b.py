"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE (2 shared + 64 routed, top-6).

Hyperparameters from arXiv:2405.04434 (DeepSeek-V2; Lite variant): 27 layers,
d_model 2048, 16 heads, MLA with kv_lora_rank 512 (no q compression in Lite),
qk_nope 128 / qk_rope 64 / v 128 per head; MoE per-expert FFN 1408, 64 routed
experts top-6 plus 2 shared experts; the first layer uses a dense FFN
(10944); vocab 102400.

Note: the assignment line reads "2 shared+160 routed"; 160 routed is the
full DeepSeek-V2 — the Lite model card (and the assignment's own "MoE 64e
top-6") specify 64 routed experts, which we follow.
"""
from repro_torch.core.config import ArchConfig, MLAConfig, MoEConfig

ARCH = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    reference="arXiv:2405.04434 (DeepSeek-V2-Lite)",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,            # MLA: per-head latents, no GQA grouping
    d_ff=1408,                # == moe.d_expert
    vocab=102400,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        n_shared=2,
        d_expert=1408,
        aux_loss_weight=0.001,
        first_dense_layers=1,
        dense_d_ff=10944,
    ),
)

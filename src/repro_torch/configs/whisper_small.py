"""Whisper-small — encoder-decoder speech model (transformer backbone only).

Hyperparameters from arXiv:2212.04356: 12 encoder + 12 decoder layers,
d_model 768, 12 heads (MHA, kv=12), FFN 3072 (GELU), vocab 51865,
1500 encoder frames (30 s audio after 2x conv subsampling).

The mel-spectrogram + conv1d frontend is a STUB per assignment:
``input_specs`` supplies precomputed (B, 1500, 768) frame embeddings.

Adaptation note (as in the reference): learned absolute positions are used for the
decoder and sinusoidal for the encoder in the original; we use learned
positions for both (equivalent parameter shape, identical compute).
``long_500k`` is skipped for this arch — a 524k-token autoregressive
transcript is outside the family's envelope.
"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="whisper-small",
    family="audio",
    reference="arXiv:2212.04356 (Whisper)",
    n_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    pos_embedding="learned",
    n_frames=1500,
    max_seq_len=32_768,     # decoder positional capacity for the dry-run
    supports_long_context=False,
)

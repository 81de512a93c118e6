"""musicgen-medium [audio] — decoder-only over EnCodec tokens (4 codebooks).
48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048. [arXiv:2306.05284]
The EnCodec frontend is a stub: inputs are codebook token ids.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    mixer="attn",
    ffn="swiglu",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv=24,
    d_ff=6144,
    vocab=2048,
    n_codebooks=4,
)

"""internvl2-2b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-2B backbone.
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. [arXiv:2404.16821]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    mixer="attn",
    ffn="swiglu",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    n_img_tokens=256,
    vocab_pad=256,
)

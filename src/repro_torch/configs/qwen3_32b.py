"""qwen3-32b [dense] — qk_norm, GQA kv=8.
64L d_model=5120 64H d_ff=25600 vocab=151936. [hf:Qwen/Qwen3-32B]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    mixer="attn",
    ffn="swiglu",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
)

"""llama3-405b [dense] — GQA kv=8, 128k vocab. The largest assigned cell.
126L d_model=16384 128H d_ff=53248 vocab=128256. [arXiv:2407.21783]
long_500k is SKIPPED (pure quadratic attention; see DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    mixer="attn",
    ffn="swiglu",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
)

"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1).
18L d_model=2048 8H d_ff=16384 vocab=256000. [arXiv:2403.08295]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    mixer="attn",
    ffn="geglu",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
)

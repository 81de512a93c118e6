"""hymba-1.5b [hybrid] — parallel attention + mamba heads in each layer.
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16.
[arXiv:2411.13676]
long_500k RUNS with sliding-window attention (2048) on the attn path —
Hymba's global/local pattern — while the SSD path carries long context.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    mixer="hybrid",
    ffn="swiglu",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    d_state=16,
    ssd_expand=1,          # d_inner = d_model = 1600; 25 SSD heads of 64
    ssd_headdim=64,
    ssd_chunk=256,
    conv_k=4,
    ssd_split_proj=True,   # 2*di+2*n+h = 3257 is mesh-indivisible
    vocab_pad=256,
    ssd_state_dtype="bfloat16",  # halves decode state traffic (§Perf)
)

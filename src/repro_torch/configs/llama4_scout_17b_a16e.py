"""llama4-scout-17b-a16e [moe] — MoE 16e top-1 + shared expert, early fusion.
48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    mixer="attn",
    ffn="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    n_shared=1,
    moe_dff=8192,
    capacity_factor=1.25,
    moe_chunk=4096,
)

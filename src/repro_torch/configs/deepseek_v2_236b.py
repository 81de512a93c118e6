"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.
60L d_model=5120 128H moe_dff=1536 vocab=102400. [arXiv:2405.04434]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    mixer="mla",
    ffn="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv=128,
    head_dim=128,
    d_ff=1536,
    vocab=102400,
    kv_lora=512,
    q_lora=1536,
    rope_head_dim=64,
    n_experts=160,
    top_k=6,
    n_shared=2,
    moe_dff=1536,
    capacity_factor=1.25,
    moe_chunk=4096,
)

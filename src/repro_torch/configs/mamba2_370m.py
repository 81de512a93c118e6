"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128. [arXiv:2405.21060]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    mixer="ssd",
    ffn="none",
    n_layers=48,
    d_model=1024,
    n_heads=32,            # SSD heads = d_inner / headdim = 2048/64
    n_kv=32,
    d_ff=0,
    vocab=50280,
    d_state=128,
    ssd_expand=2,
    ssd_headdim=64,
    ssd_chunk=256,
    conv_k=4,
    vocab_pad=256,
    ssd_state_dtype="bfloat16",  # halves decode state traffic (§Perf)
)

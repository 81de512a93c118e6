"""repro_torch.models — the decoder LM of the paged serve path.

``config`` is a copy of the JAX package's configuration; ``layers`` and
``lm`` port the attention decoder's prefill and paged decode step.
"""
from . import layers
from .config import SHAPES, ModelConfig, ShapeConfig, reduced
from .lm import (
    assemble_inputs, decode_step_paged, embed_tokens, head_f32,
    head_weight, init_paged_cache, init_params, prefill,
)

__all__ = [
    "SHAPES", "ModelConfig", "ShapeConfig", "assemble_inputs",
    "decode_step_paged", "embed_tokens", "head_f32", "head_weight",
    "init_paged_cache", "init_params", "layers", "prefill", "reduced",
]

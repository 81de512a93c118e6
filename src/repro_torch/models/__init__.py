"""repro_torch.models — the decoder LM of the serve paths.

``config`` is a copy of the JAX package's configuration; ``layers`` and
``lm`` port the decoder's prefill, partial prefill and decode step
through the contiguous cache and the paged pool, for every mixer
(attention, MLA, SSD, hybrid), the dense and MoE FFNs and none, and the
codebook (musicgen) and image-token (internvl2) frontends.
"""
from . import layers
from .config import SHAPES, ModelConfig, ShapeConfig, reduced
from .lm import (
    assemble_inputs, decode_step, decode_step_paged, embed_tokens, head_f32,
    head_weight, init_cache, init_paged_cache, init_params, prefill,
    prefill_partial,
)

__all__ = [
    "SHAPES", "ModelConfig", "ShapeConfig", "assemble_inputs",
    "decode_step", "decode_step_paged", "embed_tokens", "head_f32",
    "head_weight", "init_cache", "init_paged_cache", "init_params",
    "layers", "prefill", "prefill_partial", "reduced",
]

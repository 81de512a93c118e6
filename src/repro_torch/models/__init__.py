"""repro_torch.models — the decoder LM.

``config`` is a copy of the JAX package's configuration; ``layers`` and
``lm`` port the decoder's training forward and loss, prefill, partial
prefill and decode step through the contiguous cache and the paged pool,
for every mixer (attention, MLA, SSD, hybrid), the dense and MoE FFNs and
none, and the codebook (musicgen) and image-token (internvl2) frontends.
"""
from . import layers
from .config import SHAPES, ModelConfig, ShapeConfig, reduced
from .lm import (
    abstract_cache, abstract_paged_cache, abstract_params, assemble_inputs, backbone, decode_step, decode_step_paged, embed_tokens,
    forward_loss, head_f32, head_weight, init_cache, init_paged_cache,
    init_params, layer_apply, lm_loss, prefill, prefill_partial,
)

__all__ = [
    "SHAPES", "ModelConfig", "ShapeConfig", "abstract_cache",
    "abstract_paged_cache", "abstract_params", "assemble_inputs", "backbone",
    "decode_step", "decode_step_paged", "embed_tokens", "forward_loss",
    "head_f32", "head_weight", "init_cache", "init_paged_cache",
    "init_params", "layer_apply", "layers", "lm_loss", "prefill",
    "prefill_partial", "reduced",
]

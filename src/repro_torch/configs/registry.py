"""Architecture registry: ``--arch <id>`` resolution.

A copy of the parts of ``repro.configs.registry`` that need no JAX:
``get_config``, ``get_reduced``, ``ARCH_IDS`` and ``cell_is_runnable``.
``sharding_policy`` and ``train_microbatches`` need the multi-device
rules (``dist.rules``) and wait for the port's multi-GPU and training
slices; ``shape_overrides`` and ``all_cells`` come with them.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SUBQUADRATIC, ModelConfig, reduced

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "musicgen-medium": "musicgen_medium",
    "internlm2-20b": "internlm2_20b",
    "qwen3-32b": "qwen3_32b",
    "llama3-405b": "llama3_405b",
    "gemma-2b": "gemma_2b",
    "internvl2-2b": "internvl2_2b",
    "hymba-1.5b": "hymba_1p5b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def cell_is_runnable(arch: str, shape: str) -> bool:
    """long_500k only runs on sub-quadratic mixers."""
    cfg = get_config(arch)
    if shape == "long_500k":
        return cfg.mixer in SUBQUADRATIC
    return True

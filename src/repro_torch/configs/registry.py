"""Architecture registry: ``--arch <id>`` resolution.

A copy of ``repro.configs.registry``'s ``get_config``, ``get_reduced``,
``ARCH_IDS``, ``cell_is_runnable``, ``sharding_policy`` and
``train_microbatches``. ``shape_overrides`` and ``all_cells`` come with
the launch tooling (ROADMAP item 23).
"""
from __future__ import annotations

import importlib

from repro_torch.dist.rules import ShardingPolicy
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


def sharding_policy(arch: str, shape: str) -> ShardingPolicy:
    """Per-cell distribution policy."""
    cfg = get_config(arch)
    big = cfg.param_count() > 3e10          # 30B+ -> FSDP weights
    # SP (shard saved residuals over model) saves memory but conflicts
    # with MoE token grouping (regrouping seq-sharded tokens): MoE archs
    # run without SP (their d_model keeps residuals affordable).
    seq = shape == "train_4k" and cfg.ffn != "moe"
    return ShardingPolicy(fsdp=big, seq_shard=seq, shard_cache_seq=True)


def train_microbatches(arch: str) -> int:
    """Grad-accumulation depth (capped to per-dp-shard batch by the
    launcher). Keeps saved activations within device memory."""
    cfg = get_config(arch)
    if cfg.param_count() > 1e11:
        return 16
    if cfg.param_count() > 1e10:
        return 8
    return 4

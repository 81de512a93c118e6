"""Architecture registry: ``--arch <id>`` resolution and per-cell policy,
a copy of ``repro.configs.registry``."""
from __future__ import annotations

import importlib

from repro_torch.dist.rules import ShardingPolicy
from repro_torch.models.config import (
    SHAPES, SUBQUADRATIC, ModelConfig, reduced,
)

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


def shape_overrides(arch: str, shape: str) -> dict:
    """Config adjustments a given cell needs (e.g. hymba long-context
    window; moe dispatch chunk tuning for the huge-token cells)."""
    over: dict = {}
    cfg = get_config(arch)
    if shape == "long_500k" and cfg.mixer == "hybrid":
        over["window"] = 2048
    if shape == "train_4k" and cfg.ffn == "moe":
        over["moe_chunk"] = 4096
    return over


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


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch x shape) cells, including recorded skips."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]

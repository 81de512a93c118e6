"""Shape-only stand-ins for every model input (no allocation): the port
of ``repro.launch.inputs``. Each is a tensor on the ``meta`` device."""
from __future__ import annotations

import torch

from repro_torch.models import abstract_cache
from repro_torch.models.config import ModelConfig, ShapeConfig

I32 = torch.int32


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract input batch for the given cell. kind-dependent:

    train   -> {tokens, labels [, img_embeds]}
    prefill -> {tokens [, img_embeds]}
    decode  -> {tokens(B,1), cache, pos}
    """
    gb, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def tok(b, length):
        if cfg.n_codebooks:
            return sds((b, length, cfg.n_codebooks), I32)
        return sds((b, length), I32)

    if shape.kind == "decode":
        # per-slot positions: the serve scheduler refills freed slots
        # mid-decode, so the production decode step carries a (B,) pos
        # vector rather than one scalar depth for the whole batch
        return {
            "tokens": tok(gb, 1),
            "cache": abstract_cache(cfg, gb, s, dt),
            "pos": sds((gb,), I32),
        }

    text_len = s - cfg.n_img_tokens if cfg.n_img_tokens else s
    batch = {"tokens": tok(gb, text_len)}
    if cfg.n_img_tokens:
        batch["img_embeds"] = sds((gb, cfg.n_img_tokens, 1024), dt)
    if shape.kind == "train":
        batch["labels"] = tok(gb, text_len)
    return batch

"""Unified model configuration covering all 10 assigned architectures.

A copy of ``repro.models.config``, which has no JAX code, so that a
configuration means the same thing in both packages: one decoder
skeleton (embed -> layers -> norm -> head) with a per-family *mixer*
(attention / MLA / SSD / hybrid) and *ffn* (dense / GeGLU / MoE). The
port runs the layers as a Python loop over per-layer parameter dicts
(``repro_torch.models.lm``); the JAX package scans stacked weights.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | audio | vlm
    mixer: str = "attn"          # attn | mla | ssd | hybrid
    ffn: str = "swiglu"          # swiglu | geglu | moe | none

    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    head_dim: int | None = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1000

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int | None = None    # sliding-window size for long-context

    # MLA (deepseek)
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64

    # MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared: int = 0
    moe_dff: int = 0             # per-expert hidden (deepseek: 1536)
    capacity_factor: float = 1.25
    moe_chunk: int = 4096        # tokens per dispatch chunk (memory knob)

    # SSM (mamba2 SSD)
    d_state: int = 0
    ssd_expand: int = 2
    ssd_headdim: int = 64
    ssd_chunk: int = 256
    conv_k: int = 4
    # split the fused in-projection into (z, x, BC, dt) weights so each
    # is individually model-shardable — needed when the fused output dim
    # (2*d_inner + 2*d_state + heads) does not divide the model axis
    # (hymba: 3257). §Perf iter log.
    ssd_split_proj: bool = False
    # decode-time SSM state dtype: the state is read+written once per
    # token and dominates SSD decode HBM traffic; bf16 halves it at a
    # small accumulation-precision cost (updates still compute in f32).
    ssd_state_dtype: str = "float32"

    # hybrid (hymba): fraction of heads that are SSM replaced handled by
    # running both paths on the full width and averaging (see layers.py)

    # modality frontends (stubs per assignment)
    n_codebooks: int = 0         # musicgen
    n_img_tokens: int = 0        # internvl2 (precomputed patch embeds)

    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    logit_chunk: int = 512       # CE loss sequence chunking
    tie_embeddings: bool = False
    # physical embedding-table padding: odd vocabs (50280, 32001, 92553)
    # cannot shard over a 16-way model axis and replicate ~200 MB of
    # embed+head per device; padding to a multiple restores sharding.
    # Logical vocab is unchanged (padded logits are masked). §Perf.
    vocab_pad: int = 1

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad) * self.vocab_pad

    # ---------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssd_expand * self.d_model

    @property
    def ssd_heads(self) -> int:
        return self.d_inner // self.ssd_headdim

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv
        per_layer = 0
        if self.mixer == "attn":
            per_layer += d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        elif self.mixer == "mla":
            qd = nh * (hd + self.rope_head_dim)
            per_layer += (d * self.q_lora + self.q_lora * qd
                          + d * (self.kv_lora + self.rope_head_dim)
                          + self.kv_lora * nh * (hd + hd)
                          + nh * hd * d)
        elif self.mixer == "ssd":
            di = self.d_inner
            per_layer += d * (2 * di + 2 * self.d_state + self.ssd_heads)
            per_layer += di * d + self.conv_k * (di + 2 * self.d_state)
        elif self.mixer == "hybrid":
            per_layer += d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
            di = self.d_inner
            per_layer += d * (2 * di + 2 * self.d_state + self.ssd_heads)
            per_layer += di * d + self.conv_k * (di + 2 * self.d_state)
        if self.ffn in ("swiglu", "geglu"):
            per_layer += 3 * d * ff
        elif self.ffn == "moe":
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.moe_dff
            per_layer += self.n_shared * 3 * d * self.moe_dff
        per_layer += 2 * d  # norms
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb + d

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts top_k+shared experts)."""
        if self.ffn != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        all_experts = L * self.n_experts * 3 * d * self.moe_dff
        active = L * (self.top_k + self.n_shared) * 3 * d * self.moe_dff
        # n_shared already counted once in param_count
        shared = L * self.n_shared * 3 * d * self.moe_dff
        return full - all_experts - shared + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs whose mixer is sub-quadratic (SSD or hybrid-with-window): the only
# ones for which long_500k is runnable (see DESIGN.md §4).
SUBQUADRATIC = ("ssd", "hybrid")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 2)),
        head_dim=16,
        d_ff=128,
        vocab=128,
        q_lora=32 if cfg.q_lora else 0,
        kv_lora=32 if cfg.kv_lora else 0,
        rope_head_dim=8 if cfg.mixer == "mla" else cfg.rope_head_dim,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2),
        n_shared=min(cfg.n_shared, 1),
        moe_dff=64 if cfg.moe_dff else 0,
        moe_chunk=64,
        d_state=16 if cfg.d_state else 0,
        ssd_headdim=16 if cfg.d_state else 64,
        ssd_chunk=16,
        n_codebooks=cfg.n_codebooks,
        n_img_tokens=min(cfg.n_img_tokens, 8) if cfg.n_img_tokens else 0,
        logit_chunk=64,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

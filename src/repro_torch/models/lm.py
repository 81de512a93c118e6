"""Decoder LM: embed -> layers -> norm -> head, the serve subset.

A port of the parts of ``repro.models.lm`` that serving runs: parameter
init, embedding and head, prompt prefill, the partial prefill of a
prompt suffix against a cached prefix, and the decode step through the
contiguous cache and through the paged KV pool. The JAX package stacks
every layer's weights on a leading L axis and scans them; here
``params["layers"]`` is a list of per-layer dicts and the layers run in
a Python loop. The caches stay stacked like JAX's, so that one layer's
cache ``k[l]`` is a contiguous slice (the paged-attention kernel takes a
layer's pool as it is) written in place: attention keeps {k, v},
contiguous ``(L, B, T, KV, D)`` and paged ``(L, N+1, P, KV, D)``; MLA
keeps its compressed {c_kv, k_rope}, ``(L, B, T, kvl|rd)`` and
``(L, N+1, P, kvl|rd)``, with no KV-head axis.

The ``attn`` and ``mla`` mixers are ported, with the ``swiglu``,
``geglu`` and ``moe`` FFNs. SSD and hybrid come with the slice that
ports the recurrent mixers; musicgen's codebook and internvl2's
image-token frontends with the frontends slice.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device

from . import layers as L
from .config import ModelConfig

F32 = torch.float32


def _unsupported(cfg: ModelConfig) -> None:
    if cfg.mixer not in ("attn", "mla"):
        raise NotImplementedError(
            f"mixer={cfg.mixer!r} is not ported yet: SSD and hybrid come "
            "with the next slice, which ports the recurrent mixers and "
            "their per-slot state in the paged cache")
    if cfg.ffn not in ("swiglu", "geglu", "moe"):
        raise NotImplementedError(
            f"ffn={cfg.ffn!r} is not ported yet: it comes with the next "
            "slice, which ports the recurrent mixers")
    if cfg.n_codebooks or cfg.n_img_tokens:
        raise NotImplementedError(
            "codebook (musicgen) and image-token (internvl2) frontends "
            "are not ported yet: they come with the frontends slice")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    _unsupported(cfg)
    dt = getattr(torch, cfg.dtype)
    mixer = L.mla_init if cfg.mixer == "mla" else L.attn_init
    ffn = L.moe_init if cfg.ffn == "moe" else L.mlp_init
    return {"norm1": L.rmsnorm_init(cfg.d_model, dt, device),
            "mixer": mixer(gen, cfg, device),
            "norm2": L.rmsnorm_init(cfg.d_model, dt, device),
            "ffn": ffn(gen, cfg, device)}


def _ffn(lp, x, cfg: ModelConfig):
    """The residual FFN half of a layer: x + ffn(rmsnorm(x))."""
    h = L.rmsnorm(x, lp["norm2"])
    f = (L.moe_apply(lp["ffn"], h, cfg) if cfg.ffn == "moe"
         else L.mlp_apply(lp["ffn"], h, cfg))
    return x + f


def _stack(per_layer: list) -> dict:
    """[{leaf: (B, T, ...)}] per layer -> {leaf: (L, B, T, ...)}."""
    return {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


def _layer_cache(cache: dict, li: int) -> dict:
    """Layer ``li``'s slice of every stacked cache leaf (views)."""
    return {k: v[li] for k, v in cache.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (``None`` means the card). JAX's PRNG streams have no
    torch counterpart, so these are not the JAX package's values; to run
    identical weights, convert JAX's with
    ``repro_torch.convert.lm_params_from_numpy``."""
    _unsupported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    params = {
        "layers": [init_layer(generator, cfg, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev),
        "embed": (torch.randn((cfg.padded_vocab, cfg.d_model),
                              generator=generator, device=dev)
                  * 0.02).to(dt),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(generator, cfg.d_model,
                                      cfg.padded_vocab, dt, dev)
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))


def head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def head_f32(params, cfg: ModelConfig) -> torch.Tensor:
    """The (d, V) head in fp32, as the logits product takes it. A copy
    for a low-precision model: callers that decode many steps make it
    once and pass it as ``head=`` (2.1 GB for gemma-2b)."""
    return head_weight(params, cfg).to(F32)


def _logits(hidden, params, cfg: ModelConfig, head):
    w = head_f32(params, cfg) if head is None else head
    logits = hidden.to(F32) @ w
    if logits.shape[-1] != cfg.vocab:       # mask padded vocab rows
        idx = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(idx < cfg.vocab, logits,
                             torch.tensor(-1e30, dtype=F32,
                                          device=logits.device))
    return logits


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def assemble_inputs(params, batch, cfg: ModelConfig):
    """Returns (embeddings, labels); text tokens only in this slice."""
    _unsupported(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    return x, batch.get("labels")


def prefill(params, batch, cfg: ModelConfig, window=None, last_pos=None,
            head=None):
    """Process a full prompt; returns last-position logits (B, V) fp32
    and the cache in ``cfg.dtype``: {k, v} (L, B, S, KV, D) for
    attention, {c_kv, k_rope} (L, B, S, kvl|rd) for MLA.

    ``last_pos`` selects which position's logits to return instead of
    the final one: the bucketed path right-pads prompts to pow2 lengths
    and reads the logits at the real prompt end; causal masking makes
    the right padding invisible to every real position (but pad tokens
    still take MoE capacity, in JAX too). ``head`` is an optional
    precomputed :func:`head_f32`."""
    x, _ = assemble_inputs(params, batch, cfg)
    seqlen = x.shape[1]
    kvs = []
    for lp in params["layers"]:
        x, kv = _prefill_layer(lp, x, cfg, window, seqlen)
        kvs.append(kv)
    hidden = L.rmsnorm(x, params["final_norm"])
    last = hidden[:, -1] if last_pos is None else hidden[:, int(last_pos)]
    return _logits(last, params, cfg, head), _stack(kvs)


def _prefill_layer(lp, x, cfg: ModelConfig, window, seqlen):
    """One layer of the prompt pass; also emits the layer's cache."""
    h = L.rmsnorm(x, lp["norm1"])
    b = x.shape[0]
    dt = getattr(torch, cfg.dtype)
    pos = torch.arange(seqlen, device=x.device)
    if cfg.mixer == "mla":
        mix, kv = L.mla_prefill(lp["mixer"], h, cfg, pos, window=window)
    else:
        ap = lp["mixer"]
        q, k, v = L.attn_qkv(ap, h, cfg, pos)
        o = L.blockwise_attention(q, k, v, causal=True, window=window)
        mix = L.dense(o.reshape(b, seqlen, -1), ap["wo"])
        kv = {"k": k, "v": v}
    x = _ffn(lp, x + mix, cfg)
    return x, {k: v.to(dt) for k, v in kv.items()}


def prefill_partial(params, batch, ctx, cfg: ModelConfig, window=None,
                    start: int = 0, last_pos=None, head=None):
    """Prefill only a prompt SUFFIX against an already-computed prefix.

    The prefix-cache admission path: the engine gathers the prompt's
    first ``start`` positions out of the pool into ``ctx`` (the cache's
    leaves, (L, 1, C, ...), positions ``>= start`` being pad) and
    prefills just the suffix ``batch["tokens"]``, whose absolute
    positions are ``start + arange(S)``. Returns the logits at suffix
    position ``last_pos`` (default: the final one) and the SUFFIX-ONLY
    cache, (L, 1, S, ...), which the engine scatters into the pool at
    ``start..start+S`` (``serve.scheduler.insert_paged_span``). Attention
    runs through :func:`layers.context_attention`, the single-chunk
    mirror of the full prefill's math. The suffix is its own MoE chunk,
    so an MoE layer may route it otherwise than a full prefill (JAX
    does the same)."""
    x, _ = assemble_inputs(params, batch, cfg)
    seqlen = x.shape[1]
    kvs = []
    for li, lp in enumerate(params["layers"]):
        x, kv = _prefill_partial_layer(lp, _layer_cache(ctx, li), x, cfg,
                                       window, seqlen, int(start))
        kvs.append(kv)
    hidden = L.rmsnorm(x, params["final_norm"])
    last = hidden[:, -1] if last_pos is None else hidden[:, int(last_pos)]
    return _logits(last, params, cfg, head), _stack(kvs)


def _prefill_partial_layer(lp, ctx_l, x, cfg: ModelConfig, window, seqlen,
                           start: int):
    """:func:`_prefill_layer` over a suffix: queries at
    ``start + arange(S)`` attend the gathered prefix context, then
    themselves; emits the suffix's cache."""
    h = L.rmsnorm(x, lp["norm1"])
    b = x.shape[0]
    dt = getattr(torch, cfg.dtype)
    mp = lp["mixer"]
    pos = start + torch.arange(seqlen, device=x.device)
    if cfg.mixer == "mla":
        q_nope, q_rope, c_kv, k_rope = L._mla_qkv(mp, h, cfg, pos)
        k, v = L._mla_heads(mp, c_kv, k_rope[:, :, 0], cfg)
        # the context's latent pages up-projected as the suffix's are
        ctx_k, ctx_v = L._mla_heads(mp, ctx_l["c_kv"], ctx_l["k_rope"], cfg)
        o = L.context_attention(torch.cat([q_nope, q_rope], -1), k, v,
                                ctx_k, ctx_v, start, window=window)
        kv = {"c_kv": c_kv, "k_rope": k_rope[:, :, 0]}
    else:
        q, k, v = L.attn_qkv(mp, h, cfg, pos)
        o = L.context_attention(q, k, v, ctx_l["k"], ctx_l["v"], start,
                                window=window)
        kv = {"k": k, "v": v}
    x = _ffn(lp, x + L.dense(o.reshape(b, seqlen, -1), mp["wo"]), cfg)
    return x, {k: v.to(dt) for k, v in kv.items()}


def layer_decode(lp, x, cache_l, pos, cfg: ModelConfig):
    """One layer of the contiguous decode step; ``cache_l`` is the
    layer's cache leaves, written in place."""
    h = L.rmsnorm(x, lp["norm1"])
    decode = L.mla_decode if cfg.mixer == "mla" else L.attn_decode
    mix, nc = decode(lp["mixer"], h, cfg, cache_l, pos)
    return _ffn(lp, x + mix, cfg), nc


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, head=None):
    """Decode tokens (B, s) for the whole batch through the contiguous
    cache (:func:`init_cache`), updated in place (JAX returns a new
    cache). ``pos`` is a scalar (fixed-batch decode: every row at one
    depth) or a (B,) vector (continuous batching: each slot at its own
    depth); s > 1 is the speculative verify step. Returns (logits
    (B, s, V) fp32, cache)."""
    _unsupported(cfg)
    x = embed_tokens(params, tokens, cfg)
    for li, lp in enumerate(params["layers"]):
        x, _ = layer_decode(lp, x, _layer_cache(cache, li), pos, cfg)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _logits(hidden, params, cfg, head), cache


def layer_decode_paged(lp, x, cache_l, pos, page_table, cfg: ModelConfig,
                       use_kernel: bool = False):
    """One layer of the decode step; ``cache_l`` is the layer's pools,
    written in place. ``use_kernel`` selects the paged-attention kernel
    over the ``paged_gather`` path (tokens match)."""
    h = L.rmsnorm(x, lp["norm1"])
    decode = (L.mla_decode_paged if cfg.mixer == "mla"
              else L.attn_decode_paged)
    mix, nc = decode(lp["mixer"], h, cfg, cache_l, pos, page_table,
                     use_kernel)
    return _ffn(lp, x + mix, cfg), nc


def decode_step_paged(params, cache, tokens, pos, page_table,
                      cfg: ModelConfig, use_kernel: bool = False,
                      head=None):
    """One decode step over the slot batch through the paged cache.

    tokens: (B, s) (s > 1: the speculative verify step, which takes the
    gather path); ``pos`` scalar or (B,); cache: the pools of
    :func:`init_paged_cache`, shared by all slots, indexed through
    ``page_table`` (B, max_pages) int32 and updated in place (JAX
    returns new pools). Returns (logits (B, s, V) fp32, cache).
    ``use_kernel=True`` swaps each layer's ``paged_gather`` attention for
    the paged-attention kernel."""
    _unsupported(cfg)
    x = embed_tokens(params, tokens, cfg)
    for li, lp in enumerate(params["layers"]):
        x, _ = layer_decode_paged(lp, x, _layer_cache(cache, li), pos,
                                  page_table, cfg, use_kernel)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _logits(hidden, params, cfg, head), cache


def _stacked(cfg: ModelConfig, one: dict) -> dict:
    """One layer's zero cache repeated on a leading L axis."""
    return {k: v[None].expand((cfg.n_layers,) + tuple(v.shape)).clone()
            for k, v in one.items()}


def init_cache(cfg: ModelConfig, batch: int, t: int, dtype,
               device) -> dict:
    """Contiguous decode cache, stacked on a leading L axis: {k, v}
    (L, batch, t, KV, D) for attention, {c_kv, k_rope} (L, batch, t,
    kvl|rd) for MLA."""
    _unsupported(cfg)
    init = L.mla_cache_init if cfg.mixer == "mla" else L.attn_cache_init
    return _stacked(cfg, init(cfg, batch, t, dtype, device))


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     n_slots: int, dtype, device) -> dict:
    """Paged decode cache, stacked on a leading L axis: pools
    (L, n_pages + 1, page_size, ...) shared across slots ({k, v} with a
    (KV, D) row for attention, {c_kv, k_rope} with a kvl / rd row for
    MLA); the +1 is the scratch page inactive slots write and gather
    through. (State leaves of recurrent mixers, per slot, come with
    those mixers.)"""
    _unsupported(cfg)
    init = (L.mla_paged_cache_init if cfg.mixer == "mla"
            else L.attn_paged_cache_init)
    return _stacked(cfg, init(cfg, n_pages + 1, page_size, dtype, device))

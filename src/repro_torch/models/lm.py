"""Decoder LM: embed -> layers -> norm -> head, the dense-attention
serve subset.

A port of the parts of ``repro.models.lm`` that serving runs: parameter
init, embedding and head, prompt prefill, the partial prefill of a
prompt suffix against a cached prefix, and the decode step through the
contiguous cache and through the paged KV pool. The JAX package stacks
every layer's weights on a leading L axis and scans them; here
``params["layers"]`` is a list of per-layer dicts and the layers run in
a Python loop. The caches stay stacked like JAX's, contiguous
``(L, B, T, KV, D)`` and paged ``(L, N+1, P, KV, D)``, so that one
layer's cache ``k[l]`` is a contiguous slice (the paged-attention kernel
takes a layer's pool as it is) written in place.

Only ``mixer="attn"`` with the ``swiglu``/``geglu`` FFNs is ported. MLA
and MoE, SSD and hybrid come with the slice that ports the remaining
mixers (MLA through the paged kernel's rope term); musicgen's codebook
and internvl2's image-token frontends with the frontends slice.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device

from . import layers as L
from .config import ModelConfig

F32 = torch.float32


def _unsupported(cfg: ModelConfig) -> None:
    if cfg.mixer != "attn":
        raise NotImplementedError(
            f"mixer={cfg.mixer!r} is not ported yet: MLA (through the "
            "paged kernel's rope term), SSD and hybrid come with the "
            "slice that ports the remaining mixers and MoE")
    if cfg.ffn not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"ffn={cfg.ffn!r} is not ported yet: MoE comes with the "
            "slice that ports the remaining mixers and MoE")
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
    return {"norm1": L.rmsnorm_init(cfg.d_model, dt, device),
            "mixer": L.attn_init(gen, cfg, device),
            "norm2": L.rmsnorm_init(cfg.d_model, dt, device),
            "ffn": L.mlp_init(gen, cfg, device)}


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
    and the KV cache {k, v}: (L, B, S, KV, D) in ``cfg.dtype``.

    ``last_pos`` selects which position's logits to return instead of
    the final one: the bucketed path right-pads prompts to pow2 lengths
    and reads the logits at the real prompt end; causal masking makes
    the right padding invisible to every real position. ``head`` is an
    optional precomputed :func:`head_f32`."""
    x, _ = assemble_inputs(params, batch, cfg)
    seqlen = x.shape[1]
    ks, vs = [], []
    for lp in params["layers"]:
        x, kv = _prefill_layer(lp, x, cfg, window, seqlen)
        ks.append(kv["k"])
        vs.append(kv["v"])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    hidden = L.rmsnorm(x, params["final_norm"])
    last = hidden[:, -1] if last_pos is None else hidden[:, int(last_pos)]
    return _logits(last, params, cfg, head), cache


def _prefill_layer(lp, x, cfg: ModelConfig, window, seqlen):
    """One layer of the prompt pass; also emits the layer's KV."""
    h = L.rmsnorm(x, lp["norm1"])
    b = x.shape[0]
    dt = getattr(torch, cfg.dtype)
    ap = lp["mixer"]
    pos = torch.arange(seqlen, device=x.device)
    q, k, v = L.attn_qkv(ap, h, cfg, pos)
    o = L.blockwise_attention(q, k, v, causal=True, window=window)
    x = x + L.dense(o.reshape(b, seqlen, -1), ap["wo"])
    x = x + L.mlp_apply(lp["ffn"], L.rmsnorm(x, lp["norm2"]), cfg)
    return x, {"k": k.to(dt), "v": v.to(dt)}


def prefill_partial(params, batch, ctx, cfg: ModelConfig, window=None,
                    start: int = 0, last_pos=None, head=None):
    """Prefill only a prompt SUFFIX against an already-computed prefix.

    The prefix-cache admission path: the engine gathers the prompt's
    first ``start`` positions out of the pool into ``ctx`` ({k, v}:
    (L, 1, C, KV, D), positions ``>= start`` being pad) and prefills just
    the suffix ``batch["tokens"]``, whose absolute positions are
    ``start + arange(S)``. Returns the logits at suffix position
    ``last_pos`` (default: the final one) and the SUFFIX-ONLY cache,
    (L, 1, S, KV, D), which the engine scatters into the pool at
    ``start..start+S`` (``serve.scheduler.insert_paged_span``). Attention
    runs through :func:`layers.context_attention`, the single-chunk
    mirror of the full prefill's math."""
    x, _ = assemble_inputs(params, batch, cfg)
    seqlen = x.shape[1]
    ks, vs = [], []
    for li, lp in enumerate(params["layers"]):
        ctx_l = {"k": ctx["k"][li], "v": ctx["v"][li]}
        x, kv = _prefill_partial_layer(lp, ctx_l, x, cfg, window, seqlen,
                                       int(start))
        ks.append(kv["k"])
        vs.append(kv["v"])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    hidden = L.rmsnorm(x, params["final_norm"])
    last = hidden[:, -1] if last_pos is None else hidden[:, int(last_pos)]
    return _logits(last, params, cfg, head), cache


def _prefill_partial_layer(lp, ctx_l, x, cfg: ModelConfig, window, seqlen,
                           start: int):
    """:func:`_prefill_layer` over a suffix: queries at
    ``start + arange(S)`` attend the gathered prefix context, then
    themselves; emits the suffix's KV."""
    h = L.rmsnorm(x, lp["norm1"])
    b = x.shape[0]
    dt = getattr(torch, cfg.dtype)
    ap = lp["mixer"]
    pos = start + torch.arange(seqlen, device=x.device)
    q, k, v = L.attn_qkv(ap, h, cfg, pos)
    o = L.context_attention(q, k, v, ctx_l["k"], ctx_l["v"], start,
                            window=window)
    x = x + L.dense(o.reshape(b, seqlen, -1), ap["wo"])
    x = x + L.mlp_apply(lp["ffn"], L.rmsnorm(x, lp["norm2"]), cfg)
    return x, {"k": k.to(dt), "v": v.to(dt)}


def layer_decode(lp, x, cache_l, pos, cfg: ModelConfig):
    """One layer of the contiguous decode step; ``cache_l`` is the
    layer's {k, v} (B, T, KV, D), written in place."""
    h = L.rmsnorm(x, lp["norm1"])
    mix, nc = L.attn_decode(lp["mixer"], h, cfg, cache_l, pos)
    x = x + mix
    x = x + L.mlp_apply(lp["ffn"], L.rmsnorm(x, lp["norm2"]), cfg)
    return x, nc


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, head=None):
    """Decode tokens (B, s) for the whole batch through the contiguous
    cache {k, v}: (L, B, T, KV, D), updated in place (JAX returns a new
    cache). ``pos`` is a scalar (fixed-batch decode: every row at one
    depth) or a (B,) vector (continuous batching: each slot at its own
    depth); s > 1 is the speculative verify step. Returns (logits
    (B, s, V) fp32, cache)."""
    _unsupported(cfg)
    x = embed_tokens(params, tokens, cfg)
    for li, lp in enumerate(params["layers"]):
        cache_l = {"k": cache["k"][li], "v": cache["v"][li]}
        x, _ = layer_decode(lp, x, cache_l, pos, cfg)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _logits(hidden, params, cfg, head), cache


def layer_decode_paged(lp, x, cache_l, pos, page_table, cfg: ModelConfig,
                       use_kernel: bool = False):
    """One layer of the decode step; ``cache_l`` is the layer's pools,
    written in place. ``use_kernel`` selects the paged-attention kernel
    over the ``paged_gather`` path (tokens match)."""
    h = L.rmsnorm(x, lp["norm1"])
    mix, nc = L.attn_decode_paged(lp["mixer"], h, cfg, cache_l, pos,
                                  page_table, use_kernel)
    x = x + mix
    x = x + L.mlp_apply(lp["ffn"], L.rmsnorm(x, lp["norm2"]), cfg)
    return x, nc


def decode_step_paged(params, cache, tokens, pos, page_table,
                      cfg: ModelConfig, use_kernel: bool = False,
                      head=None):
    """One decode step over the slot batch through the paged cache.

    tokens: (B, s) (s > 1: the speculative verify step, which takes the
    gather path); ``pos`` scalar or (B,); cache {k, v}:
    (L, N+1, P, KV, D) pools shared by all slots, indexed through
    ``page_table`` (B, max_pages) int32 and updated in place (JAX
    returns new pools). Returns (logits (B, 1, V) fp32, cache).
    ``use_kernel=True`` swaps each layer's ``paged_gather`` attention for
    the paged-attention kernel."""
    _unsupported(cfg)
    x = embed_tokens(params, tokens, cfg)
    for li, lp in enumerate(params["layers"]):
        cache_l = {"k": cache["k"][li], "v": cache["v"][li]}
        x, _ = layer_decode_paged(lp, x, cache_l, pos, page_table, cfg,
                                  use_kernel)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _logits(hidden, params, cfg, head), cache


def init_cache(cfg: ModelConfig, batch: int, t: int, dtype,
               device) -> dict:
    """Contiguous decode cache, stacked on a leading L axis:
    {k, v}: (L, batch, t, KV, D)."""
    _unsupported(cfg)
    c = L.attn_cache_init(cfg, batch, t, dtype, device)
    return {k: v[None].expand((cfg.n_layers,) + tuple(v.shape)).clone()
            for k, v in c.items()}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     n_slots: int, dtype, device) -> dict:
    """Paged decode cache, stacked on a leading L axis: pools
    (L, n_pages + 1, page_size, KV, D) shared across slots; the +1 is
    the scratch page inactive slots write and gather through. (State
    leaves of recurrent mixers, per slot, come with those mixers.)"""
    _unsupported(cfg)
    shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

"""Decoder LM: embed -> layers -> norm -> head.

A port of ``repro.models.lm``: parameter init and its shape-only trees
(on the ``meta`` device, for the dry run), embedding and head, the
training forward (``layer_apply``, ``backbone``, ``lm_loss``,
``forward_loss``; autograd gives the gradients), prompt prefill, the
partial prefill of a prompt suffix against a cached prefix, and the
decode step through the contiguous cache and through the paged KV pool.
The JAX package stacks
every layer's weights on a leading L axis and scans them; here
``params["layers"]`` is a list of per-layer dicts and the layers run in
a Python loop. The caches stay stacked like JAX's, so that one layer's
cache ``k[l]`` is a contiguous slice (the paged-attention kernel takes a
layer's pool as it is) written in place: attention keeps {k, v},
contiguous ``(L, B, T, KV, D)`` and paged ``(L, N+1, P, KV, D)``; MLA
keeps its compressed {c_kv, k_rope}, ``(L, B, T, kvl|rd)`` and
``(L, N+1, P, kvl|rd)``, with no KV-head axis. SSD keeps per-slot
states {conv (L, B, k-1, conv_dim), ssm (L, B, H, P, N)} in either
cache, and hybrid nests both: {attn: {k, v}, ssd: {conv, ssm}}.

Every mixer is ported (``attn``, ``mla``, ``ssd``, ``hybrid``), with the
``swiglu``, ``geglu`` and ``moe`` FFNs and ``ffn="none"``, and so are the
two modality frontends, stubs as in JAX: musicgen's codebooks (tokens
``(B, S, K)``, a ``(K, V, d)`` embedding summed over the codebooks, a
``(d, K*V)`` head whose column ``k*V + v`` is codebook k's token v) and
internvl2's image tokens (``batch["img_embeds"]`` ``(B, N, 1024)``
projected by ``img_proj`` and put before the text, so text positions
start at N).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.dist.api import (
    current_rules, is_dtensor, pad, reduced, run_local, select_part, shard,
    split_last, stack_parts, use_rules, whole,
)

from . import layers as L
from .config import ModelConfig

F32 = torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_MIXER_INIT = {"attn": L.attn_init, "mla": L.mla_init, "ssd": L.ssd_init,
               "hybrid": L.hybrid_init}


def init_layer(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = getattr(torch, cfg.dtype)
    p = {"norm1": L.rmsnorm_init(cfg.d_model, dt, device),
         "mixer": _MIXER_INIT[cfg.mixer](gen, cfg, device)}
    if cfg.ffn != "none":
        ffn = L.moe_init if cfg.ffn == "moe" else L.mlp_init
        p["norm2"] = L.rmsnorm_init(cfg.d_model, dt, device)
        p["ffn"] = ffn(gen, cfg, device)
    return p


def _ffn(lp, x, cfg: ModelConfig):
    """The residual FFN half of a layer: x + ffn(rmsnorm(x)); x itself
    where the layer has none (``ffn="none"``)."""
    if cfg.ffn == "none":
        return x
    h = L.rmsnorm(x, lp["norm2"])
    f = (L.moe_apply(lp["ffn"], h, cfg) if cfg.ffn == "moe"
         else L.mlp_apply(lp["ffn"], h, cfg))
    return x + f


def _stack(per_layer: list) -> dict:
    """[{leaf: (B, ...)}] per layer -> {leaf: (L, B, ...)}, nested
    dicts (the hybrid cache) stacked leaf by leaf (DTensors part by
    part)."""
    return {k: (_stack([c[k] for c in per_layer]) if isinstance(v, dict)
                else stack_parts([c[k] for c in per_layer]))
            for k, v in per_layer[0].items()}


def _layer_cache(cache: dict, li: int) -> dict:
    """Layer ``li``'s slice of every stacked cache leaf (views, each
    contiguous; on a mesh DTensors over each rank's part), nested dicts
    included."""
    return {k: (_layer_cache(v, li) if isinstance(v, dict)
                else select_part(v, li))
            for k, v in cache.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (``None`` means the card). JAX's PRNG streams have no
    torch counterpart, so these are not the JAX package's values; to run
    identical weights, convert JAX's with
    ``repro_torch.convert.lm_params_from_numpy``. Codebook models get a
    ``(K, V, d)`` embedding and a ``(d, K*V)`` head, image-token models
    an ``img_proj`` ``(1024, d)`` as well."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_model
    params = {
        "layers": [init_layer(generator, cfg, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(d, dt, dev),
    }
    rows = ((cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks
            else (cfg.padded_vocab,))
    params["embed"] = (torch.randn(rows + (d,), generator=generator,
                                   device=dev) * 0.02).to(dt)
    if cfg.n_codebooks or not cfg.tie_embeddings:
        params["head"] = L.dense_init(generator, d, math.prod(rows), dt,
                                      dev)
    if cfg.n_img_tokens:
        params["img_proj"] = L.dense_init(generator, 1024, d, dt, dev)
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    """Token ids -> embeddings. Codebook tokens (B, S, K) sum their K
    embeddings in JAX's order and precision: from 0, codebook 0 first,
    each add rounded to the table's dtype."""
    tokens = tokens.long()
    emb = params["embed"]
    if cfg.n_codebooks:
        x = sum(_lookup(emb[k], tokens[..., k])
                for k in range(cfg.n_codebooks))
    else:
        x = _lookup(emb, tokens)
    return shard(x.to(getattr(torch, cfg.dtype)), "residual")


def _lookup(table, tokens):
    """``table[tokens]``. On a mesh each rank looks up its own rows of a
    vocab-split table (megatron's vocab-parallel embedding): a token
    outside them gives zeros, and the parts are a partial sum over the
    ranks that split the vocab, which the next op reduces. DTensor's own
    lookups break in torch 2.11: the backward of an index fails to place
    its index_put on a three-axis mesh, and ``F.embedding``'s masked
    partial result fails to reduce after a checkpointed layer."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    coord = mesh.get_coordinate()
    tok_split = [is_dtensor(tokens) and p.is_shard() and p.dim == 0
                 for p in (tokens.placements if is_dtensor(tokens)
                           else [None] * mesh.ndim)]
    pt, ptok, pout = [], [], []
    parts, index = 1, 0
    for i, p in enumerate(table.placements):
        if p.is_shard() and p.dim % 2 == 0:          # the vocab split
            pt.append(Shard(0))
            ptok.append(Replicate())
            pout.append(Partial())
            index = index * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
            continue
        # a d split over the mesh dim that splits the tokens' batch
        # (FSDP's "data") cannot show in the output beside the batch
        # split: the table is made whole on that dim
        d_split = p.is_shard() and not tok_split[i]
        pt.append(Shard(1) if d_split else Replicate())
        ptok.append(Shard(0) if tok_split[i] else Replicate())
        pout.append(Shard(tokens.ndim) if d_split
                    else Shard(0) if tok_split[i] else Replicate())
    rows = table.shape[0] // parts
    lo = index * rows

    def look(t, tab):
        ids = t - lo
        ok = (ids >= 0) & (ids < rows)
        return tab[ids.clamp(0, rows - 1)] * ok[..., None].to(tab.dtype)

    return run_local(look, (tokens, table), (tuple(ptok), tuple(pt)),
                     tuple(pout))


def head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def head_f32(params, cfg: ModelConfig) -> torch.Tensor:
    """The (d, V) head in fp32, as the logits product takes it. A copy
    for a low-precision model: callers that decode many steps make it
    once and pass it as ``head=`` (2.1 GB for gemma-2b)."""
    return head_weight(params, cfg).to(F32)


def _logits(hidden, params, cfg: ModelConfig, head, mask: bool = True):
    """fp32 logits; the columns past ``cfg.vocab`` (the padded vocab) are
    masked where ``mask``. A codebook head's K*V columns are not padding:
    every caller but ``prefill_partial`` passes ``mask=False`` for
    codebook models, as JAX's entry points do. On a mesh the logits are
    made whole (the vocab split gathered), alike on every rank, so that
    every rank samples the same token."""
    w = head_f32(params, cfg) if head is None else head
    logits = whole(hidden.to(F32) @ w)
    if mask and logits.shape[-1] != cfg.vocab:   # mask padded vocab rows
        idx = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(idx < cfg.vocab, logits,
                             torch.tensor(-1e30, dtype=F32,
                                          device=logits.device))
    return logits


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def layer_apply(lp, x, cfg: ModelConfig, window=None):
    """One layer over the whole sequence x (B, S, d), as training runs
    it: x + mixer(rmsnorm(x)), then the residual FFN."""
    h = L.rmsnorm(x, lp["norm1"])
    if cfg.mixer == "attn":
        mix = L.attn_apply(lp["mixer"], h, cfg, window=window)
    elif cfg.mixer == "mla":
        mix = L.mla_apply(lp["mixer"], h, cfg, window=window)
    elif cfg.mixer == "ssd":
        mix = L.ssd_block_apply(lp["mixer"], h, cfg)
    elif cfg.mixer == "hybrid":
        mix = L.hybrid_apply(lp["mixer"], h, cfg, window=window)
    else:  # pragma: no cover
        raise ValueError(cfg.mixer)
    return shard(_ffn(lp, x + mix, cfg), "residual")


def _layer_under(rules, lp, x, cfg, window):
    """:func:`layer_apply` under ``rules``: autograd recomputes a
    checkpointed layer in its own thread for a device's work, where the
    caller's ``use_rules`` scope is not active."""
    with use_rules(rules):
        return layer_apply(lp, x, cfg, window)


def backbone(params, x, cfg: ModelConfig, window=None):
    """x: (B, S, d) embeddings -> final hidden states. With ``cfg.remat``
    each layer is checkpointed (``jax.checkpoint`` on JAX's scan body):
    backward keeps only each layer's input and runs the layer again."""
    rules = current_rules()
    for lp in params["layers"]:
        if cfg.remat:
            x = checkpoint(_layer_under, rules, lp, x, cfg, window,
                           use_reentrant=False)
        else:
            x = layer_apply(lp, x, cfg, window)
    return L.rmsnorm(x, params["final_norm"])


def lm_loss(params, hidden, labels, cfg: ModelConfig):
    """Chunked CE over the sequence; labels == -1 are masked.

    hidden: (B, S, d); labels: (B, S) or (B, S, K) for codebooks. The
    sequence is cut into chunks of ``cfg.logit_chunk`` (the last padded
    with -1 labels), each chunk's logits made in fp32 against the fp32
    head, the padded-vocab columns set to -1e30; the mean is over the
    valid labels."""
    b, s, d = hidden.shape
    ck = min(cfg.logit_chunk, s)
    sp = -(-s // ck) * ck
    labels = torch.as_tensor(labels, device=hidden.device).long()
    hp = pad(hidden, (0, 0, 0, sp - s))
    widths = [0, 0] * (labels.ndim - 2) + [0, sp - s]
    lp = pad(labels, widths, value=-1)
    w = head_weight(params, cfg).to(F32)
    loss_sum = torch.zeros((), dtype=F32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(sp // ck):
        hc = hp[:, i * ck:(i + 1) * ck]
        lc = lp[:, i * ck:(i + 1) * ck]
        logits = hc.to(F32) @ w
        if cfg.n_codebooks:
            logits = split_last(logits, (cfg.n_codebooks, cfg.vocab))
        logits = shard(logits, "logits")
        if logits.shape[-1] != cfg.vocab:   # mask padded vocab rows
            idx = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(idx < cfg.vocab, logits,
                                 torch.tensor(-1e30, dtype=F32,
                                              device=logits.device))
        lse = torch.logsumexp(logits, dim=-1)
        valid = lc >= 0
        picked = _picked(logits, lc)
        nll = torch.where(valid, lse - picked, torch.zeros((), dtype=F32,
                                                           device=lse.device))
        loss_sum = loss_sum + nll.sum()
        count = count + valid.sum()
    return loss_sum / torch.clamp(count, min=1)


def _picked(logits, labels):
    """Each label's logit (a label < 0 picks column 0; the caller masks
    it). On a mesh it is JAX's one-hot sum, exact as the gather is (one
    term is not 0): DTensor's gather along a split vocab leaves a masked
    partial that a later reduction applies to a tensor of another shape
    and raises."""
    if is_dtensor(logits):
        iota = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(labels[..., None] == iota, logits,
                           torch.zeros((), dtype=F32,
                                       device=logits.device)).sum(-1)
    return torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]


def forward_loss(params, batch, cfg: ModelConfig, window=None):
    """The mean next-token loss of a batch {tokens, labels[, img_embeds]}
    (an image-token model's image positions carry -1 labels)."""
    x, labels = assemble_inputs(params, batch, cfg)
    hidden = backbone(params, x, cfg, window=window)
    return lm_loss(params, hidden, labels, cfg)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def assemble_inputs(params, batch, cfg: ModelConfig):
    """Returns (embeddings, labels). An image-token model projects
    ``batch["img_embeds"]`` (B, N, 1024), cast to the model dtype, through
    ``img_proj`` and puts it before the text; its labels get N leading
    -1s (masked)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    labels = batch.get("labels")
    if cfg.n_img_tokens:
        img = torch.as_tensor(batch["img_embeds"], device=x.device)
        iv = L.dense(img.to(x.dtype), params["img_proj"])
        x = torch.cat([iv, x], dim=1)
        if labels is not None:
            labels = torch.as_tensor(labels, device=x.device)
            pad = torch.full(iv.shape[:2], -1, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
    return x, labels


def prefill(params, batch, cfg: ModelConfig, window=None, last_pos=None,
            head=None):
    """Process a full prompt; returns last-position logits (B, V) fp32
    ((B, K, V) for K codebooks) and the cache: {k, v} (L, B, S, KV, D)
    for attention, {c_kv, k_rope} (L, B, S, kvl|rd) for MLA, in
    ``cfg.dtype``; SSD's {conv, ssm} with the SSM state in fp32, as
    JAX's prefill leaves it (a prompt shorter than ``conv_k - 1`` tokens
    leaves a short conv state, as in JAX); hybrid's {attn: {k, v}, ssd:
    {conv, ssm}}. An image-token model's cache holds the image positions
    first, so its text starts at position ``n_img_tokens``.

    ``last_pos`` selects which position's logits to return instead of
    the final one: the bucketed path right-pads prompts to pow2 lengths
    and reads the logits at the real prompt end; causal masking makes
    the right padding invisible to every real position (but pad tokens
    still take MoE capacity, in JAX too). It is placed as
    :func:`_last_index` says. ``head`` is an optional precomputed
    :func:`head_f32`. On a mesh the residual stream's partial sums are
    reduced once where they arise (the vocab-parallel lookup, the
    row-parallel projections), not again by each op that reads them."""
    x, _ = assemble_inputs(params, batch, cfg)
    x = reduced(x)
    seqlen = x.shape[1]
    kvs = []
    for lp in params["layers"]:
        x, kv = _prefill_layer(lp, x, cfg, window, seqlen)
        kvs.append(kv)
    hidden = L.rmsnorm(x, params["final_norm"])
    last = _at(hidden, _last_index(last_pos, seqlen))
    logits = _logits(last, params, cfg, head, mask=not cfg.n_codebooks)
    if cfg.n_codebooks:
        logits = logits.reshape(-1, cfg.n_codebooks, cfg.vocab)
    return logits, _stack(kvs)


def _at(hidden, i: int):
    """``hidden[:, i]``; on a mesh on each rank's part, its sequence dim
    whole and its other splits kept."""
    if not is_dtensor(hidden):
        return hidden[:, i]
    from torch.distributed.tensor import Replicate
    pls = tuple(Replicate() if p.is_partial() or (
        p.is_shard() and p.dim % hidden.ndim == 1) else p
        for p in hidden.placements)
    out = tuple(p if p.is_replicate() or p.dim % hidden.ndim == 0
                else type(p)(p.dim % hidden.ndim - 1) for p in pls)
    return run_local(lambda t: t[:, i], (hidden,), (pls,), out)


def _last_index(last_pos, s: int) -> int:
    """Where JAX's ``dynamic_slice_in_dim(hidden, last_pos, 1)`` reads:
    the final position by default; a negative index counts once from the
    end, then the index is clamped into ``[0, S-1]``."""
    if last_pos is None:
        return s - 1
    i = int(last_pos)
    return min(max(i + s if i < 0 else i, 0), s - 1)


def _prefill_layer(lp, x, cfg: ModelConfig, window, seqlen):
    """One layer of the prompt pass; also emits the layer's cache."""
    h = L.rmsnorm(x, lp["norm1"])
    b = x.shape[0]
    dt = getattr(torch, cfg.dtype)
    pos = torch.arange(seqlen, device=x.device)
    mp = lp["mixer"]
    if cfg.mixer == "mla":
        mix, kv = L.mla_prefill(mp, h, cfg, pos, window=window)
        kv = {"c_kv": shard(kv["c_kv"].to(dt), "mla_cache"),
              "k_rope": kv["k_rope"].to(dt)}
    elif cfg.mixer == "ssd":
        mix, conv, ssm = L.ssd_prefill(mp, h, cfg)
        kv = {"conv": conv, "ssm": ssm}
    else:
        ap = mp["attn"] if cfg.mixer == "hybrid" else mp
        q, k, v = L.attn_qkv(ap, h, cfg, pos)
        o = L.blockwise_attention(q, k, v, causal=True, window=window)
        mix = L.dense(o.reshape(b, seqlen, -1), ap["wo"])
        kv = {"k": shard(k.to(dt), "kv_cache"),
              "v": shard(v.to(dt), "kv_cache")}
        if cfg.mixer == "hybrid":
            ys, conv, ssm = L.ssd_prefill(mp["ssd"], h, cfg)
            mix = L.hybrid_fuse(mp, mix, ys)
            kv = {"attn": kv, "ssd": {"conv": conv, "ssm": ssm}}
    return reduced(shard(_ffn(lp, reduced(x + mix), cfg), "residual")), kv


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
    does the same). Only position-indexed caches have a suffix to skip
    (attn, mla): SSD and hybrid state absorbs every token. A codebook
    model's logits stay (B, K*V) with every column past ``cfg.vocab``
    masked, as JAX's are (no serve path runs it for codebooks)."""
    if cfg.mixer not in ("attn", "mla"):
        raise NotImplementedError(
            "prefix-cache partial prefill needs a position-indexed cache "
            f"(attn/mla), not {cfg.mixer!r}")
    x, _ = assemble_inputs(params, batch, cfg)
    x = reduced(x)
    seqlen = x.shape[1]
    kvs = []
    for li, lp in enumerate(params["layers"]):
        x, kv = _prefill_partial_layer(lp, _layer_cache(ctx, li), x, cfg,
                                       window, seqlen, int(start))
        kvs.append(kv)
    hidden = L.rmsnorm(x, params["final_norm"])
    last = _at(hidden, _last_index(last_pos, seqlen))
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
        kv = {"c_kv": shard(c_kv.to(dt), "mla_cache"),
              "k_rope": k_rope[:, :, 0].to(dt)}
    else:
        q, k, v = L.attn_qkv(mp, h, cfg, pos)
        o = L.context_attention(q, k, v, ctx_l["k"], ctx_l["v"], start,
                                window=window)
        kv = {"k": shard(k.to(dt), "kv_cache"),
              "v": shard(v.to(dt), "kv_cache")}
    x = _ffn(lp, reduced(x + L.dense(o.reshape(b, seqlen, -1), mp["wo"])),
             cfg)
    return reduced(shard(x, "residual")), kv


def layer_decode(lp, x, cache_l, pos, cfg: ModelConfig):
    """One layer of the contiguous decode step; ``cache_l`` is the
    layer's cache leaves, written in place."""
    h = L.rmsnorm(x, lp["norm1"])
    if cfg.mixer == "ssd":
        mix, nc = L.ssd_step(lp["mixer"], h, cfg, cache_l)
    else:
        decode = {"attn": L.attn_decode, "mla": L.mla_decode,
                  "hybrid": L.hybrid_decode}[cfg.mixer]
        mix, nc = decode(lp["mixer"], h, cfg, cache_l, pos)
    return reduced(_ffn(lp, reduced(x + mix), cfg)), nc


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, head=None):
    """Decode tokens (B, s) for the whole batch through the contiguous
    cache (:func:`init_cache`), updated in place (JAX returns a new
    cache). ``pos`` is a scalar (fixed-batch decode: every row at one
    depth) or a (B,) vector (continuous batching: each slot at its own
    depth); s > 1 is the speculative verify step. Returns (logits
    (B, s, V) fp32, cache); codebook tokens are (B, 1, K) and their
    logits (B, 1, K, V)."""
    x = reduced(embed_tokens(params, tokens, cfg))
    for li, lp in enumerate(params["layers"]):
        x, _ = layer_decode(lp, x, _layer_cache(cache, li), pos, cfg)
    hidden = L.rmsnorm(x, params["final_norm"])
    logits = _logits(hidden, params, cfg, head, mask=not cfg.n_codebooks)
    if cfg.n_codebooks:
        logits = logits.reshape(-1, 1, cfg.n_codebooks, cfg.vocab)
    return logits, cache


def layer_decode_paged(lp, x, cache_l, pos, page_table, cfg: ModelConfig,
                       use_kernel: bool = False):
    """One layer of the decode step; ``cache_l`` is the layer's pools,
    written in place. ``use_kernel`` selects the paged-attention kernel
    over the ``paged_gather`` path (tokens match)."""
    h = L.rmsnorm(x, lp["norm1"])
    if cfg.mixer == "ssd":
        # pure-state cache: nothing to page, identical to layer_decode
        mix, nc = L.ssd_step(lp["mixer"], h, cfg, cache_l)
    else:
        decode = {"attn": L.attn_decode_paged, "mla": L.mla_decode_paged,
                  "hybrid": L.hybrid_decode_paged}[cfg.mixer]
        mix, nc = decode(lp["mixer"], h, cfg, cache_l, pos, page_table,
                         use_kernel)
    return reduced(_ffn(lp, reduced(x + mix), cfg)), nc


def decode_step_paged(params, cache, tokens, pos, page_table,
                      cfg: ModelConfig, use_kernel: bool = False,
                      head=None):
    """One decode step over the slot batch through the paged cache.

    tokens: (B, s) (s > 1: the speculative verify step, which takes the
    gather path); ``pos`` scalar or (B,); cache: the pools of
    :func:`init_paged_cache`, shared by all slots, indexed through
    ``page_table`` (B, max_pages) int32 and updated in place (JAX
    returns new pools). Returns (logits (B, s, V) fp32, cache); a
    codebook model's logits stay (B, s, K*V), unmasked, as JAX leaves
    them.
    ``use_kernel=True`` swaps each layer's ``paged_gather`` attention for
    the paged-attention kernel."""
    x = reduced(embed_tokens(params, tokens, cfg))
    for li, lp in enumerate(params["layers"]):
        x, _ = layer_decode_paged(lp, x, _layer_cache(cache, li), pos,
                                  page_table, cfg, use_kernel)
    hidden = L.rmsnorm(x, params["final_norm"])
    return _logits(hidden, params, cfg, head,
                   mask=not cfg.n_codebooks), cache


def _zero_layer_cache(cfg: ModelConfig, time_leaves, slots: int, dtype,
                      device) -> dict:
    """One layer's zero cache: the attention leaves ``time_leaves()``
    makes, SSD's per-slot states for ``slots`` slots, or both nested
    (hybrid)."""
    if cfg.mixer == "ssd":
        return L.ssd_cache_init(cfg, slots, dtype, device)
    one = time_leaves()
    if cfg.mixer == "hybrid":
        return {"attn": one,
                "ssd": L.ssd_cache_init(cfg, slots, dtype, device)}
    return one


def _stacked(cfg: ModelConfig, one: dict) -> dict:
    """One layer's zero cache repeated on a leading L axis, leaf by leaf
    (a layer's slice of each leaf stays contiguous)."""
    return {k: (_stacked(cfg, v) if isinstance(v, dict) else
                v[None].expand((cfg.n_layers,) + tuple(v.shape)).clone())
            for k, v in one.items()}


def init_cache(cfg: ModelConfig, batch: int, t: int, dtype,
               device) -> dict:
    """Contiguous decode cache, stacked on a leading L axis: {k, v}
    (L, batch, t, KV, D) for attention, {c_kv, k_rope} (L, batch, t,
    kvl|rd) for MLA, SSD's per-slot {conv, ssm} (the SSM state in
    ``cfg.ssd_state_dtype``), and hybrid's {attn: {k, v}, ssd: {conv,
    ssm}}."""
    init = L.mla_cache_init if cfg.mixer == "mla" else L.attn_cache_init
    return _stacked(cfg, _zero_layer_cache(
        cfg, lambda: init(cfg, batch, t, dtype, device), batch, dtype,
        device))


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     n_slots: int, dtype, device) -> dict:
    """Paged decode cache, stacked on a leading L axis: pools
    (L, n_pages + 1, page_size, ...) shared across slots ({k, v} with a
    (KV, D) row for attention, {c_kv, k_rope} with a kvl / rd row for
    MLA); the +1 is the scratch page inactive slots write and gather
    through. SSD's state leaves carry no time dim, so they stay per slot,
    (L, n_slots, ...); hybrid nests its pools and states as
    :func:`init_cache` does."""
    init = (L.mla_paged_cache_init if cfg.mixer == "mla"
            else L.attn_paged_cache_init)
    return _stacked(cfg, _zero_layer_cache(
        cfg, lambda: init(cfg, n_pages + 1, page_size, dtype, device),
        n_slots, dtype, device))


# ---------------------------------------------------------------------------
# shape-only trees (the dry run): on the meta device, nothing allocated
# ---------------------------------------------------------------------------

def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, str(dtype)) if not isinstance(
        dtype, torch.dtype) else dtype


def abstract_params(cfg: ModelConfig) -> dict:
    """``init_params``' tree on the ``meta`` device: every leaf's shape
    and dtype, no storage (the JAX package's ``abstract_params``;
    ``params["layers"]`` is the port's per-layer list)."""
    return init_params(cfg, torch.Generator(), device="meta")


def abstract_cache(cfg: ModelConfig, batch: int, t: int, dtype) -> dict:
    """``init_cache``'s tree on the ``meta`` device (``dtype`` a torch
    dtype or its name)."""
    return init_cache(cfg, batch, t, _torch_dtype(dtype), "meta")


def abstract_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                         n_slots: int, dtype) -> dict:
    """``init_paged_cache``'s tree on the ``meta`` device."""
    return init_paged_cache(cfg, n_pages, page_size, n_slots,
                            _torch_dtype(dtype), "meta")

"""Layer primitives of the decoder LM.

A port of ``repro.models.layers``: dense projections, RMSNorm, RoPE,
blockwise (flash-style) causal attention for prefill, the GQA attention
sublayer and DeepSeek's multi-head latent attention (MLA) with their
contiguous and paged decode, the gated MLP, the capacity-dropped
mixture of experts (MoE), mamba2's chunked state-space (SSD) block and
hymba's hybrid of attention and SSD heads. Each function keeps
the JAX package's layouts and numerics: parameters in ``cfg.dtype``,
matmul accumulation, softmax and norms in fp32, ``-1e30`` (not -inf)
for masked scores. Where JAX asks for ``preferred_element_type=F32`` on
a low-precision product, the port casts the operands to fp32 first:
a product of two bf16 values is exact in fp32, so only the summation
order differs.

Layouts on a mesh: the call sites of the training path tag activations
with JAX's logical names through ``dist.api.shard``, at JAX's
positions ("attn_q"/"attn_kv" before rope, the "moe_*" streams,
"ssd_inner" with ``fallback="replicate"``); each is the identity on a
plain tensor and outside a mesh, and on a DTensor it redistributes.
Where DTensor's own op strategies are wrong or missing (torch
2.11's flip, pad, a reshape inside an einsum; a cumsum along a split
dim), the work runs on each rank's part with the dims it
works along whole (``dist.api.along``, ``run_local``): the attention
per batch row and head, the SSD scan per batch row, MoE's dispatch
positions, every pad.

Decode on a mesh (serving): a cache write lands in each rank's own part
of the cache at local indices (``dist.api.write_parts``: a slot's rows
over "data", a contiguous cache's time over "model", a pool's pages over
"data"). Decode attention runs as JAX pins it: on whole inputs on every
rank (q, the caches or pools, the positions made whole; the page table is
replicated), paged-attention kernel included, and its output is pinned
to the "residual" layout before the row-parallel out-projection; a pool
split over "data" is made whole for it on every layer and step, as in
JAX (``POOL_GATHER`` counts those bytes). MLA's absorbed products run on
each rank's heads; SSD's decode step on each rank's batch rows with its
heads whole (JAX's ``replicated(ssm_state)``).
The cache primitives write in place (``_cache_write``, ``paged_write``),
where JAX returns a new array: it saves a copy of the whole cache per
layer and step; so do the SSD decode's per-slot states (``ssd_step``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.api import (
    along, copy_into, is_dtensor, pad, replicate_on, run_local, shard,
    whole, write_parts,
)

from .config import ModelConfig

F32 = torch.float32


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    s = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=device)
    return (w * s).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def csb_dense(x: torch.Tensor, lin) -> torch.Tensor:
    """A projection through a ``core.CSBLinear`` — the CSB-pruned twin
    of :func:`dense`. A frozen weight runs the CSB-MVM kernel (its plain
    version on the CPU); under a ``use_rules`` mesh with a "model" axis
    larger than 1 its block grid is partitioned over that axis and run
    through kernel B3 (``core.CSBLinear``). The output carries the
    "residual" layout, as in JAX."""
    return shard(lin(x).to(x.dtype), "residual")


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype, device) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=F32, device=device)
                            / half))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); pos: (S,) or (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)               # (D/2,)
    ang = pos[..., :, None].to(F32) * freqs              # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise causal attention (flash-style, plain PyTorch)
# ---------------------------------------------------------------------------

def _attend_chunk(q, k, v, mask, scale):
    """q,k:(B,Cq,H,D) v:(B,Ck,KV,Dv) mask:(Cq,Ck) -> unnormalized o, m, l.

    v's head dim may differ from q/k's (MLA)."""
    b, cq, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    qh = q.reshape(b, cq, kv, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qh.to(F32), k.to(F32))
    s = s * scale
    # -1e30 (not -inf) keeps fully-masked rows NaN-free
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=F32,
                                          device=s.device))
    m = torch.amax(s, dim=-1)                           # (B,G,R,Cq)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros((), dtype=F32, device=p.device))
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype).to(F32), v.to(F32))
    return o, m, l


def blockwise_attention(
    q: torch.Tensor,           # (B, S, H, D)
    k: torch.Tensor,           # (B, T, KV, D)
    v: torch.Tensor,
    *,
    q_offset: int = 0,         # absolute position of q[0]
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention; memory O(S * chunk). Returns (B,S,H,Dv).

    The same chunking, padding and rescaling as the JAX package's two
    nested ``lax.scan``s, written as two Python loops. On a mesh it runs
    on each rank's batch rows and heads (:func:`_attention_local`)."""
    if is_dtensor(q):
        return _attention_local(q, k, v, q_offset=q_offset, causal=causal,
                                window=window, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    b, s, h, d = q.shape
    t = k.shape[1]
    kv = k.shape[2]
    dv = v.shape[3]
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    sp = -(-s // q_chunk) * q_chunk
    tp = -(-t // kv_chunk) * kv_chunk
    qp = pad(q, (0, 0, 0, 0, 0, sp - s))
    kp = pad(k, (0, 0, 0, 0, 0, tp - t))
    vp = pad(v, (0, 0, 0, 0, 0, tp - t))
    nq, nk = sp // q_chunk, tp // kv_chunk
    rep = h // kv
    outs = []
    for iq in range(nq):
        qi = qp[:, iq * q_chunk:(iq + 1) * q_chunk]
        qpos = q_offset + iq * q_chunk + torch.arange(q_chunk, device=dev)
        o = torch.zeros((b, kv, rep, q_chunk, dv), dtype=F32, device=dev)
        m = torch.full((b, kv, rep, q_chunk), -1e30, dtype=F32, device=dev)
        l = torch.zeros((b, kv, rep, q_chunk), dtype=F32, device=dev)
        for ik in range(nk):
            ki = kp[:, ik * kv_chunk:(ik + 1) * kv_chunk]
            vi = vp[:, ik * kv_chunk:(ik + 1) * kv_chunk]
            kpos = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            mask &= (kpos < t)[None, :]
            oi, mi, li = _attend_chunk(qi, ki, vi, mask, scale)
            m_new = torch.maximum(m, mi)
            a_old = torch.exp(m - m_new)
            a_new = torch.exp(mi - m_new)
            o = o * a_old[..., None] + oi * a_new[..., None]
            l = l * a_old + li * a_new
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-30)
        # (B,G,R,Cq,Dv) -> (B,Cq,H,Dv)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, dv)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :s]


def _attention_local(q, k, v, **kw):
    """:func:`blockwise_attention` on DTensors, on each rank's part:
    attention is independent per batch row and per head, so where q's
    batch dim is split k and v are split alike, where q's heads are split
    k's and v's heads follow (or stay whole when there is one KV head,
    which every q head reads), and every other split or partial sum is
    made whole. Each rank's q heads then meet their own KV heads (q head
    j of a part reads KV head j // rep of that part, as on one device).
    DTensor's own einsums here fail in torch 2.11 (a reshape that would
    merge a split dim)."""
    from torch.distributed.tensor import Replicate, Shard
    n_kv = k.shape[2]
    mesh = q.device_mesh
    pq, pkv = [], []
    for i, p in enumerate(q.placements):
        size = mesh.size(i)
        if p.is_shard() and p.dim % q.ndim == 0:
            pq.append(Shard(0))
            pkv.append(Shard(0))
        elif p.is_shard() and p.dim % q.ndim == 2 and n_kv == 1:
            pq.append(Shard(2))
            pkv.append(Replicate())
        elif p.is_shard() and p.dim % q.ndim == 2 and n_kv % size == 0:
            pq.append(Shard(2))
            pkv.append(Shard(2))
        else:
            pq.append(Replicate())
            pkv.append(Replicate())
    pq, pkv = tuple(pq), tuple(pkv)
    return run_local(lambda a, b, c: blockwise_attention(a, b, c, **kw),
                     (q, k, v), (pq, pkv, pkv), pq)


def context_attention(q, k, v, ctx_k, ctx_v, start: int, *, window=None):
    """Suffix attention against a fixed, already-computed prefix context
    (the prefix-cache partial prefill).

    ``q``/``k``/``v`` are the suffix projections, (B, S, H|KV, D), at
    absolute positions ``start + arange(S)``; ``ctx_k``/``ctx_v`` are the
    cached prefix KV, (B, C, KV, D), of which only positions ``< start``
    are real (the context rides padded to whole pages; the padding is
    masked here).

    A single-chunk mirror of :func:`blockwise_attention`'s math over
    ``concat([ctx, suffix])`` keys: a masked column adds exactly -1e30 to
    the max and exactly 0 to the sums, so a suffix row equals the full
    single-chunk prefill's row (prompts within one kv chunk).

    On a mesh it runs on whole inputs on every rank and returns a
    replicated result: JAX pins the concat's operands replicated."""
    if is_dtensor(q):
        out = context_attention(whole(q), whole(k), whole(v), whole(ctx_k),
                                whole(ctx_v), start, window=window)
        return replicate_on(out, q.device_mesh)
    b, s, h, d = q.shape
    c = ctx_k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    kk = torch.cat([ctx_k.to(k.dtype), k], dim=1)
    vv = torch.cat([ctx_v.to(v.dtype), v], dim=1)
    qpos = start + torch.arange(s, device=dev)
    kpos = torch.cat([torch.arange(c, device=dev), qpos])
    valid = torch.cat([torch.arange(c, device=dev) < start,
                       torch.ones((s,), dtype=torch.bool, device=dev)])
    mask = (qpos[:, None] >= kpos[None, :]) & valid[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    o, _, l = _attend_chunk(q, kk, vv, mask, scale)
    o = o / torch.clamp(l[..., None], min=1e-30)
    dv = vv.shape[3]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention sublayer
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = _dtype(cfg)
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
    p = {
        "wq": dense_init(gen, d, nh * hd, dt, device),
        "wk": dense_init(gen, d, nkv * hd, dt, device),
        "wv": dense_init(gen, d, nkv * hd, dt, device),
        "wo": dense_init(gen, nh * hd, d, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dt, device)
        p["k_norm"] = rmsnorm_init(hd, dt, device)
    return p


def attn_qkv(p, x, cfg: ModelConfig, pos):
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv
    # fallback="replicate" on all three, JAX's pins: q/k/v do not keep
    # the projection weight's output-dim split through the reshape
    q = shard(dense(x, p["wq"]).reshape(b, s, nh, hd), "attn_q",
              fallback="replicate")
    k = shard(dense(x, p["wk"]).reshape(b, s, nkv, hd), "attn_kv",
              fallback="replicate")
    v = shard(dense(x, p["wv"]).reshape(b, s, nkv, hd), "attn_kv",
              fallback="replicate")
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, *, window=None):
    """Full (prefill/train) self-attention."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = attn_qkv(p, x, cfg, pos)
    o = blockwise_attention(q, k, v, causal=True, window=window)
    return dense(o.reshape(b, s, -1), p["wo"])


def _decode_pos(pos, s: int, device):
    """Normalize a decode position to (query_pos, row_pos).

    ``pos`` may be a scalar (the whole batch at one depth) or a (B,)
    vector (continuous batching: each slot at its own depth; a DTensor
    on a mesh). Returns the rope positions of the s query tokens, (s,)
    or (B, s), and ``row_pos`` shaped (1,) or (B,) for per-row cache
    masking."""
    if not is_dtensor(pos):
        pos = torch.as_tensor(pos, device=device)
    if pos.ndim == 0:
        return pos + torch.arange(s, device=device), pos[None]
    return pos[:, None] + torch.arange(s, device=device), pos


def _decode_mask(t: int, row_pos, s: int, window):
    """Per-query causal decode mask, (1|B, S, T): query i (absolute
    position ``row_pos + i``) sees keys at ``kpos <= row_pos + i``."""
    kpos = torch.arange(t, device=row_pos.device)
    qp = row_pos[:, None] + torch.arange(s, device=row_pos.device)
    mask = kpos[None, None, :] <= qp[:, :, None]       # (1|B, S, T)
    if window is not None:
        mask &= kpos[None, None, :] > qp[:, :, None] - window
    return mask


def _cache_write(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B, s, ...) into ``buf`` (B, T, ...) at time ``pos``
    (scalar, or (B,) with a per-row offset), in place; returns ``buf``.

    Each row's start is placed as JAX's ``dynamic_update_slice`` places
    it: a negative start counts once from the end, then the start is
    clamped to ``[0, T - s]``, so a verify step whose overhang runs past
    the buffer lands shifted back inside it, not cut off. On a mesh each
    rank writes the rows and times of its own part."""
    b, s = new.shape[0], new.shape[1]
    t = buf.shape[1]
    dev = buf.device
    start = torch.as_tensor(whole(pos), dtype=torch.int64, device=dev)
    start = start.reshape(-1).expand(b)
    start = torch.clamp(torch.where(start < 0, start + t, start), 0, t - s)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    write_parts(buf, (rows, start[:, None] + torch.arange(s, device=dev)),
                whole(new).to(buf.dtype))
    return buf


def _softmax(sc: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in jax.nn.softmax's own form:
    exp(x - max) / sum."""
    e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _attend_cache(q, kc, vc, row_pos, cfg: ModelConfig):
    """Decode attention of the s query tokens ``q`` (B, s, H, D) against
    a per-slot cache (B, T, KV, D), with the causal decode mask at
    ``row_pos``. Returns (B, s, H*Dv) fp32; on a mesh, from whole inputs
    on every rank, a plain tensor alike on every rank."""
    q, kc, vc, row_pos = (whole(t) for t in (q, kc, vc, row_pos))
    b, s = q.shape[0], q.shape[1]
    t, kv = kc.shape[1], kc.shape[2]
    qh = q.reshape(b, s, kv, cfg.n_heads // kv, cfg.hd)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qh.to(kc.dtype).to(F32),
                      kc.to(F32))
    sc = sc / math.sqrt(cfg.hd)
    mask = _decode_mask(t, row_pos, s, cfg.window)      # (1|B, S, T)
    sc = torch.where(mask[:, None, None, :, :], sc,
                     torch.tensor(-1e30, dtype=F32, device=sc.device))
    pattn = _softmax(sc)
    o = torch.einsum("bgrqk,bkgd->bqgrd", pattn.to(vc.dtype).to(F32),
                     vc.to(F32))
    return o.reshape(b, s, -1)


def _residual_pin(o, x):
    """The decode attention's output ``o`` (whole on every rank on a
    mesh) pinned to the "residual" layout before the row-parallel
    out-projection, as JAX pins it (``fallback="replicate"``); ``o``
    itself off a mesh."""
    if not is_dtensor(x):
        return o
    return shard(replicate_on(o, x.device_mesh), "residual",
                 fallback="replicate")


def attn_decode(p, x, cfg: ModelConfig, cache, pos):
    """Decode step through the contiguous cache. cache: {k: (B, T, KV, D),
    v: ...}, written in place; ``pos`` scalar or (B,). x may carry s > 1
    tokens (speculative verification): token i lands at ``pos + i`` and
    attends causally through the batch it rides in."""
    b, s, _ = x.shape
    qpos, row_pos = _decode_pos(pos, s, x.device)
    q, k, v = attn_qkv(p, x, cfg, qpos)
    ck = _cache_write(cache["k"], k, pos)
    cv = _cache_write(cache["v"], v, pos)
    o = _residual_pin(_attend_cache(q, ck, cv, row_pos, cfg).to(x.dtype), x)
    return dense(o, p["wo"]), {"k": ck, "v": cv}


def attn_cache_init(cfg: ModelConfig, batch: int, t: int, dtype,
                    device) -> dict:
    shape = (batch, t, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Paged cache primitives (serve.paging owns the page table; this is the
# device half: position -> (page, offset) indirection on pool-shaped
# cache leaves (N_pages, page_size, ...) shared by all decode slots)
# ---------------------------------------------------------------------------

def paged_write(pool: torch.Tensor, new: torch.Tensor, pos,
                page_table: torch.Tensor) -> torch.Tensor:
    """Scatter one decode step's ``new`` (B, s, ...) into ``pool``
    (N, P, ...) at each row's (page, offset) for time position ``pos``
    (scalar or (B,)); token i lands at ``pos + i``. Writes ``pool`` in
    place and returns it.

    Rows whose position is not mapped (inactive slots) carry the scratch
    page in ``page_table``, so the scatter needs no mask. Several
    inactive rows may write the same scratch position; which one wins is
    unspecified on the card, and nothing reads it unmasked. On a pool
    split over "data" each rank writes the tokens whose pages it holds,
    at local page indices (``page_table`` is replicated)."""
    b, s = new.shape[0], new.shape[1]
    psz = pool.shape[1]
    dev = pool.device
    posv = torch.as_tensor(whole(pos), dtype=torch.int64, device=dev)
    posv = posv.reshape(-1).expand(b)[:, None] + torch.arange(s, device=dev)
    logical = torch.clamp(posv // psz, 0, page_table.shape[1] - 1)
    page = torch.gather(page_table.long(), 1, logical)
    write_parts(pool, (page, posv % psz), whole(new).to(pool.dtype))
    return pool


# bytes of split pools made whole for decode attention (a mesh with a
# "data" axis > 1 splits a pool's pages): {"bytes": n, "calls": m}
POOL_GATHER = {"bytes": 0, "calls": 0}


def whole_pool(pool: torch.Tensor) -> torch.Tensor:
    """The whole pool on every rank, as JAX makes it whole for decode
    attention on every layer and step (a split one all-gathered, its
    bytes counted in ``POOL_GATHER``); a plain pool itself."""
    if is_dtensor(pool) and any(p.is_shard() for p in pool.placements):
        POOL_GATHER["bytes"] += pool.numel() * pool.element_size()
        POOL_GATHER["calls"] += 1
    return whole(pool)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Each slot's logical time extent out of the pool: (N, P, ...)
    gathered through (B, max_pages) -> (B, max_pages*P, ...). Unmapped
    entries gather the scratch page, at logical positions the
    ``kpos <= pos`` mask removes exactly. On a mesh the pool is made
    whole first (:func:`whole_pool`) and the result is plain."""
    pool = whole_pool(pool)
    b, mp = page_table.shape
    g = pool[page_table.long()]                 # (B, max_pages, P, ...)
    return g.reshape((b, mp * pool.shape[1]) + tuple(pool.shape[2:]))


def attn_decode_paged(p, x, cfg: ModelConfig, cache, pos, page_table,
                      use_kernel: bool = False):
    """One-token decode through the paged KV pool. cache:
    {k: (N, P, KV, D), v: ...}, written in place; ``page_table``:
    (B, max_pages) int32.

    ``use_kernel=True`` routes the attention through the paged-attention
    kernel (``kernels.paged_attn_decode``: the CUDA kernel on the card,
    its plain version on the CPU), which walks the page table instead of
    materializing the (B, max_pages*P) gather. The kernel path is
    single-query (s == 1); multi-token steps take the gather path. On a
    mesh the kernel runs on every rank on whole inputs (the pools made
    whole, :func:`whole_pool`), as JAX pins them replicated."""
    b, s, _ = x.shape
    qpos, row_pos = _decode_pos(pos, s, x.device)
    q, k, v = attn_qkv(p, x, cfg, qpos)
    ck = paged_write(cache["k"], k, pos, page_table)
    cv = paged_write(cache["v"], v, pos, page_table)
    if use_kernel and s == 1:
        from repro_torch.kernels.ops import paged_attn_decode
        o = paged_attn_decode(whole(q)[:, 0], whole_pool(ck),
                              whole_pool(cv), page_table, whole(row_pos),
                              scale=1.0 / math.sqrt(cfg.hd),
                              window=cfg.window)
        o = _residual_pin(o.reshape(b, s, -1).to(x.dtype), x)
        return dense(o, p["wo"]), {"k": ck, "v": cv}
    o = _attend_cache(q, paged_gather(ck, page_table),
                      paged_gather(cv, page_table), row_pos, cfg)
    return dense(_residual_pin(o.to(x.dtype), x), p["wo"]), \
        {"k": ck, "v": cv}


def attn_paged_cache_init(cfg: ModelConfig, n_pages: int, page_size: int,
                          dtype, device) -> dict:
    """Pool-shaped KV cache. ``n_pages`` INCLUDES the scratch page the
    allocator points inactive slots at (pass pool.n_pages + 1)."""
    shape = (n_pages, page_size, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = _dtype(cfg)
    d, hd, nh = cfg.d_model, cfg.hd, cfg.n_heads
    rd, kvl, ql = cfg.rope_head_dim, cfg.kv_lora, cfg.q_lora
    return {
        "wq_a": dense_init(gen, d, ql, dt, device),             # q down
        "q_norm": rmsnorm_init(ql, dt, device),
        "wq_b": dense_init(gen, ql, nh * (hd + rd), dt, device),  # q up
        "wkv_a": dense_init(gen, d, kvl + rd, dt, device),  # kv down + k_rope
        "kv_norm": rmsnorm_init(kvl, dt, device),
        "wk_b": dense_init(gen, kvl, nh * hd, dt, device),      # k up (nope)
        "wv_b": dense_init(gen, kvl, nh * hd, dt, device),      # v up
        "wo": dense_init(gen, nh * hd, d, dt, device),
    }


def _mla_qkv(p, x, cfg: ModelConfig, pos):
    """(q_nope (B,S,H,hd), q_rope (B,S,H,rd), c_kv (B,S,kvl),
    k_rope (B,S,1,rd)), rope applied at ``pos``."""
    b, s, _ = x.shape
    hd, nh, rd = cfg.hd, cfg.n_heads, cfg.rope_head_dim
    qa = rmsnorm(dense(x, p["wq_a"]), p["q_norm"])
    qb = dense(qa, p["wq_b"]).reshape(b, s, nh, hd + rd)
    q_nope = qb[..., :hd]
    # same rope layout pins as attn_qkv
    q_rope = shard(qb[..., hd:], "attn_q", fallback="replicate")
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    kva = dense(x, p["wkv_a"])
    c_kv = rmsnorm(kva[..., :cfg.kv_lora], p["kv_norm"])
    k_rope = shard(kva[..., cfg.kv_lora:].reshape(b, s, 1, rd), "attn_kv",
                   fallback="replicate")
    k_rope = apply_rope(k_rope, pos, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_heads(p, c_kv, k_rope, cfg: ModelConfig):
    """The per-head keys [k_nope | k_rope] (B, S, H, hd + rd) and values
    (B, S, H, hd) up-projected from the latent ``c_kv`` (B, S, kvl);
    ``k_rope`` (B, S, rd) is shared by every head."""
    b, s = c_kv.shape[:2]
    nh, hd, rd = cfg.n_heads, cfg.hd, cfg.rope_head_dim
    k_nope = dense(c_kv, p["wk_b"]).reshape(b, s, nh, hd)
    v = dense(c_kv, p["wv_b"]).reshape(b, s, nh, hd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, nh, rd)], -1)
    return k, v


def mla_prefill(p, x, cfg: ModelConfig, pos, *, window=None):
    """Full causal MLA over x (B, S, d) at positions ``pos``; returns the
    sublayer output and the compressed cache {c_kv (B,S,kvl),
    k_rope (B,S,rd)} in x's dtype (the prefill path of the LM)."""
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, pos)
    k, v = _mla_heads(p, c_kv, k_rope[:, :, 0], cfg)
    o = blockwise_attention(torch.cat([q_nope, q_rope], -1), k, v,
                            causal=True, window=window)
    return (dense(o.reshape(b, s, -1), p["wo"]),
            {"c_kv": c_kv, "k_rope": k_rope[:, :, 0]})


def mla_apply(p, x, cfg: ModelConfig, *, window=None):
    """Full (prefill/train) MLA self-attention."""
    pos = torch.arange(x.shape[1], device=x.device)
    return mla_prefill(p, x, cfg, pos, window=window)[0]


def _per_head(fn, a, w, cfg: ModelConfig):
    """``fn(a, w)`` for an activation ``a`` (B, s, H, ...) and an up-
    projection ``w`` (kvl, H*hd) whose product is independent per head.
    On a mesh each rank runs its own heads where ``w`` is split over
    heads (its output dim, whole heads per rank) and its own batch rows
    where ``a``'s are split; every other split is made whole. The result
    keeps those splits (DTensor's einsums here fail in torch 2.11: a
    reshape that would merge a split dim)."""
    if not is_dtensor(w):
        return fn(whole(a), w)
    from torch.distributed.tensor import Replicate, Shard
    mesh = w.device_mesh
    a = replicate_on(a, mesh)
    pa, pw = [], []
    for i, (p_a, p_w) in enumerate(zip(a.placements, w.placements)):
        if p_w.is_shard() and p_w.dim % 2 == 1 \
                and cfg.n_heads % mesh.size(i) == 0:
            pa.append(Shard(2))
            pw.append(Shard(1))
        elif p_a.is_shard() and p_a.dim % a.ndim == 0:
            pa.append(Shard(0))
            pw.append(Replicate())
        else:
            pa.append(Replicate())
            pw.append(Replicate())
    return run_local(fn, (a, w), (tuple(pa), tuple(pw)), tuple(pa))


def _absorbed_q(p, q_nope, cfg: ModelConfig):
    """The MLA decode trick: q_nope . (W_kb c) = (W_kb^T q_nope) . c, so
    q_c (B, s, H, kvl) scores the latent cache directly; fp32, as JAX's
    ``preferred_element_type=F32`` leaves it."""
    def absorb(qn, w):
        wkb = w.reshape(cfg.kv_lora, qn.shape[2], cfg.hd)
        return torch.einsum("bqhd,lhd->bqhl", qn.to(wkb.dtype).to(F32),
                            wkb.to(F32))
    return _per_head(absorb, q_nope, p["wk_b"], cfg)


def _mla_out(p, o_c, x, cfg: ModelConfig):
    """Absorb the v up-projection into the latent output o_c
    (B, s, H, kvl) fp32, then the out-projection."""
    b, s = o_c.shape[:2]

    def up(oc, w):
        wvb = w.reshape(cfg.kv_lora, oc.shape[2], cfg.hd)
        return torch.einsum("bqhl,lhd->bqhd", oc.to(wvb.dtype).to(F32),
                            wvb.to(F32))
    o = _per_head(up, o_c, p["wv_b"], cfg)
    return dense(o.reshape(b, s, -1).to(x.dtype), p["wo"])


def _mla_attend(p, x, q_nope, q_rope, cc, cr, row_pos, cfg: ModelConfig):
    """Absorbed-q decode attention over per-slot latent caches cc
    (B, T, kvl) and cr (B, T, rd) with the causal decode mask at
    ``row_pos``: the gather branch's math (q_c rounded to the cache's
    dtype before the score product, as JAX rounds it). On a mesh the
    scores and the latent output come from whole inputs on every rank."""
    q_c = whole(_absorbed_q(p, q_nope, cfg))
    q_rope, cc, cr, row_pos = (whole(t) for t in (q_rope, cc, cr, row_pos))
    s_c = torch.einsum("bqhl,bkl->bhqk", q_c.to(cc.dtype).to(F32),
                       cc.to(F32))
    s_r = torch.einsum("bqhd,bkd->bhqk", q_rope.to(cr.dtype).to(F32),
                       cr.to(F32))
    sc = (s_c + s_r) / math.sqrt(cfg.hd + cfg.rope_head_dim)
    mask = _decode_mask(cc.shape[1], row_pos, q_nope.shape[1], None)
    sc = torch.where(mask[:, None, :, :], sc,
                     torch.tensor(-1e30, dtype=F32, device=sc.device))
    pattn = _softmax(sc)
    o_c = torch.einsum("bhqk,bkl->bqhl", pattn.to(cc.dtype).to(F32),
                       cc.to(F32))
    return _mla_out(p, o_c, x, cfg)


def mla_decode(p, x, cfg: ModelConfig, cache, pos):
    """Decode with the *compressed* contiguous cache {c_kv (B,T,kvl),
    k_rope (B,T,rd)}, written in place; ``pos`` scalar or (B,)."""
    qpos, row_pos = _decode_pos(pos, x.shape[1], x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, qpos)
    cc = _cache_write(cache["c_kv"], c_kv, pos)
    cr = _cache_write(cache["k_rope"], k_rope[:, :, 0], pos)
    return (_mla_attend(p, x, q_nope, q_rope, cc, cr, row_pos, cfg),
            {"c_kv": cc, "k_rope": cr})


def mla_cache_init(cfg: ModelConfig, batch: int, t: int, dtype,
                   device) -> dict:
    return {"c_kv": torch.zeros((batch, t, cfg.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, t, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode_paged(p, x, cfg: ModelConfig, cache, pos, page_table,
                     use_kernel: bool = False):
    """MLA decode through the paged compressed-KV pools {c_kv (N,P,kvl),
    k_rope (N,P,rd)}, written in place.

    ``use_kernel=True`` (single-query steps) runs the absorbed-q
    attention through the paged-attention kernel: one KV group, the
    latent pool as both key and value (D = Dv = kvl), the rope term as
    the kernel's second score product (q2 = q_rope, k2_pool = k_rope),
    q_c in fp32 as JAX passes it. The gather branch rounds q_c to the
    pool's dtype before its score product, as JAX's does; in bf16 the
    two branches round differently in JAX too. On a mesh the kernel runs
    on every rank on whole inputs, as JAX pins them replicated."""
    b, s, _ = x.shape
    qpos, row_pos = _decode_pos(pos, s, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, qpos)
    cc_pool = paged_write(cache["c_kv"], c_kv, pos, page_table)
    cr_pool = paged_write(cache["k_rope"], k_rope[:, :, 0], pos, page_table)
    new = {"c_kv": cc_pool, "k_rope": cr_pool}
    if use_kernel and s == 1:
        from repro_torch.kernels.ops import paged_attn_decode
        q_c = whole(_absorbed_q(p, q_nope, cfg))
        latent = whole_pool(cc_pool).unsqueeze(2)   # (N, P, KV=1, kvl)
        # the kernel takes q and q2 in one dtype: bf16 q_rope is exact in
        # fp32, and both are rounded to the pool's dtype inside
        o_c = paged_attn_decode(
            q_c[:, 0].contiguous(), latent, latent, page_table,
            whole(row_pos),
            scale=1.0 / math.sqrt(cfg.hd + cfg.rope_head_dim),
            q2=whole(q_rope)[:, 0].to(F32).contiguous(),
            k2_pool=whole_pool(cr_pool).unsqueeze(2))
        return _mla_out(p, o_c[:, None], x, cfg), new
    return (_mla_attend(p, x, q_nope, q_rope, paged_gather(cc_pool,
                                                           page_table),
                        paged_gather(cr_pool, page_table), row_pos, cfg),
            new)


def mla_paged_cache_init(cfg: ModelConfig, n_pages: int, page_size: int,
                         dtype, device) -> dict:
    return {"c_kv": torch.zeros((n_pages, page_size, cfg.kv_lora),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((n_pages, page_size, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Gated MLPs
# ---------------------------------------------------------------------------

def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as JAX evaluates it, x * (1 / (1 + exp(-x))) with
    each op rounded to x's dtype: in bf16, ``F.silu``'s single rounding
    moves ~40% of outputs by an ulp, which SSD's scan and the layers
    after carry on. In fp32 the two agree to an ulp, and ``F.silu`` is
    one kernel."""
    if x.dtype == F32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: int | None = None) -> dict:
    dt = _dtype(cfg)
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, d, ff, dt, device),
        "w_up": dense_init(gen, d, ff, dt, device),
        "w_down": dense_init(gen, ff, d, dt, device),
    }


def mlp_apply(p, x, cfg: ModelConfig):
    g = dense(x, p["w_gate"])
    # jax.nn.gelu defaults to the tanh approximation; torch's is exact
    act = (F.gelu(g, approximate="tanh") if cfg.ffn == "geglu"
           else _silu(g))
    return dense(act * dense(x, p["w_up"]), p["w_down"])


# ---------------------------------------------------------------------------
# MoE (top-k, shared experts, capacity-dropped chunked dispatch)
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Router in fp32 whatever ``cfg.dtype``; expert weights stacked
    (E, d, ff) and (E, ff, d); ``n_shared`` experts as one MLP of width
    ``n_shared * moe_dff``."""
    dt = _dtype(cfg)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_dff

    def stack(rows, cols):
        w = torch.randn((e, rows, cols), generator=gen, device=device)
        return w.mul_(1.0 / math.sqrt(rows)).to(dt)

    p = {"router": dense_init(gen, d, e, F32, device),
         "w_gate": stack(d, ff), "w_up": stack(d, ff),
         "w_down": stack(ff, d)}
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, cfg, device, cfg.n_shared * cfg.moe_dff)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (``torch.topk`` promises no order on
    ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with JAX's ``preferred_element_type=F32``: the
    products summed in fp32 and returned in fp32. Low-precision operands
    go to fp32 first on the CPU (bf16 products are exact there); off the
    CPU cuBLAS takes them as they are and writes fp32, so a decode step
    reads each expert weight once, in its own dtype. ``bmm``'s
    ``out_dtype`` form has no derivative, so where autograd records the
    product (training) the operands go to fp32 first there too."""
    if a.dtype == F32 and b.dtype == F32:
        return torch.matmul(a, b)
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.device.type != "cpu" and not grad:
        return torch.bmm(a, b, out_dtype=F32)
    return torch.matmul(a.to(F32), b.to(F32))


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, d). GShard-style dispatch, as the JAX package does it:
    the B*S tokens split into chunks of ``min(moe_chunk, B*S)`` (the last
    one zero-padded), each expert takes at most ``cap`` assignments per
    chunk in token-major, k-minor order and drops the rest, and every
    expert multiplies its full capacity (empty slots included). So a
    token's output depends on the tokens it is batched with, in JAX as
    here. bf16 rounds where JAX rounds: the dispatch and combine weights
    and the gate values in the compute dtype, each product summed in fp32
    and cast back, silu on the fp32 gate product."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    chunk = min(cfg.moe_chunk, t)
    tp = -(-t // chunk) * chunk
    xt = pad(xt, (0, 0, 0, tp - t))
    g = tp // chunk
    cap = max(int(chunk * k / e * cfg.capacity_factor), 4)
    cd = x.dtype
    dev = x.device

    xg = shard(xt.reshape(g, chunk, d), "moe_groups")       # (G, C, d)
    logits = dense(xg.to(F32), p["router"])                 # (G, C, E)
    gate_vals, idx = _top_k(_softmax(logits), k)            # (G, C, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(idx, e).to(F32)                      # (G, C, k, E)
    flat = onehot.reshape(g, chunk * k, e)
    # a chunk's tokens whole on each rank: with G too small to split
    # over the data axes, the token dim C carries the batch's split, and
    # DTensor's cumsum has been seen to count each shard's tokens alone
    pos = along(flat, 1, lambda t: torch.cumsum(t, dim=1) - t)
    pos = pos.reshape(g, chunk, k, e)
    keep = (pos < cap) & (onehot > 0)
    slots = torch.arange(cap, device=dev)
    disp = torch.zeros((g, chunk, e, cap), dtype=cd, device=dev)
    comb = torch.zeros((g, chunk, e, cap), dtype=cd, device=dev)
    for kk in range(k):
        sel = onehot[:, :, kk] * keep[:, :, kk].to(F32)     # (G, C, E)
        # jax.nn.one_hot of a position past cap is all zeros, where
        # F.one_hot would raise: compare against the slot ids instead
        p_oh = (pos[:, :, kk].to(torch.int32)[..., None] == slots).to(F32)
        d_k = sel[..., None] * p_oh                         # (G, C, E, cap)
        disp = disp + d_k.to(cd)
        comb = comb + (gate_vals[:, :, kk, None, None] * d_k).to(cd)
    disp = shard(disp, "moe_dispatch")
    comb = shard(comb, "moe_dispatch")

    # dispatch: each (expert, slot) row is one token or zero, exact in cd
    xe = torch.matmul(disp.reshape(g, chunk, e * cap).transpose(1, 2), xg)
    xe = shard(xe.reshape(g, e, cap, d), "moe_experts")     # (G, E, cap, d)
    xe = xe.transpose(0, 1).reshape(e, g * cap, d)
    h = (F.silu(_mm_f32(xe, p["w_gate"])).to(cd)
         * _mm_f32(xe, p["w_up"]).to(cd))
    ye = _mm_f32(h, p["w_down"]).to(cd)                     # (E, G*cap, d)
    ye = shard(ye.reshape(e, g, cap, d).transpose(0, 1), "moe_experts")
    ye = ye.reshape(g, e * cap, d)
    y = _mm_f32(comb.reshape(g, chunk, e * cap), ye)        # (G, C, d)
    y = y.reshape(tp, d)[:t].reshape(b, s, d).to(x.dtype)
    if cfg.n_shared:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality, chunked)
# ---------------------------------------------------------------------------

def ssd_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Both in-projections of the JAX package: one fused ``w_in`` (z, x,
    B, C, dt) or, with ``cfg.ssd_split_proj``, one weight per stream.
    ``a_log``, ``d_skip`` and ``dt_bias`` stay fp32 whatever
    ``cfg.dtype``."""
    dt = _dtype(cfg)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.ssd_heads

    def conv(width):
        w = torch.randn((cfg.conv_k, width), generator=gen, device=device)
        return (w * 0.1).to(dt)

    p = {
        "a_log": torch.zeros((h,), dtype=F32, device=device),
        "d_skip": torch.ones((h,), dtype=F32, device=device),
        "dt_bias": torch.zeros((h,), dtype=F32, device=device),
        "out_norm": rmsnorm_init(di, dt, device),
        "w_out": dense_init(gen, di, d, dt, device),
    }
    if cfg.ssd_split_proj:
        p.update({
            "w_in_z": dense_init(gen, d, di, dt, device),
            "w_in_x": dense_init(gen, d, di, dt, device),
            "w_in_bc": dense_init(gen, d, 2 * n, dt, device),
            "w_in_dt": dense_init(gen, d, h, dt, device),
            "conv_w_x": conv(di),
            "conv_w_bc": conv(2 * n),
        })
    else:
        p.update({
            "w_in": dense_init(gen, d, 2 * di + 2 * n + h, dt, device),
            "conv_w": conv(di + 2 * n),
        })
    return p


def _ssd_in_proj(p, x, cfg: ModelConfig):
    """Returns (z, conv_in, dt) where conv_in = [x, B, C]."""
    di, n = cfg.d_inner, cfg.d_state
    if cfg.ssd_split_proj:
        z = dense(x, p["w_in_z"])
        xin = dense(x, p["w_in_x"])
        bcmat = dense(x, p["w_in_bc"])
        dtp = dense(x, p["w_in_dt"])
        return z, torch.cat([xin, bcmat], -1), dtp
    zxbcdt = dense(x, p["w_in"])
    z, xin, bmat, cmat, dtp = torch.split(
        zxbcdt, [di, di, n, n, zxbcdt.shape[-1] - 2 * di - 2 * n], dim=-1)
    return z, torch.cat([xin, bmat, cmat], -1), dtp


def _ssd_conv_weight(p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.ssd_split_proj:
        return torch.cat([p["conv_w_x"], p["conv_w_bc"]], -1)
    return p["conv_w"]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) -> (..., L, L) lower-tri cumulative sums for decay."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(l, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, torch.tensor(-math.inf, dtype=x.dtype,
                                                 device=x.device))


def ssd_scan(x, dt, a, bmat, cmat, chunk: int):
    """SSD chunked scan (Dao & Gu 2024), as the JAX package computes it.

    x: (B,S,H,P) dt: (B,S,H) a: (H,) neg-decay, b,c: (B,S,N).
    Returns y: (B,S,H,P) in x's dtype and the final state (B,H,P,N)
    fp32. JAX's three-operand einsums are contracted pairwise (the
    broadcast product of all three would hold (B,C,L,L,H,P)); its
    inter-chunk ``lax.scan`` is a loop over chunks that carries an fp32
    state and keeps the state before each chunk. On a mesh it runs on each
    rank's batch rows (every other dim whole): the scan is independent
    per row, and its flips and cumulative sums along L are not DTensor's
    to place (:func:`_rows_local`)."""
    if is_dtensor(x):
        return _rows_local(ssd_scan, (x, dt, a, bmat, cmat), (0, 0, None,
                                                              0, 0),
                           (0, 0), chunk=chunk)
    bsz, s, h, p_dim = x.shape
    n = bmat.shape[-1]
    sp = -(-s // chunk) * chunk
    extra = sp - s
    x = pad(x, (0, 0, 0, 0, 0, extra))
    dt = pad(dt, (0, 0, 0, extra))
    bmat = pad(bmat, (0, 0, 0, extra))
    cmat = pad(cmat, (0, 0, 0, extra))
    nc = sp // chunk

    xr = x.reshape(bsz, nc, chunk, h, p_dim)
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = bmat.reshape(bsz, nc, chunk, n)
    cr = cmat.reshape(bsz, nc, chunk, n)

    da = dtr * a                                  # (B,C,L,H) decay logs (<=0)
    dax = xr * dtr[..., None]                     # dt-weighted inputs

    # intra-chunk (quadratic within chunk)
    lmat = torch.exp(_segsum(da.transpose(2, 3)))           # (B,C,H,L,L)
    scores = torch.einsum("bcln,bckn->bclk", cr, br)        # (B,C,L,L)
    y_diag = torch.einsum("bchlk,bckhp->bclhp",
                          scores[:, :, None] * lmat, dax)

    # chunk-final states
    rev = torch.flip(torch.cumsum(torch.flip(da, [2]), dim=2), [2])
    decay_end = torch.exp(rev - da)                          # sum_{l'>l}
    states = torch.einsum("bcln,bclhp->bchpn", br,
                          decay_end[..., None] * dax)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(torch.sum(da, dim=2))            # (B,C,H)
    st = torch.zeros((bsz, h, p_dim, n), dtype=F32, device=x.device)
    prior = []
    for c in range(nc):
        prior.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c].to(F32)
    prior = torch.stack(prior, dim=1)                        # (B,C,H,P,N)

    # off-diagonal contribution: carried state into each position
    decay_in = torch.exp(torch.cumsum(da, dim=2))            # from chunk start
    y_off = (torch.einsum("bcln,bchpn->bclhp", cr, prior)
             * decay_in[..., None])

    y = (y_diag + y_off).reshape(bsz, sp, h, p_dim)[:, :s]
    return y.to(x.dtype), st


def _pin(t):
    """An SSD stream (B, S, C) on the "ssd_inner" layout: batch-parallel,
    replicated where the batch cannot split. JAX's anchors: a weight's
    output-dim split must not reach the conv shifts, the head reshapes
    and the scan's cumulative sums."""
    return shard(t, "ssd_inner", fallback="replicate")


def _ssd_streams(p, x, cfg: ModelConfig):
    """The in-projection's z, conv input and dt, each pinned (:func:`_pin`);
    the conv output is pinned again (``conv_w`` is model-split on its
    conv dim)."""
    return tuple(_pin(t) for t in _ssd_in_proj(p, x, cfg))


def _rows_local(fn, args, batch_dims, out_batch_dims, **kw):
    """``fn(*args, **kw)`` on each rank's batch rows: on every mesh dim
    where the first argument's batch dim is split, each argument with a
    batch dim (``batch_dims``: its index, or None) is split there too;
    every other dim of every argument whole. The results' batch dims
    (``out_batch_dims``) keep the split. For an ``fn`` independent per
    batch row."""
    from torch.distributed.tensor import Replicate, Shard
    lead = args[0]
    split = [p.is_shard() and p.dim % lead.ndim == batch_dims[0]
             for p in lead.placements]

    def pls(bd):
        return tuple(Shard(bd) if s and bd is not None else Replicate()
                     for s in split)
    return run_local(lambda *t: fn(*t, **kw), args,
                     [pls(bd) for bd in batch_dims],
                     tuple(pls(bd) for bd in out_batch_dims))


def _ssd_conv(conv_in, cw, k: int):
    """Causal depthwise conv via k shifted adds, summed in x's dtype in
    JAX's order (k is tiny)."""
    s = conv_in.shape[1]
    conv = 0
    for i in range(k):
        conv = conv + pad(conv_in, (0, 0, k - 1 - i, 0))[:, :s] * cw[i]
    return conv


def _ssd_out(p, z, xh, y, x, cfg: ModelConfig):
    """The skip term, gated norm and out-projection after the scan."""
    bsz, s = x.shape[:2]
    y = y + xh.to(F32) * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, cfg.d_inner).to(x.dtype)
    y = shard(y, "ssd_inner", fallback="replicate")
    y = rmsnorm(y, p["out_norm"]) * _silu(z)
    return dense(y, p["w_out"])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) at every x (``F.softplus``
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssd_prefill(p, x, cfg: ModelConfig):
    """The mamba2 block over a prompt x (B, S, d): returns (out, conv
    state (B, min(S, k-1), conv_dim) in x's dtype, final SSM state
    (B, H, P, N) fp32). A prompt shorter than ``conv_k - 1`` tokens keeps
    ``conv_in[:, S-(k-1):]``, fewer rows than the cache holds, as the
    JAX package's ``lm._ssd_prefill`` does."""
    bsz, s, _ = x.shape
    di, n = cfg.d_inner, cfg.d_state
    z, conv_in, dtp = _ssd_streams(p, x, cfg)
    k = cfg.conv_k
    conv = _silu(_pin(_ssd_conv(conv_in, _ssd_conv_weight(p, cfg), k)))
    xc, bc, cc = torch.split(conv, [di, n, n], dim=-1)
    xh = xc.reshape(bsz, s, cfg.ssd_heads, cfg.ssd_headdim)
    a = -torch.exp(p["a_log"])                               # (H,) < 0
    dt_full = _softplus(dtp.to(F32) + p["dt_bias"])          # (B,S,H)
    y, final = ssd_scan(xh, dt_full, a, bc.to(F32), cc.to(F32),
                        cfg.ssd_chunk)
    return (_ssd_out(p, z, xh, y, x, cfg), conv_in[:, s - (k - 1):],
            final)


def ssd_block_apply(p, x, cfg: ModelConfig, conv_state=None,
                    ssm_state=None, decode: bool = False):
    """Full mamba2 block: in-proj -> conv -> SSD -> gated norm -> out-proj.

    Train/prefill: decode=False, states None -> returns y only.
    Decode: x is (B,1,d) and the states (B, k-1, conv_dim) and
    (B, H, P, N); returns (y, new conv state, new SSM state), the update
    computed in fp32 and the SSM state stored in ``ssm_state``'s dtype.
    The states passed in are not written. On a mesh the step runs on each
    rank's batch rows with every other dim whole: the streams' splits
    and the SSM state's head split (JAX's ``replicated(ssm_state)``) are
    made whole first, so the conv and the state update see no split (what
    JAX's "ssd_inner" anchors and its pin on the conv output ask)."""
    if not decode:
        return ssd_prefill(p, x, cfg)[0]
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.ssd_heads, cfg.ssd_headdim
    z, conv_in, dtp = _ssd_in_proj(p, x, cfg)

    def step(conv_in, dtp, conv_state, ssm_state, cw, a_log, dt_bias):
        hist = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)
        # JAX's einsum over the k taps: a dot summed in fp32, rounded once
        conv = (hist.to(F32) * cw.to(F32)).sum(1)
        conv = _silu(conv.to(conv_in.dtype)[:, None])
        xc, bc, cc = torch.split(conv, [di, n, n], dim=-1)
        xh = xc.reshape(conv_in.shape[0], 1, h, pd)
        a = -torch.exp(a_log)
        dt1 = _softplus(dtp.to(F32) + dt_bias)[:, 0]          # (B,H)
        st = ssm_state.to(F32)                                # (B,H,P,N)
        da = torch.exp(dt1 * a[None, :])
        dbx = ((dt1[:, :, None] * xh[:, 0].to(F32))[..., None]
               * bc[:, 0].to(F32)[:, None, None, :])
        st = st * da[..., None, None] + dbx
        y = torch.einsum("bn,bhpn->bhp", cc[:, 0].to(F32), st)
        return xh, y[:, None], hist[:, 1:], st.to(ssm_state.dtype)

    args = (conv_in, dtp, conv_state, ssm_state, _ssd_conv_weight(p, cfg),
            p["a_log"], p["dt_bias"])
    if is_dtensor(conv_in):
        xh, y, conv, ssm = _rows_local(step, args,
                                       (0, 0, 0, 0, None, None, None),
                                       (0, 0, 0, 0))
    else:
        xh, y, conv, ssm = step(*args)
    return _ssd_out(p, z, xh, y, x, cfg), conv, ssm


def ssd_step(p, x, cfg: ModelConfig, cache: dict):
    """One decode step of the block through its per-slot state cache
    {conv, ssm}, written in place (each rank its own part on a mesh);
    returns (y, cache)."""
    y, conv, ssm = ssd_block_apply(p, x, cfg, conv_state=cache["conv"],
                                   ssm_state=cache["ssm"], decode=True)
    copy_into(cache["conv"], conv)
    copy_into(cache["ssm"], ssm)
    return y, cache


def ssd_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.conv_k - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssd_heads, cfg.ssd_headdim,
                            cfg.d_state),
                           dtype=getattr(torch, cfg.ssd_state_dtype),
                           device=device),
    }


# ---------------------------------------------------------------------------
# Hybrid (hymba): parallel attention + SSD heads, outputs fused
# ---------------------------------------------------------------------------

def hybrid_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = _dtype(cfg)
    return {
        "attn": attn_init(gen, cfg, device),
        "ssd": ssd_init(gen, cfg, device),
        "attn_norm": rmsnorm_init(cfg.d_model, dt, device),
        "ssd_norm": rmsnorm_init(cfg.d_model, dt, device),
    }


def hybrid_fuse(p, ya, ys):
    """The two heads' outputs, each normalized, averaged."""
    return 0.5 * (rmsnorm(ya, p["attn_norm"]) + rmsnorm(ys, p["ssd_norm"]))


def hybrid_apply(p, x, cfg: ModelConfig, *, window=None):
    ya = attn_apply(p["attn"], x, cfg, window=window)
    ys = ssd_block_apply(p["ssd"], x, cfg)
    return hybrid_fuse(p, ya, ys)


def hybrid_decode(p, x, cfg: ModelConfig, cache, pos):
    """Decode through the contiguous cache {attn: {k, v}, ssd: {conv,
    ssm}}, written in place."""
    ya, _ = attn_decode(p["attn"], x, cfg, cache["attn"], pos)
    ys, _ = ssd_step(p["ssd"], x, cfg, cache["ssd"])
    return hybrid_fuse(p, ya, ys), cache


def hybrid_decode_paged(p, x, cfg: ModelConfig, cache, pos, page_table,
                        use_kernel: bool = False):
    """Hybrid decode: the attention KV goes through the paged pool (and
    with ``use_kernel``, the paged-attention kernel), the SSM/conv state
    (no time dim, nothing to page) stays per slot; written in place."""
    ya, _ = attn_decode_paged(p["attn"], x, cfg, cache["attn"], pos,
                              page_table, use_kernel)
    ys, _ = ssd_step(p["ssd"], x, cfg, cache["ssd"])
    return hybrid_fuse(p, ya, ys), cache

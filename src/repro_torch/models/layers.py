"""Layer primitives of the decoder LM, the subset the paged serve path runs.

A port of ``repro.models.layers``: dense projections, RMSNorm, RoPE,
blockwise (flash-style) causal attention for prefill, the GQA attention
sublayer with its paged decode, and the gated MLP. Each function keeps
the JAX package's layouts and numerics: parameters in ``cfg.dtype``,
matmul accumulation, softmax and norms in fp32, ``-1e30`` (not -inf)
for masked scores. Where JAX asks for ``preferred_element_type=F32`` on
a low-precision product, the port casts the operands to fp32 first:
a product of two bf16 values is exact in fp32, so only the summation
order differs.

The JAX package pins layouts with ``shard(...)``/``replicated()`` to work
around XLA:CPU SPMD miscompiles; the port has no mesh and drops them.
The cache primitives write in place (``_cache_write``, ``paged_write``),
where JAX returns a new array: it saves a copy of the whole cache per
layer and step. MLA, SSD, hybrid and MoE layers wait for later slices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    nested ``lax.scan``s, written as two Python loops."""
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
    qp = F.pad(q, (0, 0, 0, 0, 0, sp - s))
    kp = F.pad(k, (0, 0, 0, 0, 0, tp - t))
    vp = F.pad(v, (0, 0, 0, 0, 0, tp - t))
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
    single-chunk prefill's row (prompts within one kv chunk)."""
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
    q = dense(x, p["wq"]).reshape(b, s, nh, hd)
    k = dense(x, p["wk"]).reshape(b, s, nkv, hd)
    v = dense(x, p["wv"]).reshape(b, s, nkv, hd)
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
    vector (continuous batching: each slot at its own depth). Returns the
    rope positions of the s query tokens, (s,) or (B, s), and
    ``row_pos`` shaped (1,) or (B,) for per-row cache masking."""
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
    the buffer lands shifted back inside it, not cut off."""
    b, s = new.shape[0], new.shape[1]
    t = buf.shape[1]
    dev = buf.device
    start = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    start = start.reshape(-1).expand(b)
    start = torch.clamp(torch.where(start < 0, start + t, start), 0, t - s)
    rows = torch.arange(b, device=dev)[:, None]
    buf[rows, start[:, None] + torch.arange(s, device=dev)] = \
        new.to(buf.dtype)
    return buf


def _attend_cache(q, kc, vc, row_pos, cfg: ModelConfig):
    """Decode attention of the s query tokens ``q`` (B, s, H, D) against
    a per-slot cache (B, T, KV, D), with the causal decode mask at
    ``row_pos``. Returns (B, s, H*Dv) fp32."""
    b, s = q.shape[0], q.shape[1]
    t, kv = kc.shape[1], kc.shape[2]
    qh = q.reshape(b, s, kv, cfg.n_heads // kv, cfg.hd)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qh.to(kc.dtype).to(F32),
                      kc.to(F32))
    sc = sc / math.sqrt(cfg.hd)
    mask = _decode_mask(t, row_pos, s, cfg.window)      # (1|B, S, T)
    sc = torch.where(mask[:, None, None, :, :], sc,
                     torch.tensor(-1e30, dtype=F32, device=sc.device))
    # jax.nn.softmax's own form: exp(x - max) / sum
    e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    pattn = e / torch.sum(e, dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bkgd->bqgrd", pattn.to(vc.dtype).to(F32),
                     vc.to(F32))
    return o.reshape(b, s, -1)


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
    o = _attend_cache(q, ck, cv, row_pos, cfg).to(x.dtype)
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
    unspecified on the card, and nothing reads it unmasked."""
    b, s = new.shape[0], new.shape[1]
    psz = pool.shape[1]
    dev = pool.device
    posv = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    posv = posv.reshape(-1).expand(b)[:, None] + torch.arange(s, device=dev)
    logical = torch.clamp(posv // psz, 0, page_table.shape[1] - 1)
    page = torch.gather(page_table.long(), 1, logical)
    pool[page, posv % psz] = new.to(pool.dtype)
    return pool


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Each slot's logical time extent out of the pool: (N, P, ...)
    gathered through (B, max_pages) -> (B, max_pages*P, ...). Unmapped
    entries gather the scratch page, at logical positions the
    ``kpos <= pos`` mask removes exactly."""
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
    single-query (s == 1); multi-token steps take the gather path."""
    b, s, _ = x.shape
    qpos, row_pos = _decode_pos(pos, s, x.device)
    q, k, v = attn_qkv(p, x, cfg, qpos)
    ck = paged_write(cache["k"], k, pos, page_table)
    cv = paged_write(cache["v"], v, pos, page_table)
    if use_kernel and s == 1:
        from repro_torch.kernels.ops import paged_attn_decode
        o = paged_attn_decode(q[:, 0], ck, cv, page_table, row_pos,
                              scale=1.0 / math.sqrt(cfg.hd),
                              window=cfg.window)
        o = o.reshape(b, s, -1).to(x.dtype)
        return dense(o, p["wo"]), {"k": ck, "v": cv}
    o = _attend_cache(q, paged_gather(ck, page_table),
                      paged_gather(cv, page_table), row_pos, cfg)
    return dense(o.to(x.dtype), p["wo"]), {"k": ck, "v": cv}


def attn_paged_cache_init(cfg: ModelConfig, n_pages: int, page_size: int,
                          dtype, device) -> dict:
    """Pool-shaped KV cache. ``n_pages`` INCLUDES the scratch page the
    allocator points inactive slots at (pass pool.n_pages + 1)."""
    shape = (n_pages, page_size, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Gated MLPs
# ---------------------------------------------------------------------------

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
           else F.silu(g))
    return dense(act * dense(x, p["w_up"]), p["w_down"])

"""Plain PyTorch versions of the port's kernels.

``csb_mvm_ref`` takes exactly the arguments of the CUDA kernel's wrapper
(``csb_mvm.csb_mvm_cuda``) and returns what the kernel returns: the
``(B, Br*bm)`` fp32 product of a batch already padded to the block grid,
with the pad lanes masked by ``m``/``n``. On the CPU ``ops.csb_matvec``
runs it in place of the kernel; on the card it is only the comparison
point. ``densify`` rebuilds the ``(out, in)`` matrix; it is exact, since
each element is placed, never summed with another.

``paged_attn_ref`` takes exactly the arguments of the paged-attention
kernel's wrapper (``paged_attn.paged_attn_cuda``) and returns what the
kernel returns: the ``(B, H, Dv)`` fp32 single-query attention of every
slot over its pages, computed as the JAX package's gather path computes
it (``repro.models.layers.attn_decode_paged``): gather the table's pages,
scores in fp32, mask with ``-1e30``, ``exp(s - max) / sum``, then the
probabilities rounded to the pool's type times V in fp32. Each score's
dot product is summed exactly and rounded to fp32 once, so that the
comparison with the kernel measures the kernel, not this version's own
summation order over wide heads.
"""
from __future__ import annotations

import torch

from repro_torch.core.csb_format import PaddedCSB


def _dense_padded(vals, row_idx, col_idx, m, n, grid, block) -> torch.Tensor:
    """(Br*bm, Bc*bn) matrix in ``vals.dtype``: the live ``(m, n)`` corner
    of every kernel scattered into its block's frame."""
    nb, pm, pn = vals.shape
    br, bc = grid
    bm, bn = block
    dev = vals.device
    live = ((torch.arange(pm, device=dev)[None, :, None] < m[:, None, None])
            & (torch.arange(pn, device=dev)[None, None, :] < n[:, None, None]))
    b, k, l = live.nonzero(as_tuple=True)
    blocks = torch.zeros((nb, bm, bn), dtype=vals.dtype, device=dev)
    blocks.index_put_((b, row_idx[b, k].long(), col_idx[b, l].long()),
                      vals[b, k, l], accumulate=True)
    return blocks.reshape(br, bc, bm, bn).permute(0, 2, 1, 3).reshape(
        br * bm, bc * bn)


def densify(p: PaddedCSB) -> torch.Tensor:
    """(out, in) dense matrix equal to the CSB contents, in ``p``'s dtype."""
    w = _dense_padded(p.vals, p.row_idx, p.col_idx, p.m, p.n, p.grid, p.block)
    return w[: p.shape[0], : p.shape[1]]


def csb_mvm_ref(vals, row_idx, col_idx, m, n, x, *, grid, block
                ) -> torch.Tensor:
    """y = x @ W^T in fp32 for the padded CSB arrays; x: (B, Bc*bn) ->
    (B, Br*bm), the kernel's contract."""
    if x.shape[-1] != grid[1] * block[1]:
        raise ValueError(
            f"x has {x.shape[-1]} columns, the block grid {grid[1] * block[1]}")
    w = _dense_padded(vals, row_idx, col_idx, m, n, grid, block)
    return x.to(torch.float32) @ w.to(torch.float32).T


def paged_attn_ref(q, k_pool, v_pool, page_table, pos, *, scale: float,
                   q2=None, k2_pool=None, window: int | None = None
                   ) -> torch.Tensor:
    """(B, H, Dv) fp32: q (B, H, D) against the pools (N, P, KV, D|Dv)
    through page_table (B, max_pages); ``pos`` (the position decoded this
    step) is an int, (1,) or (B,); optional rope term q2 (B, H, D2) with
    k2_pool (N, P, KV, D2); keys ``kpos <= pos`` (and
    ``kpos > pos - window``) attend."""
    b, h, d = q.shape
    mp = page_table.shape[1]
    dev = q.device

    def gather(pool):                      # (B, max_pages * P, KV, Dx)
        g = pool[page_table.long()]
        return g.reshape((b, mp * pool.shape[1]) + tuple(pool.shape[2:]))

    kg, vg = gather(k_pool), gather(v_pool)
    t, kv = kg.shape[1], kg.shape[2]
    rep = h // kv
    f32 = torch.float32
    f64 = torch.float64
    # each dot product summed exactly (fp64 holds every fp32 product) and
    # rounded to fp32 once: an fp32 sum over 512 dims (MLA) already moves
    # the output by ~1e-6, which would swamp the comparison with the kernel
    qh = q.reshape(b, kv, rep, d).to(kg.dtype)
    sc = torch.einsum("bgrd,bkgd->bgrk", qh.to(f64), kg.to(f64)).to(f32)
    if q2 is not None:
        k2g = gather(k2_pool)
        q2h = q2.reshape(b, kv, rep, -1).to(k2g.dtype)
        sc = sc + torch.einsum("bgrd,bkgd->bgrk", q2h.to(f64),
                               k2g.to(f64)).to(f32)
    row = torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(-1)
    row = row.expand(b)
    kpos = torch.arange(t, device=dev)
    mask = kpos[None, :] <= row[:, None]
    if window is not None:
        mask &= kpos[None, :] > row[:, None] - window
    sc = torch.where(mask[:, None, None, :], sc * scale,
                     torch.tensor(-1e30, dtype=f32, device=dev))
    e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    o = torch.einsum("bgrk,bkgd->bgrd", p.to(vg.dtype).to(f32), vg.to(f32))
    return o.reshape(b, h, -1)

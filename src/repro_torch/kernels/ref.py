"""Plain PyTorch versions of the CSB-MVM kernel.

``csb_mvm_ref`` takes exactly the arguments of the CUDA kernel's wrapper
(``csb_mvm.csb_mvm_cuda``) and returns what the kernel returns: the
``(B, Br*bm)`` fp32 product of a batch already padded to the block grid,
with the pad lanes masked by ``m``/``n``. On the CPU ``ops.csb_matvec``
runs it in place of the kernel; on the card it is only the comparison
point. ``densify`` rebuilds the ``(out, in)`` matrix; it is exact, since
each element is placed, never summed with another.
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

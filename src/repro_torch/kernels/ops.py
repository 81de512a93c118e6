"""``csb_matvec``: the public CSB matrix-vector product.

It accepts any leading batch shape (including none — a single vector,
the paper's MVM case), pads batch/feature dims to the kernel's tile grid
and strips the padding off the result, as ``repro.kernels.ops`` does.
The tensor's device picks the implementation: on the card the CUDA
kernel, on the CPU its plain version, with the same padded arguments.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core.csb_format import PaddedCSB

from .csb_mvm import csb_mvm_cuda
from .ref import csb_mvm_ref


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def pad_to_grid(x2: torch.Tensor, batch_tile: int, in_cols: int
                ) -> torch.Tensor:
    """Pad a flattened (B, in_dim) batch to the kernel's tile grid:
    batch up to a batch_tile multiple, features up to the block grid's
    ``Bc * bn`` columns."""
    b = x2.shape[0]
    bp = _round_up(max(b, 1), batch_tile)
    return F.pad(x2, (0, in_cols - x2.shape[-1], 0, bp - b))


def csb_matvec(p: PaddedCSB, x: torch.Tensor, *, batch_tile: int = 8,
               group: int | None = None, device=None) -> torch.Tensor:
    """y = x @ W^T for CSB W;  x: (..., in_dim) -> (..., out_dim) fp32.

    ``device=None`` means the card; ``x`` and ``p`` must lie on the device
    the call runs on. ``group`` (default 1) must divide ``Bc``: on the
    card it sets how many blocks the kernel stages per pass."""
    dev = resolve_device(device)
    for name, t in (("x", x), ("p.vals", p.vals)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, but the call runs "
                             f"on {dev}")
    group = 1 if group is None else group
    br, bc = p.grid
    bm, bn = p.block
    if bc % group:
        raise ValueError(f"group {group} must divide Bc={bc}")
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xp = pad_to_grid(x2, batch_tile, bc * bn).contiguous()
    arrays = (p.vals, p.row_idx, p.col_idx, p.m, p.n, xp)
    if dev.type == "cuda":
        y = csb_mvm_cuda(*arrays, grid=p.grid, block=p.block,
                         batch_tile=batch_tile, group=group)
    else:
        y = csb_mvm_ref(*arrays, grid=p.grid, block=p.block)
    return y[: x2.shape[0], : p.shape[0]].reshape(*batch_shape, p.shape[0])

"""CSB projection (Algorithm 1's RowPrune/ColumnPrune) — the Euclidean
projection onto the CSB-constrained set S (Eqn. 6 of the paper).

The port of ``repro.core.pruning``; masks are bit-equal to it.

A weight matrix has shape ``(out_dim, in_dim)``; it is tiled into
``Br x Bc`` blocks of ``(bm, bn)`` (zero-padded when not divisible).
Within each *block-column* a fraction of rows is pruned globally by
l2-norm (RowPrune), then within each *block-row* a fraction of columns
(ColumnPrune). Because the thresholds are global per block-column/-row,
the per-block kernel sizes ``m(i,j) x n(i,j)`` vary.

Per Algorithm 1 both passes use rate ``1 - sqrt(1 - prune_rate)`` so the
combined kept fraction is ``~ 1 - prune_rate``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CSBSpec:
    """Pruning spec for one weight matrix."""

    bm: int = 32          # block rows (output-neuron slice)
    bn: int = 32          # block cols (input-neuron slice)
    prune_rate: float = 0.5  # fraction of weights REMOVED, in [0, 1)

    @property
    def keep_fraction(self) -> float:
        return 1.0 - self.prune_rate

    @property
    def compression_ratio(self) -> float:
        """Paper's headline 'pruning rate' (e.g. 25x) = orig/pruned."""
        return 1.0 / max(self.keep_fraction, 1e-12)

    def with_rate(self, prune_rate: float) -> "CSBSpec":
        return dataclasses.replace(self, prune_rate=float(prune_rate))


def _grid(shape, bm: int, bn: int) -> tuple[int, int]:
    out_dim, in_dim = shape
    return -(-out_dim // bm), -(-in_dim // bn)


def pad_to_blocks(w: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    out_dim, in_dim = w.shape
    br, bc = _grid(w.shape, bm, bn)
    return F.pad(w, (0, bc * bn - in_dim, 0, br * bm - out_dim))


def to_blocks(w: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(out, in) -> (Br, Bc, bm, bn)."""
    br, bc = _grid(w.shape, bm, bn)
    wp = pad_to_blocks(w, bm, bn)
    return wp.reshape(br, bm, bc, bn).permute(0, 2, 1, 3)


def from_blocks(blocks: torch.Tensor, shape) -> torch.Tensor:
    br, bc, bm, bn = blocks.shape
    wp = blocks.permute(0, 2, 1, 3).reshape(br * bm, bc * bn)
    return wp[: shape[0], : shape[1]]


def _topk_mask(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Exact-count keep mask of the ``keep`` largest entries along dim -1.

    Argsort-based so ties (e.g. zero padding) never inflate the kept
    count. The sort must be stable, as ``jnp.argsort`` is: among equal
    scores the earlier entry ranks lower, so ties keep the same rows as
    the JAX package does.
    """
    n = scores.shape[-1]
    order = torch.argsort(
        torch.argsort(scores, dim=-1, stable=True), dim=-1, stable=True)
    return order >= (n - keep)


def csb_masks(w: torch.Tensor, spec: CSBSpec
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compute per-block row/col keep masks for the CSB projection.

    Returns ``row_mask (Br, Bc, bm)`` and ``col_mask (Br, Bc, bn)`` (bool).
    Rank-3 inputs (stacked layers, leading L axis) are masked per layer.

    The l2 scores are sums of squares taken in fp32 and rounded once to
    the weight's dtype: what XLA computes for the JAX package's jitted
    ``csb_project`` (the self-draft's projection), which drops the bf16
    rounding of each square that an eager bf16 evaluation would keep.
    fp32 weights are unaffected.
    """
    if w.ndim == 3:
        rms, cms = zip(*(csb_masks(x, spec) for x in w))
        return torch.stack(rms), torch.stack(cms)
    bm, bn = spec.bm, spec.bn
    blocks = to_blocks(w, bm, bn).to(torch.float32)  # (Br, Bc, bm, bn)
    br, bc = blocks.shape[:2]
    q = 1.0 - math.sqrt(max(1.0 - spec.prune_rate, 0.0))

    # --- RowPrune: per block-column, over all Br*bm row slices ----------
    rn = torch.sum(blocks * blocks, dim=3).to(w.dtype)  # (Br, Bc, bm)
    keep_r = max(int(round((1.0 - q) * br * bm)), 1)
    rn_col = rn.permute(1, 0, 2).reshape(bc, br * bm)
    row_mask = _topk_mask(rn_col, keep_r)
    row_mask = row_mask.reshape(bc, br, bm).permute(1, 0, 2)  # (Br,Bc,bm)

    # --- ColumnPrune: per block-row, on the row-masked blocks -----------
    masked = blocks * row_mask[..., :, None]
    cn = torch.sum(masked * masked, dim=2).to(w.dtype)  # (Br, Bc, bn)
    keep_c = max(int(round((1.0 - q) * bc * bn)), 1)
    cn_row = cn.reshape(br, bc * bn)
    col_mask = _topk_mask(cn_row, keep_c).reshape(br, bc, bn)

    return row_mask, col_mask


def element_mask(shape, spec: CSBSpec, row_mask: torch.Tensor,
                 col_mask: torch.Tensor) -> torch.Tensor:
    """Expand block row/col masks to a dense (out, in) element mask."""
    full = row_mask[..., :, None] & col_mask[..., None, :]
    return from_blocks(full, shape)


def csb_project(w: torch.Tensor, spec: CSBSpec) -> torch.Tensor:
    """Project ``w`` onto the CSB pattern: Z = proj_S(w) (Eqn. 6).

    Rank-3 inputs (stacked layers) are projected per layer."""
    if w.ndim == 3:
        return torch.stack([csb_project(x, spec) for x in w])
    row_mask, col_mask = csb_masks(w, spec)
    return w * element_mask(w.shape, spec, row_mask, col_mask).to(w.dtype)


def kernel_sizes(w: torch.Tensor, spec: CSBSpec
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block kernel dims ``m (Br,Bc)``, ``n (Br,Bc)`` of a CSB matrix."""
    row_mask, col_mask = csb_masks(w, spec)
    return row_mask.sum(-1), col_mask.sum(-1)


def density(w: torch.Tensor) -> torch.Tensor:
    return (w != 0).to(torch.float32).mean()

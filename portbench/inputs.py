"""A configuration's weights, made on the device from the seed.

Each matrix is a ``synthetic_rnn_weight`` scaled by ``1/sqrt(in_dim)``,
with each row's and each column's sign drawn from the seed, and projected
onto the CSB pattern that keeps at most ``1/compression`` of its elements
(``csb_masks_at``); each bias is ``bias_scale`` times a normal draw
from the seed. The magnitudes come from the configuration's fixed
``pattern_seed``: the pattern, and so every block's kernel size and the
work of a step, is the same for every seed (the padded kernel sizes, and
with them the kernel's time, would otherwise move with the seed). The
benchmark hands the program the pruned dense matrix and its masks, and
the reference the same pruned matrix.

Frozen copies, rewritten in PyTorch, whose originals are not imported:
``synthetic_weight`` from ``benchmarks/common.py::synthetic_rnn_weight``,
``csb_masks`` from ``src/repro_torch/core/pruning.py::csb_masks``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _seed(seed: int) -> int:
    return int(seed) % 2**63


def synthetic_weight(base: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, imbalance: float = 1.5,
                     diag_boost: float = 3.0) -> torch.Tensor:
    """RNN-like heavy-tailed, block-imbalanced magnitudes with a dense
    diagonal band, from standard normal draws ``base`` (out, in), ``rows``
    (out, 1) and ``cols`` (1, in)."""
    out_dim, in_dim = base.shape
    w = (base * torch.exp(rows * (imbalance * 0.4))
         * torch.exp(cols * (imbalance * 0.25)))
    ii = torch.arange(out_dim, device=base.device)[:, None]
    jj = torch.arange(in_dim, device=base.device)[None, :]
    band = (ii * in_dim - jj * out_dim).abs() < 0.04 * out_dim * in_dim
    return torch.where(band, w * diag_boost, w)


def _topk_mask(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """The ``keep`` largest entries along the last axis; among equal
    scores the earlier entry ranks lower (a stable sort)."""
    n = scores.shape[-1]
    order = torch.argsort(torch.argsort(scores, dim=-1, stable=True),
                          dim=-1, stable=True)
    return order >= (n - keep)


def to_blocks(w: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(out, in) zero-padded to whole blocks -> (Br, Bc, bm, bn)."""
    out_dim, in_dim = w.shape
    br, bc = -(-out_dim // bm), -(-in_dim // bn)
    wp = F.pad(w, (0, bc * bn - in_dim, 0, br * bm - out_dim))
    return wp.reshape(br, bm, bc, bn).permute(0, 2, 1, 3)


def csb_masks(w: torch.Tensor, bm: int, bn: int, prune_rate: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row masks (Br, Bc, bm) and column masks (Br, Bc, bn) of the CSB
    projection: rows pruned by l2 norm over each block-column, then
    columns over each block-row of the row-masked blocks, each pass at
    rate ``1 - sqrt(1 - prune_rate)``."""
    blocks = to_blocks(w, bm, bn).to(torch.float32)
    br, bc = blocks.shape[:2]
    q = 1.0 - math.sqrt(max(1.0 - prune_rate, 0.0))
    rn = torch.sum(blocks * blocks, dim=3)
    keep_r = max(int(round((1.0 - q) * br * bm)), 1)
    row_mask = _topk_mask(rn.permute(1, 0, 2).reshape(bc, br * bm), keep_r)
    row_mask = row_mask.reshape(bc, br, bm).permute(1, 0, 2)
    masked = blocks * row_mask[..., :, None]
    cn = torch.sum(masked * masked, dim=2)
    keep_c = max(int(round((1.0 - q) * bc * bn)), 1)
    col_mask = _topk_mask(cn.reshape(br, bc * bn), keep_c).reshape(br, bc, bn)
    return row_mask, col_mask


def csb_masks_at(w: torch.Tensor, bm: int, bn: int, compression: float,
                 steps: int = 24) -> tuple[torch.Tensor, torch.Tensor]:
    """The masks of ``csb_masks`` at the prune rate, found by bisection,
    where the live elements first fall to ``w.numel() / compression`` or
    fewer. (The two passes keep rows and columns that go together, so
    ``csb_masks`` at the rate ``1 - 1/compression`` keeps more than that.)
    """
    target = w.numel() / compression
    lo, hi = 0.0, 1.0
    best = csb_masks(w, bm, bn, hi)
    for _ in range(steps):
        mid = (lo + hi) / 2
        rm, cm = csb_masks(w, bm, bn, mid)
        if int(element_mask(w.shape, rm, cm).sum()) > target:
            lo = mid
        else:
            hi, best = mid, (rm, cm)
    return best


def element_mask(shape, row_mask: torch.Tensor, col_mask: torch.Tensor
                 ) -> torch.Tensor:
    """The (out, in) mask of the elements that survive both passes."""
    full = row_mask[..., :, None] & col_mask[..., None, :]
    br, bc, bm, bn = full.shape
    return full.permute(0, 2, 1, 3).reshape(br * bm, bc * bn)[
        : shape[0], : shape[1]]


def make_weights(shapes: list[dict], cfg: dict, seed: int, device
                 ) -> list[dict]:
    """Per layer ``{name: entry}`` for the ``{name: shape}`` dicts in
    ``shapes``: a matrix's entry is ``{"dense", "row_mask", "col_mask"}``
    (the pruned matrix and its masks), a bias's ``{"dense"}``. A few
    large draws on generators on ``device`` make every number: the
    bases, row factors and column factors from ``pattern_seed``; the
    row signs, column signs and biases from ``seed``."""
    w_cfg = cfg["weights"]
    mats = [(li, k, s) for li, sh in enumerate(shapes)
            for k, s in sh.items() if len(s) == 2]
    biases = [(li, k, s) for li, sh in enumerate(shapes)
              for k, s in sh.items() if len(s) == 1]
    n_out = sum(s[0] for _, _, s in mats)
    n_in = sum(s[1] for _, _, s in mats)
    gp = torch.Generator(device=device).manual_seed(
        _seed(w_cfg["pattern_seed"]))
    f32 = dict(generator=gp, device=device, dtype=torch.float32)
    base = torch.randn(sum(s[0] * s[1] for _, _, s in mats), **f32)
    rows = torch.randn(n_out, **f32)
    cols = torch.randn(n_in, **f32)
    g = torch.Generator(device=device).manual_seed(_seed(seed))
    signs = torch.randint(0, 2, (n_out + n_in,), generator=g, device=device)
    signs = signs.to(torch.float32) * 2.0 - 1.0
    bias = torch.randn(sum(s[0] for _, _, s in biases), generator=g,
                       device=device, dtype=torch.float32)
    bm, bn = cfg["block"]
    out: list[dict] = [{} for _ in shapes]
    ob = orow = ocol = 0
    for li, name, (o, i) in mats:
        w = synthetic_weight(base[ob: ob + o * i].view(o, i),
                             rows[orow: orow + o].view(o, 1),
                             cols[ocol: ocol + i].view(1, i),
                             w_cfg["imbalance"], w_cfg["diag_boost"])
        w = (w / math.sqrt(i) * signs[orow: orow + o].view(o, 1)
             * signs[n_out + ocol: n_out + ocol + i].view(1, i))
        ob, orow, ocol = ob + o * i, orow + o, ocol + i
        rm, cm = csb_masks_at(w, bm, bn, cfg["compression"])
        z = w * element_mask(w.shape, rm, cm)
        out[li][name] = {"dense": z, "row_mask": rm, "col_mask": cm}
    ob = 0
    for li, name, (o,) in biases:
        out[li][name] = {"dense": bias[ob: ob + o] * w_cfg["bias_scale"]}
        ob += o
    return out

"""The least time of a frame-step's matrix-vector products on one card,
counted from the benchmark's own masks, whatever implements them.

Per frame-step (one time step of the stream batch through every layer):

* FLOPs: 2 x the live weights of every product x the true rows;
* bytes, each counted once: every live value at 4 B; one 4-byte index
  per kept row and per kept column of each block; each distinct input
  vector of a product, once per true row; one output vector per true row
  for each group of products the cell adds at once (and for a product
  used alone).

The least time is max(FLOPs / PEAK_FLOPS, bytes / PEAK_BYTES).
"""
from __future__ import annotations

import dataclasses

import torch

# one NVIDIA H100 SXM (data sheet, dense, 700 W): fp32 outside the tensor
# cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
WORD = 4


def matrix_counts(row_mask: torch.Tensor, col_mask: torch.Tensor
                  ) -> tuple[int, int]:
    """(live values, indices) of a CSB matrix from its (Br, Bc, bm) row
    and (Br, Bc, bn) column masks. A block with kept rows but no kept
    column (or the reverse) stores nothing."""
    m = row_mask.sum(-1)
    n = col_mask.sum(-1)
    stored = (m > 0) & (n > 0)
    m, n = m * stored, n * stored
    return int((m * n).sum()), int(m.sum() + n.sum())


@dataclasses.dataclass(frozen=True)
class StepWork:
    """A frame-step's work: FLOPs and bytes per true row, and the bytes
    read once a step whatever the rows (values and indices)."""

    flops_per_row: int
    bytes_per_row: int
    bytes_per_step: int

    def flops(self, true_rows: int) -> int:
        return self.flops_per_row * true_rows

    def bytes(self, steps: int, true_rows: int) -> int:
        return self.bytes_per_step * steps + self.bytes_per_row * true_rows

    def least_s(self, steps: int, true_rows: int) -> float:
        return max(self.flops(true_rows) / PEAK_FLOPS,
                   self.bytes(steps, true_rows) / PEAK_BYTES)


def layer_work(cell, weights: dict) -> StepWork:
    """One layer's ``StepWork``; ``cell`` is its reference module (which
    says what each product multiplies and which it adds together),
    ``weights`` the layer's entries from ``inputs.make_weights``."""
    flops = fixed = 0
    widths = {}
    for name, src in cell.MVM_INPUT.items():
        e = weights[name]
        live, idx = matrix_counts(e["row_mask"], e["col_mask"])
        flops += 2 * live
        fixed += WORD * (live + idx)
        widths[src] = e["dense"].shape[1]
    outs = sum(weights[g[0]]["dense"].shape[0] for g in cell.OUTPUT_GROUPS)
    return StepWork(flops, WORD * (sum(widths.values()) + outs), fixed)


def model_work(cells: list, weights: list[dict]) -> StepWork:
    parts = [layer_work(c, w) for c, w in zip(cells, weights)]
    return StepWork(sum(p.flops_per_row for p in parts),
                    sum(p.bytes_per_row for p in parts),
                    sum(p.bytes_per_step for p in parts))

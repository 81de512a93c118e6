"""The CSB sparse storage format (paper Fig. 3) and its device-side
padded twin — the port of ``repro.core.csb_format``.

``CSBMatrix`` is the *faithful* format, a copy of the JAX package's
(numpy, ragged, host side): per-block kernel dims ``m{}``/``n{}``,
survivor indices ``RowIdx{}``/``ColIdx{}`` and the concatenated kernel
values ``Val{}`` in block row-major order.

``PaddedCSB`` holds the same matrix as four dense tensors on a device:
every kernel is padded to a common ``(Pm, Pn)`` and the CSB-MVM kernel
masks the pad lanes with ``m``/``n``. Field for field it equals the JAX
package's ``PaddedCSB``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass
class CSBMatrix:
    """Faithful CSB format (ragged, host side)."""

    shape: tuple[int, int]            # original (out, in)
    bm: int
    bn: int
    m: np.ndarray                     # (Br, Bc) int32 — kernel rows/block
    n: np.ndarray                     # (Br, Bc) int32 — kernel cols/block
    row_idx: np.ndarray               # (sum m,) int32, block row-major
    col_idx: np.ndarray               # (sum n,) int32
    val: np.ndarray                   # (sum m*n,) kernel values, row-major

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dense(
        cls, w: np.ndarray, bm: int, bn: int,
        row_mask: np.ndarray | None = None,
        col_mask: np.ndarray | None = None,
    ) -> "CSBMatrix":
        """Encode a CSB-patterned dense matrix.

        If masks (from ``core.pruning.csb_masks``) are not given, survivors
        are inferred from the nonzero pattern (a row/col of a block survives
        iff it has any nonzero).
        """
        w = np.asarray(w)
        out_dim, in_dim = w.shape
        br, bc = -(-out_dim // bm), -(-in_dim // bn)
        wp = np.zeros((br * bm, bc * bn), w.dtype)
        wp[:out_dim, :in_dim] = w
        blocks = wp.reshape(br, bm, bc, bn).transpose(0, 2, 1, 3)

        if row_mask is None:
            nz = blocks != 0
            row_mask = nz.any(axis=3)
            col_mask = nz.any(axis=2)
        row_mask = np.asarray(row_mask, bool)
        col_mask = np.asarray(col_mask, bool)
        # CSB cross-point property: a survivor row with no surviving col
        # stores nothing; normalize so m,n are consistent with storage.
        has_any = row_mask.any(-1) & col_mask.any(-1)        # (Br, Bc)
        row_mask = row_mask & has_any[..., None]
        col_mask = col_mask & has_any[..., None]

        m = row_mask.sum(-1).astype(np.int32)
        n = col_mask.sum(-1).astype(np.int32)
        rows, cols, vals = [], [], []
        for i in range(br):
            for j in range(bc):
                r = np.nonzero(row_mask[i, j])[0].astype(np.int32)
                c = np.nonzero(col_mask[i, j])[0].astype(np.int32)
                rows.append(r)
                cols.append(c)
                vals.append(blocks[i, j][np.ix_(r, c)].reshape(-1))
        return cls(
            shape=(out_dim, in_dim), bm=bm, bn=bn, m=m, n=n,
            row_idx=np.concatenate(rows) if rows else np.zeros(0, np.int32),
            col_idx=np.concatenate(cols) if cols else np.zeros(0, np.int32),
            val=np.concatenate(vals) if vals else np.zeros(0, w.dtype),
        )

    # -- decode ------------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        br, bc = self.m.shape
        out = np.zeros((br * self.bm, bc * self.bn), self.val.dtype)
        ro = co = vo = 0
        for i in range(br):
            for j in range(bc):
                mi, ni = int(self.m[i, j]), int(self.n[i, j])
                r = self.row_idx[ro: ro + mi]
                c = self.col_idx[co: co + ni]
                k = self.val[vo: vo + mi * ni].reshape(mi, ni)
                out[np.ix_(i * self.bm + r, j * self.bn + c)] = k
                ro, co, vo = ro + mi, co + ni, vo + mi * ni
        return out[: self.shape[0], : self.shape[1]]

    # -- storage accounting (Fig. 10b) --------------------------------------
    @property
    def nnz(self) -> int:
        return int((self.m.astype(np.int64) * self.n).sum())

    @property
    def index_count(self) -> int:
        """Row + col survivor indices (+2 counts per block)."""
        return int(self.m.sum() + self.n.sum() + 2 * self.m.size)

    def nio(self) -> float:
        """Normalized Index Overhead = index entries / weight entries."""
        return self.index_count / max(self.nnz, 1)

    @staticmethod
    def csr_nio(nnz: int, rows: int) -> float:
        """CSR overhead of a non-structured matrix: 1 col idx per nnz +
        row pointers — the paper's >100% comparison point."""
        return (nnz + rows + 1) / max(nnz, 1)

    def compression_ratio(self) -> float:
        return (self.shape[0] * self.shape[1]) / max(self.nnz, 1)

    # -- workload view for the engine/compiler ------------------------------
    def block_workloads(self) -> np.ndarray:
        """(Br, Bc) multiply-accumulate counts — the scheduler's input."""
        return (self.m.astype(np.int64) * self.n.astype(np.int64))


@dataclasses.dataclass
class PaddedCSB:
    """Device-side CSB: kernels padded to a common (Pm, Pn) bucket.

    vals:     (NB, Pm, Pn)  kernel values (pad lanes zero), fp32 or bf16
    row_idx:  (NB, Pm) int32  within-block survivor row (pad -> 0)
    col_idx:  (NB, Pn) int32
    m, n:     (NB,) int32   true kernel dims
    Blocks are row-major over the (Br, Bc) grid.
    """

    vals: torch.Tensor
    row_idx: torch.Tensor
    col_idx: torch.Tensor
    m: torch.Tensor
    n: torch.Tensor
    shape: tuple[int, int] = (0, 0)
    grid: tuple[int, int] = (0, 0)
    block: tuple[int, int] = (0, 0)

    @property
    def pm(self) -> int:
        return self.vals.shape[1]

    @property
    def pn(self) -> int:
        return self.vals.shape[2]

    def to(self, device) -> "PaddedCSB":
        """The same matrix with every tensor on ``device``."""
        return dataclasses.replace(
            self, vals=self.vals.to(device), row_idx=self.row_idx.to(device),
            col_idx=self.col_idx.to(device), m=self.m.to(device),
            n=self.n.to(device))

    @classmethod
    def from_csb(cls, csb: CSBMatrix, pad_to: int = 8,
                 dtype: torch.dtype = torch.float32,
                 device=None) -> "PaddedCSB":
        dev = resolve_device(device)
        br, bc = csb.m.shape
        nb = br * bc
        pm = max(_round_up(int(csb.m.max(initial=0)), pad_to), pad_to)
        pn = max(_round_up(int(csb.n.max(initial=0)), pad_to), pad_to)
        vals = np.zeros((nb, pm, pn), np.float32)
        ridx = np.zeros((nb, pm), np.int32)
        cidx = np.zeros((nb, pn), np.int32)
        ro = co = vo = 0
        b = 0
        for i in range(br):
            for j in range(bc):
                mi, ni = int(csb.m[i, j]), int(csb.n[i, j])
                ridx[b, :mi] = csb.row_idx[ro: ro + mi]
                cidx[b, :ni] = csb.col_idx[co: co + ni]
                vals[b, :mi, :ni] = csb.val[vo: vo + mi * ni].reshape(mi, ni)
                ro, co, vo = ro + mi, co + ni, vo + mi * ni
                b += 1
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return cls(
            vals=as_t(vals).to(dtype),
            row_idx=as_t(ridx),
            col_idx=as_t(cidx),
            m=as_t(csb.m.reshape(-1).astype(np.int32)),
            n=as_t(csb.n.reshape(-1).astype(np.int32)),
            shape=tuple(csb.shape), grid=(br, bc), block=(csb.bm, csb.bn),
        )

    def padded_flops_per_mvm(self) -> int:
        """2 * NB * Pm * Pn — what a kernel reading every pad lane does."""
        return 2 * int(self.vals.shape[0]) * self.pm * self.pn

    def true_flops_per_mvm(self) -> int:
        return int(2 * torch.sum(self.m.to(torch.int64) * self.n))


def _host(a) -> np.ndarray | None:
    """A tensor (any device, fp32/bf16/bool/int) or array-like as numpy."""
    if a is None or isinstance(a, np.ndarray):
        return a
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def padded_csb_from_dense(
    w, bm: int, bn: int, pad_to: int = 8,
    dtype: torch.dtype = torch.float32,
    row_mask=None, col_mask=None, device=None,
) -> PaddedCSB:
    """Encode a CSB-patterned dense matrix (tensor or ndarray) straight
    into the padded device format; masks as ``core.pruning.csb_masks``
    returns them (inferred from the nonzeros when omitted)."""
    csb = CSBMatrix.from_dense(_host(w), bm, bn, _host(row_mask),
                               _host(col_mask))
    return PaddedCSB.from_csb(csb, pad_to=pad_to, dtype=dtype, device=device)

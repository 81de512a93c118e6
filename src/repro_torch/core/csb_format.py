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

``ShardedCSB`` is a ``PaddedCSB`` split over the ranks of a mesh axis by
block-row (``PaddedCSB.split_block_rows``; the planner in
``repro_torch.dist.csb_partition`` picks the split): every tensor gains a
leading device axis. A rank keeps only its own shard (``local``), since
the port runs one process per rank.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

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

    # -- device sharding (mesh-level balancing, paper §5.2 lifted) ----------
    def split_block_rows(
        self, assignment: Sequence[Sequence[int]]
    ) -> "ShardedCSB":
        """Split the block grid over devices by BLOCK-ROW.

        ``assignment[d]`` lists the global block-row ids device ``d`` owns
        (a partition of ``range(Br)``). Devices with fewer rows are padded
        with empty rows (``m = n = 0`` blocks, which the kernel writes as
        zeros), so every shard has the same shape. The pad rows' other
        arrays repeat block-row 0's, as in the JAX package."""
        br, bc = self.grid
        n_dev = len(assignment)
        flat = sorted(r for rows in assignment for r in rows)
        if flat != list(range(br)):
            raise ValueError(
                f"assignment must partition range({br}), got {assignment}")
        rpd = max(max((len(rows) for rows in assignment), default=0), 1)
        gather = np.zeros((n_dev, rpd), np.int64)
        valid = np.zeros((n_dev, rpd), bool)
        for d, rows in enumerate(assignment):
            gather[d, : len(rows)] = rows
            valid[d, : len(rows)] = True

        dev = self.vals.device
        pm, pn = self.pm, self.pn
        g = torch.from_numpy(gather).to(dev)
        live = torch.from_numpy(valid).to(dev)[:, :, None]      # (D, R, 1)
        return ShardedCSB(
            vals=self.vals.reshape(br, bc, pm, pn)[g].reshape(
                n_dev, rpd * bc, pm, pn),
            row_idx=self.row_idx.reshape(br, bc, pm)[g].reshape(
                n_dev, rpd * bc, pm),
            col_idx=self.col_idx.reshape(br, bc, pn)[g].reshape(
                n_dev, rpd * bc, pn),
            m=torch.where(live, self.m.reshape(br, bc)[g], 0).reshape(
                n_dev, rpd * bc),
            n=torch.where(live, self.n.reshape(br, bc)[g], 0).reshape(
                n_dev, rpd * bc),
            shape=self.shape, grid=self.grid, block=self.block,
            row_map=tuple(tuple(int(r) for r in rows) for rows in assignment),
        )


_SHARD_ARRAYS = ("vals", "row_idx", "col_idx", "m", "n")


@dataclasses.dataclass
class ShardedCSB:
    """A ``PaddedCSB`` split over devices by block-row: every tensor has a
    leading device axis, and ``row_map`` records which global block-rows
    each device owns (in local-slot order), so that outputs can be put
    back in order after the all-gather. ``rank`` is None while the tensors
    hold every device's shard, and ``r`` once they hold only rank ``r``'s
    (a leading axis of 1; see ``local``). Consumed by
    ``repro_torch.kernels.csb_sharded.csb_matvec_sharded``."""

    vals: torch.Tensor              # (D, R*Bc, Pm, Pn)
    row_idx: torch.Tensor           # (D, R*Bc, Pm)
    col_idx: torch.Tensor           # (D, R*Bc, Pn)
    m: torch.Tensor                 # (D, R*Bc) — 0 on pad rows
    n: torch.Tensor                 # (D, R*Bc)
    shape: tuple[int, int] = (0, 0)
    grid: tuple[int, int] = (0, 0)
    block: tuple[int, int] = (0, 0)
    # per-device global block-row ids, local-slot order
    row_map: tuple[tuple[int, ...], ...] = ()
    rank: int | None = None

    @property
    def n_dev(self) -> int:
        return len(self.row_map)

    @property
    def rows_per_dev(self) -> int:
        return self.vals.shape[1] // self.grid[1]

    @property
    def pm(self) -> int:
        return self.vals.shape[-2]

    @property
    def pn(self) -> int:
        return self.vals.shape[-1]

    def to(self, device) -> "ShardedCSB":
        """The same shards with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in _SHARD_ARRAYS})

    def local(self, rank: int) -> "ShardedCSB":
        """Rank ``rank``'s shard alone: views of its slice of every tensor
        (contiguous, with a leading axis of 1)."""
        if self.rank is not None:
            if rank != self.rank:
                raise ValueError(f"this ShardedCSB holds rank {self.rank}'s "
                                 f"shard, not rank {rank}'s")
            return self
        if not 0 <= rank < self.n_dev:
            raise ValueError(f"rank {rank} outside 0..{self.n_dev - 1}")
        return dataclasses.replace(self, rank=rank, **{
            k: getattr(self, k)[rank: rank + 1] for k in _SHARD_ARRAYS})

    def shard_arrays(self, rank: int) -> tuple[torch.Tensor, ...]:
        """(vals, row_idx, col_idx, m, n) of rank ``rank``'s shard, without
        the device axis: the arrays of one ``(R, Bc)`` block grid."""
        s = self.local(rank)
        return tuple(getattr(s, k)[0] for k in _SHARD_ARRAYS)

    def output_permutation(self) -> np.ndarray:
        """``perm`` s.t. ``y_global[:, i] = y_gathered[:, perm[i]]`` where
        ``y_gathered`` concatenates per-device outputs (pad rows included)
        in device order."""
        return csb_output_permutation(
            self.row_map, self.rows_per_dev, self.block[0], self.grid[0])


def csb_output_permutation(row_map, rows_per_dev: int, bm: int,
                           br: int) -> np.ndarray:
    """Gather-order -> block-row-order output permutation (see
    :meth:`ShardedCSB.output_permutation`; standalone so that the kernel's
    cache can rebuild it from hashable statics alone)."""
    perm = np.zeros(br * bm, np.int64)
    for d, rows in enumerate(row_map):
        for s, r in enumerate(rows):
            src = (d * rows_per_dev + s) * bm
            perm[r * bm: (r + 1) * bm] = np.arange(src, src + bm)
    return perm


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

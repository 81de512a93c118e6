"""The CSB-MVM kernel on Hopper: the wrapper around ``csrc/csb_mvm.cu``.

It replaces the JAX package's Pallas kernel
(``repro.kernels.csb_mvm._kernel``). The kernel computes
``Y = X @ W^T`` in fp32 for a ``PaddedCSB`` ``W`` and a batch ``X``
already padded to the block grid; its plain version with the same
arguments is ``ref.csb_mvm_ref``. ``csb_mvm_cuda`` launches the kernel on
PyTorch's current stream or raises: it never falls back to the plain
version. ``LAUNCHES`` counts its launches (one per call), so that a run
can show that its main path went through the kernel.

The kernel has two bodies, which give equal numbers (the source says
why). The row body (``launch_config``) is bound by the latency of each
block's chain of dependent loads, and puts every block of a block-row in
flight for a tile of 8 rows. At hundreds of rows it is bound by reloads
instead: each (block, batch row) item loads its block again, and most of
a block's lanes idle, since a pruned block's live rows are far fewer than
its padded ``Pm``. The batch-tiled body (``tiled_config``) stages each
block's live corner once for a tile of 32 rows, a lane a row, a warp a
block-row, and the tile's inputs once for a group of block-rows. A call
takes the tiled body when its true rows reach ``TILED_MIN_ROWS``, the
crossover of the two measured on the card (PERF.md), and the row body
below it, where a 32-row tile would leave most lanes idle.
``TILED_LAUNCHES`` counts the launches that took the tiled body. Both
configurations are computed on the host; the design is described in the
source.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

LAUNCHES = 0
TILED_LAUNCHES = 0
# the fewest true rows that take the batch-tiled body: the crossover of the
# two bodies' times on an H100 (PERF.md, the sweep across the batch)
TILED_MIN_ROWS = 96

_FLOATS = (torch.float32, torch.bfloat16)
_SMEM_MAX = 232448
_TILE_ROWS = 32         # batch rows of a tiled CTA: one a lane
_MAX_WARPS = 8          # block-rows of a tiled CTA: one a warp
_FEW_CTAS = 128         # about one CTA per SM of an H100 (132)
_fn = None


def launch_config(bc: int, bm: int, pm: int, pn: int, batch_tile: int,
                  rows: int) -> tuple[int, int, int, int]:
    """(threads, lanes per block, block-columns per pass, shared bytes) of
    one CTA, for a block-row of ``bc`` blocks of ``bm`` output rows and
    (at most) ``pm`` x ``pn`` live values, and a batch tile of
    ``batch_tile`` rows of which ``rows`` (at most) are true.

    A group of lanes (the power of two >= Pm, at most 32) takes one
    (block-column, batch row) item; the CTA has a warp for every item of a
    pass, up to 32 warps, and never fewer threads than the tile's outputs.
    Shared memory holds one fp32 sum per (true row, block-column of the
    pass, output row) and each lane group's ``pn`` gathered inputs."""
    tr = min(batch_tile, rows)
    gs = min(32, 1 << max(pm - 1, 0).bit_length())
    xs = 4 * 1024 // gs * pn          # the gathered x at 1024 threads
    chunk = max(1, min(bc, (_SMEM_MAX - xs) // (4 * tr * bm)))
    warps = -(-chunk * tr // (32 // gs))
    threads = 32 * min(32, max(warps, -(-batch_tile * bm // 32)))
    return threads, gs, chunk, 4 * (tr * chunk * bm + threads // gs * pn)


def tiled_smem(bm: int, bn: int, pm: int, pn: int, warps: int,
               chunk: int) -> int:
    """Shared bytes of a batch-tiled CTA (``smem_bytes`` in the source):
    the tile's inputs for ``chunk`` block-columns, the pass's m and n of
    every warp's blocks, and per warp its accumulators and a stage of a
    block's values and indices, every part a whole number of 16 bytes."""
    def r4(v):
        return (v + 3) & ~3
    cols = r4(min(pn, 32))
    per_warp = r4(bm * (_TILE_ROWS + 1)) + r4(pm) * cols + r4(pm) + cols
    return 4 * (_TILE_ROWS * chunk * bn + r4(2 * warps * chunk)
                + warps * per_warp)


@functools.cache
def _tiled_shape(br: int, bc: int, bm: int, bn: int, pm: int, pn: int,
                 tiles: int) -> tuple[int, int, int, tuple[int, int]] | None:
    warps = min(_MAX_WARPS, br)
    while warps > 2 and -(-br // warps) * tiles < _FEW_CTAS:
        warps //= 2
    while warps > 1 and tiled_smem(bm, bn, pm, pn, warps, 1) > _SMEM_MAX:
        warps -= 1
    if tiled_smem(bm, bn, pm, pn, warps, 1) > _SMEM_MAX:
        return None
    most = max(c for c in range(1, bc + 1)
               if tiled_smem(bm, bn, pm, pn, warps, c) <= _SMEM_MAX)
    chunk = -(-bc // -(-bc // most))    # the fewest passes, made even
    return (32 * warps, chunk, tiled_smem(bm, bn, pm, pn, warps, chunk),
            (-(-br // warps), tiles))


def tiled_config(br: int, bc: int, bm: int, bn: int, pm: int, pn: int,
                 batch: int, rows: int
                 ) -> tuple[int, int, int, tuple[int, int]] | None:
    """(threads, block-columns per pass, shared bytes, grid) of the
    batch-tiled body for a (``br``, ``bc``) grid of ``bm`` x ``bn`` blocks
    of at most ``pm`` x ``pn`` live values and a batch of ``batch`` rows of
    which ``rows`` are true; None where the call takes the row body: below
    ``TILED_MIN_ROWS`` true rows, or where one warp's stage and one
    block-column of inputs do not fit in shared memory.

    A CTA takes a tile of 32 rows and a warp for each of up to 8
    block-rows, down to 2 while the grid would have under ``_FEW_CTAS``
    CTAs (a warp for each block-row of a grid that fills the card reads
    the inputs less often; CTAs that fill it finish sooner; a CTA of one
    warp stages the inputs alone), and fewer while a warp's stage does not
    fit. The tile's inputs are staged in as few passes over the
    block-columns as shared memory then allows, of equal width but the
    last."""
    if rows < TILED_MIN_ROWS:
        return None
    return _tiled_shape(br, bc, bm, bn, pm, pn, -(-batch // _TILE_ROWS))


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library("csb_mvm")
        fn = lib.csb_mvm_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        tiled = lib.csb_mvm_tiled_launch
        tiled.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                          + [ctypes.c_void_p])
        tiled.restype = ctypes.c_int
        lib.csb_mvm_error_string.argtypes = [ctypes.c_int]
        lib.csb_mvm_error_string.restype = ctypes.c_char_p
        _fn = (fn, tiled, lib.csb_mvm_error_string)
    return _fn


def csb_mvm_cuda(vals, row_idx, col_idx, m, n, x, *, grid, block,
                 batch_tile: int, group: int,
                 rows: int | None = None) -> torch.Tensor:
    """(B, Bc*bn) x on the card -> (B, Br*bm) fp32, through the kernel.

    ``vals`` (NB, Pm, Pn) and ``x`` are fp32 or bf16; ``row_idx``
    (NB, Pm), ``col_idx`` (NB, Pn), ``m`` and ``n`` (NB,) int32.
    ``B % batch_tile == 0``; below ``TILED_MIN_ROWS`` true rows one CTA
    covers ``batch_tile`` rows of one block-row (the row body), at and
    above it 32 rows of a group of block-rows (the batch-tiled body).
    ``group`` must divide ``Bc``, as in the JAX kernel, where it is the
    number of blocks per grid step; this kernel loads every block of a
    block-row at once and does not use it. ``rows`` (default ``B``) says
    that only the first ``rows`` rows of ``x`` are data and the rest pad
    (zeros): their outputs are written as zeros without being computed.
    """
    global LAUNCHES, TILED_LAUNCHES
    br, bc = grid
    bm, bn = block
    args = dict(vals=vals, row_idx=row_idx, col_idx=col_idx, m=m, n=n, x=x)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"csb_mvm_cuda takes CUDA tensors; x lies on {dev}")
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = _FLOATS if name in ("vals", "x") else (torch.int32,)
        if t.dtype not in want:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {want}")
    if vals.ndim != 3:
        raise ValueError(f"vals must be (NB, Pm, Pn), got {tuple(vals.shape)}")
    nb, pm, pn = vals.shape
    if (nb != br * bc or row_idx.shape != (nb, pm)
            or col_idx.shape != (nb, pn) or m.shape != (nb,)
            or n.shape != (nb,)):
        raise ValueError(
            f"CSB arrays do not match grid {grid}: vals {tuple(vals.shape)}, "
            f"row_idx {tuple(row_idx.shape)}, col_idx {tuple(col_idx.shape)}, "
            f"m {tuple(m.shape)}, n {tuple(n.shape)}")
    if x.ndim != 2 or x.shape[1] != bc * bn:
        raise ValueError(f"x must be (B, {bc * bn}), got {tuple(x.shape)}")
    b = x.shape[0]
    if b == 0 or b % batch_tile or b // batch_tile > 65535:
        raise ValueError(
            f"batch {b} must be a positive multiple of batch_tile "
            f"{batch_tile}, at most {65535 * batch_tile}")
    if group < 1 or bc % group:
        raise ValueError(f"group {group} must divide Bc={bc}")
    if batch_tile * bm > 1024:
        raise ValueError(
            f"batch_tile * bm = {batch_tile * bm} threads exceeds 1024")
    rows = b if rows is None else rows
    if not 1 <= rows <= b:
        raise ValueError(f"rows {rows} must lie in 1..{b}")
    fn, tiled, err_str = _launcher()
    out = torch.empty((b, br * bm), dtype=torch.float32, device=dev)
    ptrs = (vals.data_ptr(), row_idx.data_ptr(), col_idx.data_ptr(),
            m.data_ptr(), n.data_ptr(), x.data_ptr(), out.data_ptr())
    tail = (int(vals.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    cfg = tiled_config(br, bc, bm, bn, pm, pn, b, rows)
    if cfg is None:
        threads, gs, chunk, _ = launch_config(bc, bm, pm, pn, batch_tile,
                                              rows)
        err = fn(*ptrs, b, rows, br, bc, bm, bn, pm, pn, batch_tile, threads,
                 gs, chunk, *tail)
    else:
        threads, chunk, _, _ = cfg
        err = tiled(*ptrs, b, rows, br, bc, bm, bn, pm, pn, threads // 32,
                    chunk, *tail)
    if err:
        raise RuntimeError(
            f"csb_mvm kernel launch failed: {err_str(err).decode()} "
            f"(cudaError {err})")
    LAUNCHES += 1
    TILED_LAUNCHES += cfg is not None
    return out

"""The CSB-MVM kernel on Hopper: the wrapper around ``csrc/csb_mvm.cu``.

It replaces the JAX package's Pallas kernel
(``repro.kernels.csb_mvm._kernel``). The kernel computes
``Y = X @ W^T`` in fp32 for a ``PaddedCSB`` ``W`` and a batch ``X``
already padded to the block grid; its plain version with the same
arguments is ``ref.csb_mvm_ref``. ``csb_mvm_cuda`` launches the kernel on
PyTorch's current stream or raises: it never falls back to the plain
version. ``LAUNCHES`` counts its launches (one per call), so that a run
can show that its main path went through the kernel. ``launch_config``
is the kernel's launch configuration, computed on the host; the design
is described in the source.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

LAUNCHES = 0

_FLOATS = (torch.float32, torch.bfloat16)
_SMEM_MAX = 232448
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


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library("csb_mvm")
        fn = lib.csb_mvm_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.csb_mvm_error_string.argtypes = [ctypes.c_int]
        lib.csb_mvm_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.csb_mvm_error_string)
    return _fn


def csb_mvm_cuda(vals, row_idx, col_idx, m, n, x, *, grid, block,
                 batch_tile: int, group: int,
                 rows: int | None = None) -> torch.Tensor:
    """(B, Bc*bn) x on the card -> (B, Br*bm) fp32, through the kernel.

    ``vals`` (NB, Pm, Pn) and ``x`` are fp32 or bf16; ``row_idx``
    (NB, Pm), ``col_idx`` (NB, Pn), ``m`` and ``n`` (NB,) int32. One CTA
    covers ``batch_tile`` rows of one block-row; ``B % batch_tile == 0``.
    ``group`` must divide ``Bc``, as in the JAX kernel, where it is the
    number of blocks per grid step; this kernel loads every block of a
    block-row at once and does not use it. ``rows`` (default ``B``) says
    that only the first ``rows`` rows of ``x`` are data and the rest pad
    (zeros): their outputs are written as zeros without being computed.
    """
    global LAUNCHES
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
    threads, gs, chunk, _ = launch_config(bc, bm, pm, pn, batch_tile, rows)
    fn, err_str = _launcher()
    out = torch.empty((b, br * bm), dtype=torch.float32, device=dev)
    err = fn(vals.data_ptr(), row_idx.data_ptr(), col_idx.data_ptr(),
             m.data_ptr(), n.data_ptr(), x.data_ptr(), out.data_ptr(),
             b, rows, br, bc, bm, bn, pm, pn, batch_tile, threads, gs, chunk,
             int(vals.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"csb_mvm kernel launch failed: {err_str(err).decode()} "
            f"(cudaError {err})")
    LAUNCHES += 1
    return out

"""The CSB-MVM kernel on Hopper: the wrapper around ``csrc/csb_mvm.cu``.

It replaces the JAX package's Pallas kernel
(``repro.kernels.csb_mvm._kernel``). The kernel computes
``Y = X @ W^T`` in fp32 for a ``PaddedCSB`` ``W`` and a batch ``X``
already padded to the block grid; its plain version with the same
arguments is ``ref.csb_mvm_ref``. ``csb_mvm_cuda`` launches the kernel on
PyTorch's current stream or raises: it never falls back to the plain
version. ``LAUNCHES`` counts its launches, so that a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

LAUNCHES = 0

_FLOATS = (torch.float32, torch.bfloat16)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library("csb_mvm")
        fn = lib.csb_mvm_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.csb_mvm_error_string.argtypes = [ctypes.c_int]
        lib.csb_mvm_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.csb_mvm_error_string)
    return _fn


def csb_mvm_cuda(vals, row_idx, col_idx, m, n, x, *, grid, block,
                 batch_tile: int, group: int) -> torch.Tensor:
    """(B, Bc*bn) x on the card -> (B, Br*bm) fp32, through the kernel.

    ``vals`` (NB, Pm, Pn) and ``x`` are fp32 or bf16; ``row_idx``
    (NB, Pm), ``col_idx`` (NB, Pn), ``m`` and ``n`` (NB,) int32. One CTA
    covers ``batch_tile`` rows of one block-row and stages ``group``
    blocks per pass; ``B % batch_tile == 0`` and ``Bc % group == 0``.
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
    fn, err_str = _launcher()
    out = torch.empty((b, br * bm), dtype=torch.float32, device=dev)
    err = fn(vals.data_ptr(), row_idx.data_ptr(), col_idx.data_ptr(),
             m.data_ptr(), n.data_ptr(), x.data_ptr(), out.data_ptr(),
             b, br, bc, bm, bn, pm, pn, batch_tile, group,
             int(vals.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"csb_mvm kernel launch failed: {err_str(err).decode()} "
            f"(cudaError {err})")
    LAUNCHES += 1
    return out

"""The paged-attention decode kernel on Hopper: the wrapper around
``csrc/paged_attn.cu``.

It replaces the JAX package's Pallas kernel
(``repro.kernels.paged_attn._kernel``): single-query attention for every
decode slot over its keys and values in a shared page pool, reached
through the slot's row of the page table, with GQA, an optional sliding
window and an optional rope score term (multi-head latent attention).
Its plain version with the same arguments and contract is
``ref.paged_attn_ref``. ``paged_attn_cuda`` launches the kernel on
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
# kept in step with smem_bytes() and the constants in csrc/paged_attn.cu
_WARPS = 8
_SMEM_MAX = 232448
_fn = None


def smem_bytes(hpc: int, d: int, d2: int, tile: int, mp: int) -> int:
    """Shared memory of one CTA: q and q2 of ``hpc`` heads, a score tile
    of ``tile`` keys per head, reduction buffers and the table row."""
    return 4 * (hpc * (d + d2 + tile) + _WARPS * hpc + 2 * hpc + mp)


def plan(rep: int, d: int, d2: int, t: int, mp: int,
         window: int | None) -> tuple[int, int]:
    """(heads per CTA, score tile) for a group of ``rep`` heads over at
    most ``t`` keys. The scores of every live key are kept in shared
    memory where they fit, the whole group in one CTA if possible,
    halving the heads per CTA while they do not; past that, a tile of
    keys that the kernel rescores in its second pass."""
    n_max = t if window is None else min(t, window)
    hpc = rep
    while True:
        if smem_bytes(hpc, d, d2, n_max, mp) <= _SMEM_MAX:
            return hpc, n_max
        if hpc % 2:
            break
        hpc //= 2
    tile = (_SMEM_MAX - smem_bytes(hpc, d, d2, 0, mp)) // (4 * hpc)
    if tile < 1:
        raise ValueError(
            f"paged attention with head dims {d}+{d2} and {hpc} heads per "
            f"CTA does not fit in shared memory")
    return hpc, min(tile, n_max)


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library("paged_attn")
        fn = lib.paged_attn_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attn_error_string.argtypes = [ctypes.c_int]
        lib.paged_attn_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.paged_attn_error_string)
    return _fn


def paged_attn_cuda(q, k_pool, v_pool, page_table, pos, *, scale: float,
                    q2=None, k2_pool=None,
                    window: int | None = None) -> torch.Tensor:
    """(B, H, Dv) fp32 decode attention through the kernel.

    q (B, H, D) and q2 (B, H, D2) are fp32 or bf16; k_pool (N, P, KV, D),
    v_pool (N, P, KV, Dv) and k2_pool (N, P, KV, D2) share one type, fp32
    or bf16; page_table (B, max_pages) and pos ((B,) or (1,), the
    position decoded this step) are int32. Every table entry must index
    a page of the pools: the kernel reads what the table names."""
    global LAUNCHES
    args = dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=page_table,
                pos=pos)
    if (q2 is None) != (k2_pool is None):
        raise ValueError("q2 and k2_pool come together")
    if q2 is not None:
        args.update(q2=q2, k2_pool=k2_pool)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attn_cuda takes CUDA tensors; q lies on "
                         f"{dev}")
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = ((torch.int32,) if name in ("page_table", "pos")
                else _FLOATS)
        if t.dtype not in want:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {want}")
    if q.ndim != 3 or k_pool.ndim != 4 or v_pool.ndim != 4:
        raise ValueError(
            f"q must be (B, H, D), the pools (N, P, KV, D|Dv); got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, h, d = q.shape
    n, psz, kv, _ = k_pool.shape
    dv = v_pool.shape[3]
    if k_pool.shape[3] != d or v_pool.shape[:3] != (n, psz, kv):
        raise ValueError(f"pools {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("k_pool and v_pool must share a dtype")
    if kv < 1 or h % kv:
        raise ValueError(f"H={h} must be a multiple of KV={kv}")
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be ({b}, max_pages), got "
                         f"{tuple(page_table.shape)}")
    mp = page_table.shape[1]
    if pos.ndim != 1 or pos.numel() not in (1, b):
        raise ValueError(f"pos must be (1,) or ({b},), got "
                         f"{tuple(pos.shape)}")
    d2 = 0
    if q2 is not None:
        d2 = q2.shape[-1]
        if (q2.shape != (b, h, d2) or k2_pool.shape != (n, psz, kv, d2)
                or q2.dtype != q.dtype or k2_pool.dtype != k_pool.dtype):
            raise ValueError(
                f"q2 {tuple(q2.shape)} {q2.dtype} / k2_pool "
                f"{tuple(k2_pool.shape)} {k2_pool.dtype} do not match q "
                f"and the pools")
    if b == 0 or b > 65535 or kv > 65535 or mp < 1:
        raise ValueError(f"batch {b}, KV {kv} and max_pages {mp} are out "
                         f"of the kernel's range")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    hpc, tile = plan(h // kv, d, d2, mp * psz, mp, window)
    fn, err_str = _launcher()
    out = torch.empty((b, h, dv), dtype=torch.float32, device=dev)
    err = fn(q.data_ptr(), 0 if q2 is None else q2.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(),
             0 if k2_pool is None else k2_pool.data_ptr(),
             page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
             b, h, kv, d, dv, d2, psz, mp, int(pos.numel() == b and b > 1),
             hpc, tile, 0 if window is None else window, float(scale),
             int(q.dtype == torch.bfloat16),
             int(k_pool.dtype == torch.bfloat16),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"paged_attn kernel launch failed: {err_str(err).decode()} "
            f"(cudaError {err})")
    LAUNCHES += 1
    return out

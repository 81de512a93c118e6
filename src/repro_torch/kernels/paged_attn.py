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
version. Each call launches two kernels, the scores kernel and the PV
kernel (``KERNELS_PER_CALL``), and adds both to ``LAUNCHES``, so that a
run can show that its main path went through them. Their design is
described in the source.

The PV kernels of a call find their last CTA through int32 counters that
the last CTA resets. They are kept per (device, stream), so calls on one
stream run in order; a call whose launch fails drops them. The workspace
is taken from PyTorch's caching allocator on every call, in stream order.
A CUDA graph of these calls bakes in the counters of the stream it was
captured on: replay it on that stream, not beside other calls there.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

LAUNCHES = 0
KERNELS_PER_CALL = 2

_FLOATS = (torch.float32, torch.bfloat16)
# kept in step with csrc/paged_attn.cu
_SMEM_MAX = 232448
_fn = None
_COUNT: dict = {}          # (device, stream) -> zeroed int32 counters


def smem_bytes(hpc: int, d: int, d2: int, keys: int, pages: int,
               splits: int) -> int:
    """Shared memory of one CTA, the larger of the two kernels': the
    scores kernel holds q and q2 of ``hpc`` heads (rows padded to a
    multiple of 64 floats for 16-byte loads), the split's scores and its
    pages; the PV kernel the offsets of the split's V rows (8 bytes each),
    its probabilities, a max and a sum per head, every split's max and
    sum per head, and a flag."""
    def r64(x):
        return -(-x // 64) * 64
    scores = 4 * (hpc * (r64(d) + r64(d2) + keys) + pages)
    pv = 8 * keys + 4 * (hpc * keys + 2 * hpc + 2 * splits * hpc + 1)
    return max(scores, pv)


@functools.lru_cache(maxsize=256)
def plan(b: int, rep: int, kv: int, d: int, d2: int, psz: int, mp: int,
         sms: int) -> tuple[int, int, int]:
    """(heads per CTA, pages per split, splits) for ``b`` slots of ``kv``
    groups of ``rep`` heads over a table of ``mp`` pages of ``psz`` keys,
    on a card of ``sms`` streaming multiprocessors.

    The heads of a group share a CTA, halved while a split of one page
    does not fit in shared memory. The split is the largest whole number
    of pages that still gives a grid of at least ``sms`` CTAs (every split
    a page if even that falls short), halved while shared memory does not
    hold it. Nothing here depends on the positions, so the grid is the
    same at every decode step."""
    hpc = rep
    while smem_bytes(hpc, d, d2, psz, 1, mp) > _SMEM_MAX:
        if hpc % 2:
            raise ValueError(
                f"paged attention with head dims {d}+{d2} and {hpc} heads "
                f"per CTA does not fit in shared memory")
        hpc //= 2
    groups = b * kv * (rep // hpc)
    need = -(-sms // groups)
    # largest ps with ceil(mp / ps) >= need
    ps = mp if need <= 1 else (mp + need - 2) // (need - 1) - 1
    ps = max(1, min(ps, mp))
    while smem_bytes(hpc, d, d2, ps * psz, ps, -(-mp // ps)) > _SMEM_MAX:
        ps //= 2
    return hpc, ps, -(-mp // ps)


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counters(key, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for ``key`` = (device,
    stream), allocated once and replaced when a call needs more; the last
    CTA of each (slot, group) leaves its counter at 0."""
    count = _COUNT.get(key)
    if count is None or count.numel() < n:
        count = _COUNT[key] = torch.zeros(n, dtype=torch.int32,
                                          device=key[0])
    return count


def workspace_floats(b: int, h: int, dv: int, psz: int, mp: int,
                     splits: int) -> tuple[int, int, int]:
    """fp32 words of the workspace's parts, each a multiple of 4 so that
    every part stays 16-byte aligned: the scores (b, h, mp * psz), the
    max and the sum of each split (splits, b, h) and the partial outputs
    (splits, b, h, dv)."""
    return (-(-b * h * mp * psz // 4) * 4, -(-splits * b * h // 4) * 4,
            splits * b * h * dv)


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library("paged_attn")
        fn = lib.paged_attn_launch
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 13
                       + [ctypes.c_float] + [ctypes.c_int] * 4
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
    rep = h // kv
    hpc, ps, splits = plan(b, rep, kv, d, d2, psz, mp, sm_count(dev.index))
    groups = kv * (rep // hpc)
    if splits > 2 ** 31 - 1 or groups > 65535:
        raise ValueError(f"{splits} splits x {groups} groups are out of "
                         f"the kernel's range")
    vec = (d % 8 == 0 and dv % 8 == 0 and d2 % 8 == 0
           and all(t.data_ptr() % 16 == 0 for t in (k_pool, v_pool, k2_pool)
                   if t is not None))
    n_sc, n_st, n_out = workspace_floats(b, h, dv, psz, mp, splits)
    work = torch.empty(n_sc + 2 * n_st + n_out, dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream)
    count = _counters(key, b * groups)
    base = work.data_ptr()
    fn, err_str = _launcher()
    out = torch.empty((b, h, dv), dtype=torch.float32, device=dev)
    err = fn(q.data_ptr(), 0 if q2 is None else q2.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(),
             0 if k2_pool is None else k2_pool.data_ptr(),
             page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
             base, base + 4 * n_sc, base + 4 * (n_sc + n_st),
             base + 4 * (n_sc + 2 * n_st), count.data_ptr(),
             b, h, kv, d, dv, d2, psz, mp, int(pos.numel() == b and b > 1),
             hpc, ps, splits, 0 if window is None else window, float(scale),
             int(vec), int(q.dtype == torch.bfloat16),
             int(k_pool.dtype == torch.bfloat16),
             dev.index, stream.cuda_stream)
    if err:
        _COUNT.pop(key, None)
        raise RuntimeError(
            f"paged_attn kernel launch failed: {err_str(err).decode()} "
            f"(cudaError {err})")
    LAUNCHES += KERNELS_PER_CALL
    return out

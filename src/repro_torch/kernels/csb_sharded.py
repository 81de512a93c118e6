"""Kernel B3: the CSB matvec with W's block-rows spread over a mesh axis.

It replaces the JAX package's ``repro.kernels.csb_sharded.
csb_matvec_sharded``, which runs B1's Pallas kernel on each device's
shard under ``shard_map``, all-gathers the output rows in chunks (so that
a TPU's ICI traffic hides behind the next chunk's compute) and puts them
back in block-row order with one ``take``.

On the card B3 is one launch per call on each rank
(``csrc/csb_sharded.cu``): B1's block-row body (``csrc/csb_block.cuh``)
over the rank's live block-rows, whose epilogue stores each output at its
global column (a table built once per shard, ``_column_table``) into
every rank's output. The store is the exchange and the row unpermute; no
all-gather, concat or gather kernel runs. With one rank the kernel
stores straight into the output; with more, into a slot of the symmetric
buffers every rank of the axis's group holds (``dist.symm``: CUDA IPC,
ordered by stream memory operations, no host wait), from which each rank
copies its output. ``overlap`` is checked and changes nothing there, as
``group`` is checked and unused by B1. ``LAUNCHES`` counts the kernel's
launches (one per call on a rank that holds live block-rows); B1's count
does not grow inside B3.

On CPU tensors B3 runs its plain version, ``csb_matvec_sharded_ref``,
which mirrors JAX step by step: B1's plain version on chunks of the
shard, ``overlap`` asynchronous ``torch.distributed`` all-gathers and one
``index_select`` that folds the chunk reorder (``_chunk_order``) into the
row unpermute. ``csb_sharded_rows`` is the kernel's own contract on one
rank: this rank's rows at their global columns, zeros elsewhere (the
kernel with one zeroed destination on the card, ``ref.
csb_sharded_rows_ref`` on the CPU); summed over the ranks it is y.

Numerics: B1's launch configuration depends on the block-column count,
the padded kernel sizes and the true batch rows, not on the block-row
count, and a shard keeps the whole matrix's ``Pm`` and ``Pn``. B3 runs
B1's body with that configuration, so every output is summed in the
order of the unsharded B1 launch: B3 is bit-equal to B1 on the whole
matrix.

Bound on the card: the rank's live values and indices, x, and its output
rows stored once to every rank.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.csb_format import ShardedCSB, csb_output_permutation
from repro_torch.dist.api import axis_sizes
from repro_torch.dist.symm import symmetric_buffer

from ._build import load_library
from .csb_mvm import launch_config
from .ops import pad_to_grid
from .ref import csb_mvm_ref, csb_sharded_rows_ref

LAUNCHES = 0
DEFAULT_OVERLAP = 2          # chunks per rank when the caller names none
_FLOATS = (torch.float32, torch.bfloat16)
_fn = None


def _chunk_bounds(rpd: int, overlap: int) -> list[tuple[int, int]]:
    """Split ``rpd`` block-rows into ``overlap`` contiguous chunks, sizes as
    even as possible (first chunks take the remainder)."""
    overlap = max(1, min(overlap, rpd))
    base, rem = divmod(rpd, overlap)
    bounds, start = [], 0
    for i in range(overlap):
        size = base + (1 if i < rem else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def _chunk_order(n_dev: int, rpd: int, bm: int,
                 bounds: list[tuple[int, int]]) -> np.ndarray:
    """Map device-order gather positions -> chunked-gather positions.

    The single-gather layout is ``[dev0 rows 0..rpd) | dev1 ...]``;
    chunked gathers concatenate ``[all devs' chunk0 | all devs' chunk1 |
    ...]``. ``order[sp] = cp``, so ``chunked[:, order[perm]]`` is the
    single-gather layout unpermuted by ``perm``."""
    order = np.empty(n_dev * rpd * bm, np.int64)
    base = 0
    for s_, e_ in bounds:
        size = e_ - s_
        for d in range(n_dev):
            for r in range(s_, e_):
                sp = (d * rpd + r) * bm
                cp = base + (d * size + (r - s_)) * bm
                order[sp:sp + bm] = np.arange(cp, cp + bm)
        base += n_dev * size * bm
    return order


@functools.lru_cache(maxsize=None)
def _final_perm(row_map: tuple, rpd: int, bm: int, br: int, overlap: int,
                device: torch.device) -> torch.Tensor:
    """The chunked gather's columns in block-row order, on ``device``,
    cached per static configuration (JAX caches its jitted function)."""
    perm = csb_output_permutation(row_map, rpd, bm, br)
    order = _chunk_order(len(row_map), rpd, bm, _chunk_bounds(rpd, overlap))
    return torch.from_numpy(order[perm]).to(device)


@functools.lru_cache(maxsize=None)
def _column_table(row_map: tuple, rank: int, rpd: int, bm: int,
                  out_dim: int, device: torch.device) -> torch.Tensor:
    """int32 (rpd * bm,): the global output column of each of ``rank``'s
    local output rows, ``row_map[rank][i] * bm + r``, or -1 for a pad row
    or a row past ``out_dim``; on ``device``, cached per shard layout."""
    cols = np.full(rpd * bm, -1, np.int32)
    for i, r in enumerate(row_map[rank]):
        c = r * bm + np.arange(bm)
        cols[i * bm:(i + 1) * bm] = np.where(c < out_dim, c, -1)
    return torch.from_numpy(cols).to(device)


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library("csb_sharded")
        fn = lib.csb_sharded_run
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_uint]
                       + [ctypes.c_int] * 16 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.csb_sharded_error_string.argtypes = [ctypes.c_int]
        lib.csb_sharded_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.csb_sharded_error_string)
    return _fn


def _run(s: ShardedCSB, rank: int, x2: torch.Tensor, out: torch.Tensor,
         batch_tile: int, buf=None) -> None:
    """Enqueue B3 on ``rank``'s shard for the (b, in) batch ``x2`` (b >= 1)
    on the current stream: into ``out`` ((b, out_dim) fp32) alone, or, given
    ``buf`` (a ``dist.symm.SymmetricBuffer``), into every rank's slot and
    from this rank's slot into ``out``. Raises on what the kernel does not
    take and on a failed launch."""
    global LAUNCHES
    dev = x2.device
    arrays = dict(zip(("vals", "row_idx", "col_idx", "m", "n"),
                      s.shard_arrays(rank)), x=x2)
    for name, t in arrays.items():
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = _FLOATS if name in ("vals", "x") else (torch.int32,)
        if t.dtype not in want:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {want}")
    (_, bc), (bm, bn) = s.grid, s.block
    b, width = x2.shape
    out_dim = s.shape[0]
    if width > bc * bn:
        raise ValueError(f"x has {width} columns, the block grid {bc * bn}")
    if batch_tile * bm > 1024 or -(-b // batch_tile) > 65535:
        raise ValueError(f"batch {b} at batch_tile {batch_tile} and bm {bm}"
                         f" exceeds the kernel's grid or CTA")
    if out.shape != (b, out_dim) or out.dtype != torch.float32:
        raise ValueError(f"out must be ({b}, {out_dim}) fp32")
    threads, gs, chunk, _ = launch_config(bc, bm, s.pm, s.pn, batch_tile, b)
    live = len(s.row_map[rank])
    cols = _column_table(s.row_map, rank, s.rows_per_dev, bm, out_dim, dev)
    if buf is None:
        exchange = (None, 1, 0, 1, 0, 0, 0)
    else:
        exchange = (buf.bases, buf.size, buf.rank, buf.n_slots,
                    buf.flag_bytes, buf.slot_bytes,
                    buf.next_ticket() & 0xFFFFFFFF)
    fn, err_str = _launcher()
    err = fn(*(t.data_ptr() for t in arrays.values()), cols.data_ptr(),
             out.data_ptr(), *exchange, b, live, width, out_dim, bc, bm, bn,
             s.pm, s.pn, batch_tile, threads, gs, chunk,
             int(arrays["vals"].dtype == torch.bfloat16),
             int(x2.dtype == torch.bfloat16), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"csb_sharded kernel failed: "
                           f"{err_str(err).decode()} (error {err})")
    if live:
        LAUNCHES += 1


def _store(s: ShardedCSB, x: torch.Tensor, pg, rank: int,
           batch_tile: int) -> torch.Tensor:
    """B3 on the card: one launch, its stores the exchange."""
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    b = x2.shape[0]
    out = torch.empty((b, s.shape[0]), dtype=torch.float32, device=x.device)
    if b:
        size = dist.get_world_size(pg)
        buf = (None if size == 1 else
               symmetric_buffer(pg, x.device, s.shape[0], b))
        _run(s, rank, x2, out, batch_tile, buf)
    return out.reshape(*batch_shape, s.shape[0])


def _matvec(s: ShardedCSB, x: torch.Tensor, mesh, axis_name: str,
            batch_tile: int, group: int | None, overlap: int | None,
            kernel: bool) -> torch.Tensor:
    axes = axis_sizes(mesh)
    if axis_name not in axes:
        raise ValueError(f"mesh has no axis {axis_name!r}: {tuple(axes)}")
    if axes[axis_name] != s.n_dev:
        raise ValueError(
            f"ShardedCSB was split for {s.n_dev} devices but mesh axis "
            f"{axis_name!r} has {axes[axis_name]}")
    group = 1 if group is None else group
    overlap = DEFAULT_OVERLAP if overlap is None else overlap
    if overlap < 1:
        raise ValueError(f"overlap must be >= 1, got {overlap}")
    (br, bc), (bm, bn) = s.grid, s.block
    if bc % group:
        raise ValueError(f"group {group} must divide Bc={bc}")
    pg = mesh.get_group(axis_name)
    rank = dist.get_rank(pg)
    if kernel:
        return _store(s, x, pg, rank, batch_tile)
    rpd = s.rows_per_dev
    overlap = min(overlap, rpd)
    vals, ridx, cidx, m, n = s.shard_arrays(rank)
    if vals.device != x.device:
        raise ValueError(f"the shard lies on {vals.device}, x on {x.device}")

    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    b = x2.shape[0]
    xp = pad_to_grid(x2, batch_tile, bc * bn).contiguous()
    parts, sent, works = [], [], []
    for s_, e_ in _chunk_bounds(rpd, overlap):
        lo, hi = s_ * bc, e_ * bc
        y = csb_mvm_ref(vals[lo:hi], ridx[lo:hi], cidx[lo:hi], m[lo:hi],
                        n[lo:hi], xp, grid=(e_ - s_, bc), block=s.block)
        out = [torch.empty_like(y) for _ in range(s.n_dev)]
        works.append(dist.all_gather(out, y, group=pg, async_op=True))
        sent.append(y)
        parts += out
    for w in works:
        w.wait()
    y = torch.cat(parts, dim=1).index_select(
        1, _final_perm(s.row_map, rpd, bm, br, overlap, x.device))
    return y[:b, : s.shape[0]].reshape(*batch_shape, s.shape[0])


def csb_matvec_sharded(s: ShardedCSB, x: torch.Tensor, *, mesh,
                       axis_name: str = "model", batch_tile: int = 8,
                       group: int | None = None,
                       overlap: int | None = None) -> torch.Tensor:
    """y = x @ W^T with W's block-rows spread over ``mesh[axis_name]``.

    Called on every rank of the axis (SPMD). ``s`` holds every rank's
    shard or only this rank's (``ShardedCSB.local``), on x's device;
    ``x``: (..., in_dim), this rank's batch rows, the same on every rank
    of the axis. Returns (..., out_dim) fp32, the same on every rank of
    the axis. ``mesh`` is a ``DeviceMesh`` with ``mesh_dim_names``.

    On CUDA tensors the call is one launch of the kernel on each rank,
    whose stores are the exchange, or it raises. ``overlap`` (chunks per
    rank, default 2) and ``group`` (which must divide the block-column
    count) are checked and do not change the kernel, as ``group`` does not
    change B1. On CPU tensors B3's plain version runs, with ``overlap``
    chunked gathers (clamped to the rows available; 1 = compute, then
    gather). The result is the same for every value of either; the batch
    is padded to a multiple of ``batch_tile``."""
    return _matvec(s, x, mesh, axis_name, batch_tile, group, overlap,
                   kernel=x.device.type != "cpu")


def csb_matvec_sharded_ref(s: ShardedCSB, x: torch.Tensor, *, mesh,
                           axis_name: str = "model", batch_tile: int = 8,
                           group: int | None = None,
                           overlap: int | None = None) -> torch.Tensor:
    """B3's plain version, on any device: ``csb_mvm_ref`` on chunks of the
    rank's shard, the chunked gathers and the unpermute (what
    ``csb_matvec_sharded`` runs on CPU tensors)."""
    return _matvec(s, x, mesh, axis_name, batch_tile, group, overlap,
                   kernel=False)


def csb_sharded_rows(s: ShardedCSB, x: torch.Tensor, rank: int, *,
                     batch_tile: int = 8) -> torch.Tensor:
    """The kernel's contract on ``rank``'s shard, with no exchange: (...,
    out_dim) fp32 holding ``rank``'s output rows of y = x @ W^T at their
    global columns and zeros elsewhere; summed over the ranks it is y. On
    CUDA tensors the kernel stores into one zeroed output; on CPU tensors
    ``ref.csb_sharded_rows_ref`` runs."""
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        cols = _column_table(s.row_map, rank, s.rows_per_dev, s.block[0],
                             s.shape[0], x.device)
        y = csb_sharded_rows_ref(*s.shard_arrays(rank), x2, cols,
                                 grid=(s.rows_per_dev, s.grid[1]),
                                 block=s.block, out_dim=s.shape[0])
    else:
        y = torch.zeros((x2.shape[0], s.shape[0]), dtype=torch.float32,
                        device=x.device)
        if x2.shape[0]:
            _run(s, rank, x2.contiguous(), y, batch_tile)
    return y.reshape(*batch_shape, s.shape[0])


__all__ = ["csb_matvec_sharded", "csb_matvec_sharded_ref",
           "csb_sharded_rows"]

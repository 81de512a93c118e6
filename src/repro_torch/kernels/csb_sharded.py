"""Kernel B3: the CSB matvec with W's block-rows spread over a mesh axis.

It replaces the JAX package's ``repro.kernels.csb_sharded.
csb_matvec_sharded``, which runs B1's Pallas kernel on each device's
shard under ``shard_map``. B3 has no device code of its own: each rank
runs B1 (``csb_mvm.csb_mvm_cuda``; on the CPU its plain version
``ref.csb_mvm_ref``) on its block-row shard of a ``ShardedCSB``,
all-gathers every rank's output rows over the axis's process group
(``torch.distributed``: NCCL between cards, gloo where ranks share one
card or run on the CPU), and puts the rows back in block-row order with
one ``index_select``, as JAX does with one ``take``.

Collective-matmul pipeline, as in JAX: a rank's block-rows are split into
``overlap`` chunks; each chunk's B1 launch is followed by an asynchronous
all-gather of its rows, and the next chunk's B1 is launched before any
gather is waited on, so a backend that runs collectives beside compute
(NCCL between cards) can gather finished rows while later ones are still
computed. Rows are independent, so the chunking changes no number: the
chunk reorder is folded into the row unpermute (``_chunk_order``).

Numerics: B1's launch configuration depends on the block-column count,
the padded kernel sizes and the true batch rows, not on the block-row
count, and a shard keeps the whole matrix's ``Pm`` and ``Pn``; so every
output row is summed in the order of the unsharded launch, and B3 is
bit-equal to B1 on the whole matrix when each rank sees the same true
batch rows.

Bound on the card: B1's bytes on the rank's shard (its live values and
indices, x and its rows of y) plus the gathered rows, moved once.
``LAUNCHES`` counts the calls that ran B1 on the card (one per call;
B1's own count grows by one per chunk).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.csb_format import ShardedCSB, csb_output_permutation
from repro_torch.dist.api import axis_sizes

from .csb_mvm import csb_mvm_cuda
from .ops import pad_to_grid
from .ref import csb_mvm_ref

LAUNCHES = 0
DEFAULT_OVERLAP = 2          # chunks per rank when the caller names none


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
    rpd = s.rows_per_dev
    overlap = min(overlap, rpd)
    pg = mesh.get_group(axis_name)
    vals, ridx, cidx, m, n = s.shard_arrays(dist.get_rank(pg))
    if vals.device != x.device:
        raise ValueError(f"the shard lies on {vals.device}, x on {x.device}")

    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    b = x2.shape[0]
    xp = pad_to_grid(x2, batch_tile, bc * bn).contiguous()
    parts, sent, works = [], [], []
    for s_, e_ in _chunk_bounds(rpd, overlap):
        lo, hi = s_ * bc, e_ * bc
        args = (vals[lo:hi], ridx[lo:hi], cidx[lo:hi], m[lo:hi], n[lo:hi],
                xp)
        if kernel:
            y = csb_mvm_cuda(*args, grid=(e_ - s_, bc), block=s.block,
                             batch_tile=batch_tile, group=group,
                             rows=max(b, 1))
        else:
            y = csb_mvm_ref(*args, grid=(e_ - s_, bc), block=s.block)
        out = [torch.empty_like(y) for _ in range(s.n_dev)]
        works.append(dist.all_gather(out, y, group=pg, async_op=True))
        sent.append(y)
        parts += out
    for w in works:
        w.wait()
    y = torch.cat(parts, dim=1).index_select(
        1, _final_perm(s.row_map, rpd, bm, br, overlap, x.device))
    if kernel:
        global LAUNCHES
        LAUNCHES += 1
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

    ``overlap`` = chunks per rank (default 2, clamped to the rows
    available; 1 = compute, then gather); the result is the same for
    every value. The batch is padded to a multiple of ``batch_tile``;
    ``group`` must divide the block-column count, as in B1. On CUDA
    tensors B1 runs on the card, or the call raises; on CPU tensors B1's
    plain version runs."""
    return _matvec(s, x, mesh, axis_name, batch_tile, group, overlap,
                   kernel=x.device.type != "cpu")


def csb_matvec_sharded_ref(s: ShardedCSB, x: torch.Tensor, *, mesh,
                           axis_name: str = "model", batch_tile: int = 8,
                           group: int | None = None,
                           overlap: int | None = None) -> torch.Tensor:
    """B3's plain version, on any device: ``csb_mvm_ref`` on the rank's
    shard with the same gathers and unpermute (what
    ``csb_matvec_sharded`` runs on CPU tensors)."""
    return _matvec(s, x, mesh, axis_name, batch_tile, group, overlap,
                   kernel=False)


__all__ = ["csb_matvec_sharded", "csb_matvec_sharded_ref"]

"""Placements for CSB weights — the port of ``repro.dist.rules``'
``csb_shard_specs``.

The JAX package answers with ``PartitionSpec`` trees; the port answers
with the placements of ``torch.distributed.tensor`` (``Shard(0)``: the
leading device axis is split over the mesh axis, one slice per rank;
``Replicate()``: every rank holds the whole tensor). The guards are
JAX's: a ``ShardedCSB`` shards only when its split width equals the axis
size and exceeds 1; an unsplit ``PaddedCSB``, a split of another width
and every dense leaf are replicated. The dense leaves' own placements
(JAX's ``param_specs``) wait for ROADMAP item 20.
"""
from __future__ import annotations

from typing import Any

from .api import axis_sizes


def csb_shard_specs(obj: Any, mesh, *, axis: str = "model") -> Any:
    """A tree of the structure of ``obj`` (nested dicts, lists and tuples;
    CSB containers are leaves) holding each leaf's placement on ``mesh``:
    a ``ShardedCSB`` or ``PaddedCSB`` of placements for CSB leaves, a
    placement for every other leaf."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.csb_format import PaddedCSB, ShardedCSB

    size = axis_sizes(mesh).get(axis, 1)

    def one(leaf):
        if isinstance(leaf, ShardedCSB):
            lead = Shard(0) if size == leaf.n_dev > 1 else Replicate()
            return ShardedCSB(vals=lead, row_idx=lead, col_idx=lead, m=lead,
                              n=lead, shape=leaf.shape, grid=leaf.grid,
                              block=leaf.block, row_map=leaf.row_map,
                              rank=leaf.rank)
        if isinstance(leaf, PaddedCSB):
            rep = Replicate()
            return PaddedCSB(vals=rep, row_idx=rep, col_idx=rep, m=rep,
                             n=rep, shape=leaf.shape, grid=leaf.grid,
                             block=leaf.block)
        if isinstance(leaf, dict):
            return {k: one(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(one(v) for v in leaf)
        return Replicate()

    return one(obj)

"""DTensor's collectives as c10d's synchronous ones, for gloo on the card.

Ranks that share a card exchange over gloo (NCCL refuses two ranks on
one card), which takes CUDA tensors and stages them through the host.
DTensor runs its collectives through the functional ops
(``torch.ops._c10d_functional``): each returns at once and a later
``wait_tensor`` waits on the work. On the H100's torch 2.11 that path
crashes the process (SIGSEGV in ``wait_tensor``) for gloo's CUDA
all-gather, where the same all-gather through
``torch.distributed.all_gather_into_tensor`` is right. So
:func:`use_sync_collectives` registers, for one dispatch key, kernels of
the functional ops that run the synchronous c10d collective on the
group the op names and return its result: the values and the group are
the functional op's, only the waiting moves into the call (the
``wait_tensor`` that follows finds no work and returns). These three are
the collectives DTensor made in a training step on the card (its
``CommDebugMode`` counts); DTensor's shard-to-shard exchange (``_dtensor::shard_dim_alltoall``) becomes an
all-gather and a chunk, as DTensor itself does on a CPU group (gloo has
no all-to-all).

``spawn_ranks`` installs them on the card's gloo ranks; the tests install
them for the CPU key to hold them against DTensor's own path.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_LIBS: dict[str, list] = {}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _op(reduce_op: str):
    """The c10d op of a functional ``reduce_op``; "avg" is a sum divided
    afterwards (gloo has no average)."""
    op = reduce_op.lower()
    if op == "avg":
        return dist.ReduceOp.SUM
    if op not in _OPS:
        raise ValueError(f"reduce op {reduce_op!r}")
    return _OPS[op]


def _avg(t: torch.Tensor, reduce_op: str, pg) -> torch.Tensor:
    return t.div_(pg.size()) if reduce_op.lower() == "avg" else t


def all_reduce(inp, reduce_op, group_name):
    pg = _group(group_name)
    out = inp.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_op(reduce_op), group=pg)
    return _avg(out, reduce_op, pg)


def all_gather_into_tensor(inp, group_size, group_name):
    inp = inp.contiguous()
    out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp, group=_group(group_name))
    return out


def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
    pg = _group(group_name)
    inp = inp.contiguous()
    out = inp.new_empty((inp.shape[0] // group_size, *inp.shape[1:]))
    dist.reduce_scatter_tensor(out, inp, op=_op(reduce_op), group=pg)
    return _avg(out, reduce_op, pg)


def shard_dim_alltoall(inp, gather_dim, shard_dim, group_name):
    """Split on ``gather_dim`` -> split on ``shard_dim``: every rank's
    part gathered along ``gather_dim``, then this rank's chunk of
    ``shard_dim`` (DTensor's own route on a CPU group)."""
    pg = _group(group_name)
    n, r = pg.size(), pg.rank()
    parts = [torch.empty_like(inp, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, inp.contiguous(), group=pg)
    full = torch.cat(parts, dim=gather_dim)
    return full.chunk(n, dim=shard_dim)[r].contiguous()


def use_sync_collectives(key: str = "CUDA") -> None:
    """Register this module's kernels for the functional collectives (and
    DTensor's shard-to-shard exchange) under dispatch ``key``, once per
    process."""
    if key in _LIBS:
        return
    import torch.distributed.tensor  # noqa: F401  (defines _dtensor ops)
    libs = [torch.library.Library("_c10d_functional", "IMPL")]
    for name, fn in (("all_reduce", all_reduce),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor)):
        libs[0].impl(name, fn, key)
    if hasattr(torch.ops, "_dtensor") and \
            hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        libs.append(torch.library.Library("_dtensor", "IMPL"))
        libs[1].impl("shard_dim_alltoall", shard_dim_alltoall, key)
    _LIBS[key] = libs

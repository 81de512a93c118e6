"""Run one function on every rank of a device mesh, one process a rank.

The JAX package runs one program over a whole mesh; the port runs one
process per rank (SPMD), each holding its own shard. ``spawn_ranks``
starts the ranks with ``torch.multiprocessing.start_processes`` and the
"spawn" start method (CUDA does not survive a fork), joins them into one
process group through a file store in a fresh temporary directory (so
concurrent callers never share a rendezvous), builds the ("data",
"model") ``DeviceMesh`` and calls ``fn(mesh, *args)`` on every rank. It
returns the ranks' results in rank order.

Cards and backends: the mesh lies on the card unless the caller passes
``device="cpu"``. Rank r uses card ``r % device_count``. When every rank
has a card of its own the ranks use NCCL; when ranks share a card (NCCL
refuses two ranks on one card) they exchange over gloo, which also takes
CUDA tensors, staged through the host. Ranks on the CPU use gloo.

A rank that raises fails the call with that rank's traceback, and the
other ranks are stopped. Booting a rank (spawning the interpreter,
importing torch, joining the group) has its own limit, ``BOOT_S``; the
deadline ``timeout_s`` starts once every rank has joined, so a slow
machine's boot never counts against ``fn``. A rank still running at
either limit is stopped too, and the call raises ``TimeoutError``: a
hung collective fails the caller, it does not stall it. ``fn`` and
``args`` must be picklable (a module-level function).
"""
from __future__ import annotations

import datetime
import math
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

# how long every rank may take to boot (spawn, import torch, join the
# group) before the call fails; ``fn``'s deadline starts after it
BOOT_S = 300.0


def _rank_main(rank: int, world: int, mesh_shape, device_type: str,
               cards: int, backend: str, workdir: str,
               group_timeout_s: float) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank % cards)
    # the job comes through a file: a large pickle through the start pipe
    # would hold each start() until its rank has booted
    fn, args = torch.load(f"{workdir}/job.pt", weights_only=False)
    dist.init_process_group(
        backend, init_method=f"file://{workdir}/store", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=group_timeout_s))
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(device_type, tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    open(f"{workdir}/joined{rank}", "w").close()
    out = fn(mesh, *args)
    torch.save(out, f"{workdir}/result{rank}.pt")
    dist.destroy_process_group()


def _wait(ctx, world: int, limit_s: float, what: str,
          pending=None) -> None:
    """Join the ranks until they have all ended or, given ``pending`` (a
    function: the ranks yet to reach some point, polled every 0.2 s),
    until it returns none; a failed rank re-raises here and the others
    are stopped. Past ``limit_s`` the ranks still alive (of the pending
    ones) are named in a ``TimeoutError``."""
    deadline = time.monotonic() + limit_s
    while pending is None or pending():
        left = max(deadline - time.monotonic(), 0)
        # join re-raises a failed rank's traceback and stops the others
        if ctx.join(timeout=left if pending is None else min(left, 0.2),
                    grace_period=5):
            return
        if time.monotonic() >= deadline:
            ranks = range(world) if pending is None else pending()
            live = [r for r in ranks if ctx.processes[r].is_alive()]
            raise TimeoutError(f"ranks {live} of {world} still {what} "
                               f"after {limit_s:.0f} s")


def spawn_ranks(fn, mesh_shape: tuple[int, int], *args,
                device: str | torch.device | None = None,
                timeout_s: float = 120.0) -> list:
    """``fn(mesh, *args)`` on each rank of a ("data", "model") mesh of
    ``mesh_shape``; returns their results in rank order. The mesh lies on
    the card (``device=None``; raises without CUDA) unless ``device`` is
    "cpu". Every rank must join the group within ``BOOT_S``; ``fn`` then
    has ``timeout_s`` from the moment the last rank joined."""
    dev = resolve_device(device)
    world = math.prod(mesh_shape)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if 0 < world <= cards else "gloo"
    with tempfile.TemporaryDirectory(prefix="ranks-") as workdir:
        torch.save((fn, args), f"{workdir}/job.pt")
        ctx = torch.multiprocessing.start_processes(
            _rank_main, nprocs=world, join=False, daemon=True,
            start_method="spawn",
            args=(world, tuple(mesh_shape), dev.type, cards,
                  backend, workdir, BOOT_S + timeout_s))
        joined = [Path(workdir, f"joined{r}") for r in range(world)]
        try:
            _wait(ctx, world, BOOT_S, "booting", pending=lambda: [
                r for r, p in enumerate(joined) if not p.exists()])
            _wait(ctx, world, timeout_s, "running")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(f"{workdir}/result{r}.pt", weights_only=False)
                for r in range(world)]

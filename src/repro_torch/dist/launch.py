"""Run one function on every rank of a device mesh, one process a rank.

The JAX package runs one program over a whole mesh; the port runs one
process per rank (SPMD), each holding its own shard. ``spawn_ranks``
starts the ranks with ``torch.multiprocessing.start_processes`` and the
"spawn" start method (CUDA does not survive a fork), joins them into one
process group through a file store in a fresh temporary directory (so
concurrent callers never share a rendezvous), builds the ("data",
"model") ``DeviceMesh`` (("pod", "data", "model") for a shape of three
axes, as JAX's launcher names them) and calls ``fn(mesh, *args)`` on
every rank. It returns the ranks' results in rank order.

Cards and backends: the mesh lies on the card unless the caller passes
``device="cpu"`` (ranks on the CPU then share the host's cores: each
runs its share of them as intra-op threads). Rank r uses card
``r % device_count``. When every rank has a card of its own the ranks
use NCCL; when ranks share a card (NCCL refuses two ranks on one card)
they exchange over gloo, which also takes CUDA tensors, staged through
the host; there DTensor's collectives run as c10d's synchronous ones
(``dist.gloo_cuda``). Ranks on the CPU use gloo.

A rank that raises fails the call with that rank's traceback, and the
other ranks are stopped. Where several ranks failed (a peer of the rank
that raised fails in its collective too), the error puts the traceback
written first ahead of the others, whichever rank ``join`` noticed
first. Ranks on the card synchronise and meet at a barrier before they
leave the group, so that no rank exits while a peer's kernel may still
store into its memory (kernel B3's exchange). Booting a rank (spawning the interpreter,
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
import os
import pickle
import signal
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.multiprocessing import (
    ProcessExitedException, ProcessRaisedException,
)

from repro_torch._device import resolve_device

# the mesh axes of a shape, by its length (JAX's ``launch/train.py``)
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}

# how long every rank may take to boot (spawn, import torch, join the
# group) before the call fails; ``fn``'s deadline starts after it
BOOT_S = 300.0


def _rank_main(rank: int, world: int, mesh_shape, device_type: str,
               cards: int, backend: str, workdir: str,
               group_timeout_s: float) -> None:
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % cards)
        else:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        # the job comes through a file: a large pickle through the start
        # pipe would hold each start() until its rank has booted
        fn, args = torch.load(f"{workdir}/job.pt", weights_only=False)
        dist.init_process_group(
            backend, init_method=f"file://{workdir}/store", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=group_timeout_s))
        if device_type == "cuda" and backend == "gloo":
            # gloo's CUDA work crashes under the functional collectives
            from repro_torch.dist.gloo_cuda import use_sync_collectives
            use_sync_collectives("CUDA")
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(device_type, tuple(mesh_shape),
                                mesh_dim_names=AXES[len(mesh_shape)])
        open(f"{workdir}/joined{rank}", "w").close()
        out = fn(mesh, *args)
        torch.save(out, f"{workdir}/result{rank}.pt")
        if device_type == "cuda":
            torch.cuda.synchronize()
            dist.barrier(**({"device_ids": [rank % cards]}
                            if backend == "nccl" else {}))
        dist.destroy_process_group()
    except Exception:
        # when this rank failed, to the nanosecond: a file's mtime ticks
        # too coarsely to order two ranks that fail within a few ms
        Path(workdir, f"failed{rank}").write_text(str(time.time_ns()))
        raise


# how ``ProcessContext.join`` stops the ranks left once one has failed
_STOPPED = (-signal.SIGTERM, -signal.SIGKILL)


def _failure(ctx, err: Exception, workdir: str) -> Exception:
    """One error for the ranks that failed, once ``join`` has raised
    ``err`` and stopped the rest. ``join`` reports the lowest-numbered
    rank among those that had ended when it polled, not the first to
    fail, so the error is rebuilt from every traceback the ranks wrote
    (``ctx.error_files``), the first-written first (by the time each rank
    stamped when it failed, else the file's mtime); a rank that ended
    without one (a signal, an exit code), other than by ``join``'s own
    stopping, goes ahead of them: its peers' errors follow from it."""
    written = []
    for r, path in enumerate(ctx.error_files):
        try:
            with open(path, "rb") as fh:
                trace = pickle.load(fh)
            stamp = Path(workdir, f"failed{r}")
            when = (int(stamp.read_text()) if stamp.exists()
                    else os.stat(path).st_mtime_ns)
            written.append((when, r, trace))
        except FileNotFoundError:
            continue
    written.sort()
    traced = {r for _, r, _ in written}
    silent = [(r, p.exitcode) for r, p in enumerate(ctx.processes)
              if r not in traced and p.exitcode not in (0, None, *_STOPPED)]
    if not written and not silent:
        return err
    parts = []
    for r, code in silent:
        how = (f"signal {signal.Signals(-code).name}" if code < 0
               else f"exit code {code}")
        parts.append(f"rank {r} ended without a traceback ({how})")
    parts += [f"rank {r} raised:\n{trace}" for _, r, trace in written]
    msg = "\n\n-- " + "\n\n-- then ".join(parts)
    r = silent[0][0] if silent else written[0][1]
    pid = ctx.processes[r].pid
    if silent:
        return ProcessExitedException(msg, r, pid, silent[0][1])
    return ProcessRaisedException(msg, r, pid)


def _wait(ctx, world: int, limit_s: float, what: str, workdir: str,
          pending=None) -> None:
    """Join the ranks until they have all ended or, given ``pending`` (a
    function: the ranks yet to reach some point, polled every 0.2 s),
    until it returns none; a failed rank re-raises here and the others
    are stopped. Past ``limit_s`` the ranks still alive (of the pending
    ones) are named in a ``TimeoutError``."""
    deadline = time.monotonic() + limit_s
    while pending is None or pending():
        left = max(deadline - time.monotonic(), 0)
        # join raises for a failed rank and stops the others
        try:
            if ctx.join(timeout=left if pending is None else min(left, 0.2),
                        grace_period=5):
                return
        except (ProcessRaisedException, ProcessExitedException) as e:
            raise _failure(ctx, e, workdir) from None
        if time.monotonic() >= deadline:
            ranks = range(world) if pending is None else pending()
            live = [r for r in ranks if ctx.processes[r].is_alive()]
            raise TimeoutError(f"ranks {live} of {world} still {what} "
                               f"after {limit_s:.0f} s")


def spawn_ranks(fn, mesh_shape: tuple[int, ...], *args,
                device: str | torch.device | None = None,
                timeout_s: float = 120.0) -> list:
    """``fn(mesh, *args)`` on each rank of a ("data", "model") mesh of
    ``mesh_shape`` (("pod", "data", "model") for three axes); returns
    their results in rank order. The mesh lies on the card
    (``device=None``; raises without CUDA) unless ``device`` is "cpu".
    Every rank must join the group within ``BOOT_S``; ``fn`` then
    has ``timeout_s`` from the moment the last rank joined."""
    if len(mesh_shape) not in AXES:
        raise ValueError(f"mesh shape {mesh_shape}: two or three axes")
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
            _wait(ctx, world, BOOT_S, "booting", workdir, pending=lambda: [
                r for r, p in enumerate(joined) if not p.exists()])
            _wait(ctx, world, timeout_s, "running", workdir)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(f"{workdir}/result{r}.pt", weights_only=False)
                for r in range(world)]

"""Mesh-aware CSB block partitioning — the paper's PEGroup balancing
(§5.2, Fig. 7b) lifted one level, from PEs to devices. The port of
``repro.dist.csb_partition``, a copy of its host numpy on the port's
formats.

Inside one device, ``engine/schedule.py`` balances kernel workloads
across a K x L PEGroup torus by donating PE-aligned cycle quanta to torus
neighbours. Here the same cost model and the same donation move operate
across the mesh "model" axis: each device is a station on a 1-D ring, the
workload unit is a whole BLOCK-ROW of the CSB grid (a block-row's output
rows live on exactly one device, so the sharded kernel needs no
cross-device scatter — only a final all-gather), and the cost of a
block-row is the PEGroup cycle count the engine would charge for its
blocks (``engine.schedule._block_cycles``) — not its row count.

``plan_block_rows(..., policy="equal")``  — naive contiguous equal-row
    split (the baseline; kept for comparison).
``plan_block_rows(..., policy="greedy")`` — LPT seeding followed by
    ring-neighbour donation rounds, the multi-device twin of
    ``greedy_schedule``'s torus donation.

The plan is deterministic host numpy, so every rank of a mesh computes the
same plan on its own; ``partition_padded`` applies it to a ``PaddedCSB``
via ``split_block_rows``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.csb_format import CSBMatrix, PaddedCSB, ShardedCSB
from repro_torch.engine.schedule import _block_cycles


def block_row_cycles(mat: "PaddedCSB | CSBMatrix | tuple",
                     pe: tuple[int, int] = (8, 8)) -> np.ndarray:
    """(Br,) per-block-row PEGroup cycle cost under a P x Q group — the
    engine's own cost model, summed over the block columns each device
    would execute sequentially. ``mat`` may also be a raw ``(m, n)`` pair
    of (Br, Bc) survivor-count grids."""
    if isinstance(mat, PaddedCSB):
        br, bc = mat.grid
        m = mat.m.cpu().numpy().reshape(br, bc).astype(np.int64)
        n = mat.n.cpu().numpy().reshape(br, bc).astype(np.int64)
    elif isinstance(mat, tuple):
        m = np.asarray(mat[0], np.int64)
        n = np.asarray(mat[1], np.int64)
    else:
        m = mat.m.astype(np.int64)
        n = mat.n.astype(np.int64)
    p, q = pe
    return _block_cycles(m, n, p, q).sum(axis=1)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Block-row -> device placement plus the cycle accounting behind it."""

    assignment: tuple[tuple[int, ...], ...]   # block-row ids per device
    device_cycles: tuple[int, ...]            # planned cycles per device
    policy: str

    @property
    def n_dev(self) -> int:
        return len(self.assignment)

    @property
    def imbalance(self) -> float:
        """max/mean per-device cycles — 1.0 is perfect balance."""
        cyc = np.asarray(self.device_cycles, np.float64)
        mean = cyc.mean()
        return float(cyc.max() / mean) if mean > 0 else 1.0

    def as_dict(self) -> dict:
        return {
            "policy": self.policy,
            "n_dev": self.n_dev,
            "device_cycles": list(self.device_cycles),
            "imbalance": round(self.imbalance, 4),
        }


def _equal_split(n_rows: int, n_dev: int) -> list[list[int]]:
    """Contiguous ceil(Br/D)-row chunks — what a plain reshape-style dense
    sharding would do."""
    per = -(-n_rows // n_dev)
    return [list(range(d * per, min((d + 1) * per, n_rows)))
            for d in range(n_dev)]


def _ring_donate(assignment: list[list[int]], cost: np.ndarray,
                 rounds: int = 8) -> None:
    """Donate block-rows to ring neighbours until balanced (in place).

    The heaviest-loaded devices try to hand a block-row to whichever ring
    neighbour is lighter, choosing the row whose cost best matches half
    the load gap (the engine's ``give = gap // 2`` waterfill, rounded to
    whole block-rows). A move only happens when it strictly lowers the
    pair's max load, so the loop monotonically improves and terminates.
    """
    n_dev = len(assignment)
    if n_dev <= 1:
        return
    load = np.array([sum(cost[r] for r in rows) for rows in assignment],
                    np.int64)
    for _ in range(rounds):
        moved = False
        for d in np.argsort(load)[::-1]:
            for t in sorted({(d - 1) % n_dev, (d + 1) % n_dev},
                            key=lambda i: load[i]):
                gap = load[d] - load[t]
                if gap <= 0 or not assignment[d]:
                    continue
                give = gap // 2
                row = min(assignment[d],
                          key=lambda r: abs(int(cost[r]) - give))
                c = int(cost[row])
                if c == 0 or max(load[d] - c, load[t] + c) >= load[d]:
                    continue
                assignment[d].remove(row)
                assignment[t].append(row)
                load[d] -= c
                load[t] += c
                moved = True
        if not moved:
            break


def plan_block_rows(cycles: Sequence[int] | np.ndarray, n_dev: int,
                    policy: str = "greedy",
                    donation_rounds: int = 8) -> PartitionPlan:
    """Place ``len(cycles)`` block-rows on ``n_dev`` devices.

    ``policy="equal"``  — contiguous equal-row chunks (naive baseline).
    ``policy="greedy"`` — LPT (heaviest row to lightest device) seeding
    plus ring-donation refinement; both steps work on engine cycle costs,
    so a diagonal-dense matrix spreads its heavy rows.
    """
    cost = np.asarray(cycles, np.int64)
    br = len(cost)
    if n_dev < 1:
        raise ValueError("n_dev must be >= 1")
    if policy == "equal":
        assignment = _equal_split(br, n_dev)
    elif policy == "greedy":
        assignment = [[] for _ in range(n_dev)]
        load = np.zeros(n_dev, np.int64)
        for r in np.argsort(cost, kind="stable")[::-1]:
            d = int(np.argmin(load))
            assignment[d].append(int(r))
            load[d] += cost[r]
        _ring_donate(assignment, cost, rounds=donation_rounds)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    for rows in assignment:
        rows.sort()
    return PartitionPlan(
        assignment=tuple(tuple(rows) for rows in assignment),
        device_cycles=tuple(int(sum(cost[r] for r in rows))
                            for rows in assignment),
        policy=policy,
    )


def partition_padded(p: PaddedCSB, n_dev: int, *,
                     pe: tuple[int, int] = (8, 8),
                     policy: str = "greedy"
                     ) -> tuple[PartitionPlan, ShardedCSB]:
    """Plan + apply: returns the plan and the device-stacked shards (on
    ``p``'s device).

    With :mod:`repro_torch.obs` enabled, each application records the
    per-device cycle balance (the paper's workload-imbalance metric,
    §6.3.2): the ``dist/csb_partition/imbalance`` and
    ``.../max_device_cycles`` gauges, and a trace instant carrying the
    full per-device cycle vector."""
    plan = plan_block_rows(block_row_cycles(p, pe=pe), n_dev, policy=policy)
    from repro_torch.obs import metrics as obs_metrics, trace as obs_trace
    reg = obs_metrics.get()
    if reg is not None:
        reg.gauge("dist/csb_partition/imbalance").set(plan.imbalance)
        reg.gauge("dist/csb_partition/max_device_cycles").set(
            max(plan.device_cycles))
    tr = obs_trace.get()
    if tr is not None:
        tr.instant("dist/csb_partition",
                   args={"imbalance": round(plan.imbalance, 4),
                         "device_cycles": list(plan.device_cycles),
                         "policy": plan.policy})
    return plan, p.split_block_rows(plan.assignment)


def check_plans(row_maps, group) -> None:
    """Raise unless every rank of the process group ``group`` holds the
    same row maps. Each rank plans for itself, and a plan that differed
    between ranks would gather rows into the wrong places. One all-gather
    of a 64-bit hash of ``row_maps``."""
    import hashlib

    import torch
    import torch.distributed as dist

    digest = hashlib.sha256(repr(tuple(row_maps)).encode()).digest()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    mine = torch.tensor([int.from_bytes(digest[:8], "little", signed=True)],
                        device=dev)
    got = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, mine, group=group)
    hashes = [int(t) for t in got]
    if len(set(hashes)) > 1:
        raise RuntimeError(f"the ranks planned different block-row maps "
                           f"(hashes by rank {hashes})")

"""Workload-balancing compilation for the CSB-Engine (paper §5.2) — a
copy of ``repro.engine.schedule`` (numpy; z3 for ``smt_schedule``).

A PEGroup of P x Q PEs processes an (m x n) kernel in
``ceil(m/P) * ceil(n/Q)`` multi-passes — small kernels waste PE-cycles on
pass granularity, and kernel-size variance across a K x L block iteration
leaves whole groups idle (Fig. 7b). Two schedulers rebalance each
iteration:

``smt_schedule``    — the paper's Algorithm 2: partition variables
    (m', n', dm_h, dn_h, dm_v, dn_v) per PEGroup constrained by CLP1-CLP7
    and solved with Z3, growing ``margin`` by P*Q until SAT.

``greedy_schedule`` — beyond-paper production path: torus-neighbour
    donation of PE-aligned cycle quanta (the same sharing paths the
    hardware has: right->left horizontal, down->up vertical), ~1000x
    faster than Z3 with near-identical balance.

Both return per-iteration per-group CYCLE counts; true MAC totals live in
the CSB matrix itself. The simulator turns these into utilization.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .isa import MicroInst


@dataclasses.dataclass
class Schedule:
    """Per-iteration per-group cycle counts after balancing."""

    iter_cycles: list[np.ndarray]          # each (K, L) int cycles
    micro: list[MicroInst]
    mode: str                              # none | vertical | horizontal | 2d
    solver_rounds: int = 0

    @property
    def total_cycles(self) -> int:
        return int(sum(int(c.max()) for c in self.iter_cycles))


def _iter_tiles(m: np.ndarray, n: np.ndarray, k: int, l: int):
    """Yield (i0, j0, mt, nt) — K x L tiles of the block grid (blocks are
    mapped row-major, paper §4.3.1)."""
    br, bc = m.shape
    for i0 in range(0, br, k):
        for j0 in range(0, bc, l):
            mt = np.zeros((k, l), np.int64)
            nt = np.zeros((k, l), np.int64)
            ms = m[i0: i0 + k, j0: j0 + l]
            ns = n[i0: i0 + k, j0: j0 + l]
            mt[: ms.shape[0], : ms.shape[1]] = ms
            nt[: ns.shape[0], : ns.shape[1]] = ns
            yield i0, j0, mt, nt


def _block_cycles(mt, nt, P, Q) -> np.ndarray:
    """Cycles a PEGroup spends on a kernel. Blocks stream back-to-back
    through the PE pipeline (the NeuronAccumBuffer lets the next pass
    start while the previous accumulates — paper §4.3.1 measures
    *pipeline* utilization), so partial passes pack: ceil(m*n / P*Q)."""
    return np.ceil(mt * nt / (P * Q)).astype(np.int64)


def no_sharing_schedule(m, n, K, L, P, Q) -> Schedule:
    iters = []
    micro = []
    for i0, j0, mt, nt in _iter_tiles(np.asarray(m), np.asarray(n), K, L):
        iters.append(_block_cycles(mt, nt, P, Q))
        for k in range(K):
            for l in range(L):
                if mt[k, l] and nt[k, l]:
                    micro.append(MicroInst((k, l), "local",
                                           int(mt[k, l]), int(nt[k, l]),
                                           (i0 + k, j0 + l)))
    return Schedule(iters, micro, "none")


def _neighbours(k, l, K, L, mode):
    out = []
    if mode in ("horizontal", "2d"):
        out.append((k, (l - 1) % L))
    if mode in ("vertical", "2d"):
        out.append(((k - 1) % K, l))
    return out


def greedy_schedule(m, n, K, L, P, Q, mode: str = "2d",
                    rounds: int = 8) -> Schedule:
    """Donate PE-aligned cycle quanta to torus neighbours until balanced."""
    assert mode in ("vertical", "horizontal", "2d")
    iters = []
    micro: list[MicroInst] = []
    for i0, j0, mt, nt in _iter_tiles(np.asarray(m), np.asarray(n), K, L):
        cyc = _block_cycles(mt, nt, P, Q)
        for _ in range(rounds):
            moved = False
            order = np.dstack(np.unravel_index(
                np.argsort(cyc, axis=None)[::-1], cyc.shape))[0]
            for k, l in order:
                # waterfill the donor against its neighbour set: donors
                # may push receivers above the mean (chains resolve over
                # rounds — physically, a receiver's own block can be
                # shared onward along the opposite torus direction).
                for (tk, tl) in sorted(_neighbours(k, l, K, L, mode),
                                       key=lambda t: cyc[t]):
                    give = (cyc[k, l] - cyc[tk, tl]) // 2
                    if give > 0:
                        cyc[k, l] -= give
                        cyc[tk, tl] += give
                        moved = True
                        micro.append(MicroInst(
                            (tk, tl),
                            "horizontal" if tk == k else "vertical",
                            int(give) * P, Q, (i0 + k, j0 + l)))
            if not moved:
                break
        iters.append(cyc)
        for k in range(K):
            for l in range(L):
                if mt[k, l] and nt[k, l]:
                    micro.append(MicroInst((k, l), "local",
                                           int(mt[k, l]), int(nt[k, l]),
                                           (i0 + k, j0 + l)))
    return Schedule(iters, micro, mode)


def smt_schedule(m, n, K, L, P, Q, mode: str = "2d",
                 max_rounds: int = 64) -> Schedule:
    """Paper Algorithm 2 with Z3 (CLP1-CLP7)."""
    import z3

    assert mode in ("vertical", "horizontal", "2d")
    iters = []
    micro: list[MicroInst] = []
    total_rounds = 0
    for i0, j0, mt, nt in _iter_tiles(np.asarray(m), np.asarray(n), K, L):
        avg = float((mt * nt).sum()) / (K * L)
        margin = 0
        rounds = 0
        model = None
        mp = np_ = dmh = dnh = dmv = dnv = None
        while model is None and rounds < max_rounds:
            rounds += 1
            s = z3.Solver()
            s.set("timeout", 5000)
            mp, np_, dmh, dnh, dmv, dnv = {}, {}, {}, {}, {}, {}
            for k in range(K):
                for l in range(L):
                    mk, nk = int(mt[k, l]), int(nt[k, l])
                    mp[k, l] = z3.Int(f"mp_{k}_{l}")
                    np_[k, l] = z3.Int(f"np_{k}_{l}")
                    dmh[k, l] = z3.Int(f"dmh_{k}_{l}")
                    dnh[k, l] = z3.Int(f"dnh_{k}_{l}")
                    dmv[k, l] = z3.Int(f"dmv_{k}_{l}")
                    dnv[k, l] = z3.Int(f"dnv_{k}_{l}")
                    # CLP1 / CLP2 feasible region
                    s.add(dmh[k, l] >= 0, dmh[k, l] <= mk)
                    s.add(dnh[k, l] >= 0, dnh[k, l] <= nk)
                    s.add(dmv[k, l] >= 0, dmv[k, l] <= mk // 2)
                    s.add(dnv[k, l] >= 0, dnv[k, l] <= nk)
                    if mode == "horizontal":
                        s.add(dmv[k, l] == 0, dnv[k, l] == 0)
                    if mode == "vertical":
                        s.add(dmh[k, l] == 0, dnh[k, l] == 0)
                    # CLP3 v CLP4 regular partitions (Fig. 9a)
                    clp3 = z3.And(dmh[k, l] == mk,
                                  dnv[k, l] + dnh[k, l] == nk)
                    clp4 = z3.And(dnv[k, l] == nk,
                                  dmh[k, l] + dmv[k, l] == mk)
                    zero = z3.And(dmh[k, l] == 0, dnh[k, l] == 0,
                                  dmv[k, l] == 0, dnv[k, l] == 0)
                    s.add(z3.Or(clp3, clp4, zero))
                    # CLP5 definitions
                    s.add(mp[k, l] == mk - dmv[k, l])
                    s.add(np_[k, l] == nk - dnh[k, l])
                    # CLP6 PE-aligned shared partitions
                    s.add(dmv[k, l] % P == 0)
                    s.add(dnh[k, l] % Q == 0)
            for k in range(K):
                for l in range(L):
                    # CLP7: workload within margin of avg (torus neighbours)
                    w = (mp[k, l] * np_[k, l]
                         + dmh[k, (l + 1) % L] * dnh[k, (l + 1) % L]
                         + dmv[(k + 1) % K, l] * dnv[(k + 1) % K, l])
                    s.add(w - int(avg) <= margin)
            if s.check() == z3.sat:
                model = s.model()
            else:
                margin += P * Q
        total_rounds += rounds
        cyc = np.zeros((K, L), np.int64)
        for k in range(K):
            for l in range(L):
                if model is not None:
                    gm = model[mp[k, l]].as_long()
                    gn = model[np_[k, l]].as_long()
                    hk = model[dmh[k, (l + 1) % L]].as_long()
                    hn = model[dnh[k, (l + 1) % L]].as_long()
                    vk = model[dmv[(k + 1) % K, l]].as_long()
                    vn = model[dnv[(k + 1) % K, l]].as_long()
                else:  # timeout fallback: unbalanced
                    gm, gn = int(mt[k, l]), int(nt[k, l])
                    hk = hn = vk = vn = 0
                cyc[k, l] = int(np.ceil(
                    (gm * gn + hk * hn + vk * vn) / (P * Q)))
                if gm * gn:
                    micro.append(MicroInst((k, l), "local", gm, gn,
                                           (i0 + k, j0 + l)))
                if hk * hn:
                    micro.append(MicroInst((k, l), "horizontal", hk, hn,
                                           (i0 + k, (j0 + l + 1))))
                if vk * vn:
                    micro.append(MicroInst((k, l), "vertical", vk, vn,
                                           ((i0 + k + 1), j0 + l)))
        iters.append(cyc)
    return Schedule(iters, micro, mode, solver_rounds=total_rounds)

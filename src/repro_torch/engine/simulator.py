"""Cycle model of the CSB-Engine (paper §6.3.2, Fig. 12) — a copy of
``repro.engine.simulator`` on the port's ``CSBMatrix``. Its cycles and
latencies are the paper engine's (a PE grid at ``freq_mhz``), not a
GPU's.

A PEGroup of P x Q PEs processes an (m x n) kernel partition in
ceil(m/P) * ceil(n/Q) passes (one MAC per PE per cycle). Within one block
iteration all K x L PEGroups run in lockstep, so the iteration takes the
*maximum* group cycle count — utilization is true MACs over issued
PE-cycles. Workload sharing (engine.schedule) shrinks that maximum; this
model reproduces the paper's 42% -> ~72% -> ~94% utilization ladder.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.csb_format import CSBMatrix
from .schedule import Schedule, greedy_schedule, no_sharing_schedule


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    K: int = 4        # PEGroup rows
    L: int = 4        # PEGroup cols
    P: int = 4        # PEs per group (rows)
    Q: int = 4
    freq_mhz: float = 200.0

    @property
    def pes(self) -> int:
        return self.K * self.L * self.P * self.Q


@dataclasses.dataclass
class SimResult:
    cycles: int
    true_macs: int
    issued_macs: int
    efficiency: float
    latency_us: float
    mode: str


def make_schedule(csb: CSBMatrix, ecfg: EngineConfig,
                  sharing: str = "2d", solver: str = "greedy") -> Schedule:
    m, n = csb.m.astype(np.int64), csb.n.astype(np.int64)
    if sharing == "none":
        return no_sharing_schedule(m, n, ecfg.K, ecfg.L, ecfg.P, ecfg.Q)
    if solver == "smt":
        from .schedule import smt_schedule
        return smt_schedule(m, n, ecfg.K, ecfg.L, ecfg.P, ecfg.Q,
                            mode=sharing)
    return greedy_schedule(m, n, ecfg.K, ecfg.L, ecfg.P, ecfg.Q,
                           mode=sharing)


def simulate_matrix(csb: CSBMatrix, ecfg: EngineConfig,
                    sharing: str = "2d",
                    schedule: Schedule | None = None) -> SimResult:
    """Simulate one CSB-MVM (the whole sparse weight matrix x vector)."""
    if schedule is None:
        schedule = make_schedule(csb, ecfg, sharing)
    total_cycles = schedule.total_cycles
    true = int((csb.m.astype(np.int64) * csb.n).sum())
    issued = total_cycles * ecfg.pes
    eff = true / issued if issued else 0.0
    lat = total_cycles / (ecfg.freq_mhz * 1e6) * 1e6
    return SimResult(total_cycles, true, issued, eff, lat, schedule.mode)


def simulate_model_layer(
    csb_list: list[CSBMatrix], ecfg: EngineConfig, sharing: str = "2d",
) -> SimResult:
    """All MVMs of one RNN layer (e.g. 8 matrices for an LSTM)."""
    res = [simulate_matrix(c, ecfg, sharing) for c in csb_list]
    cycles = sum(r.cycles for r in res)
    true = sum(r.true_macs for r in res)
    issued = sum(r.issued_macs for r in res)
    eff = true / issued if issued else 0.0
    lat = cycles / (ecfg.freq_mhz * 1e6) * 1e6
    return SimResult(cycles, true, issued, eff, lat, sharing)


def dense_latency_us(shape: tuple[int, int], ecfg: EngineConfig) -> float:
    """Reference: unpruned dense MVM on the same PE grid."""
    out_dim, in_dim = shape
    macs = out_dim * in_dim
    cycles = -(-macs // ecfg.pes)
    return cycles / (ecfg.freq_mhz * 1e6) * 1e6

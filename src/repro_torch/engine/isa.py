"""Instruction set + macro-instruction compilation (paper §5.1) — a copy
of ``repro.engine.isa`` on the port's ``CellGraph``.

The RNN dataflow architecture executes VLIW words whose sections drive
the operation units of Fig. 5/8: LoadUnit, CSB-Engine (MVM), two adders,
sigmoid, tanh, two multipliers, StoreUnit. ``compile_macro`` list-schedules
a cell's dataflow DAG (repro_torch.cells) onto those units with the ASAP
strategy — the schedule length is what the latency model uses, and the
occupancy table reproduces the paper's claim that throughput is bounded
by the CSB-Engine section.
"""
from __future__ import annotations

import dataclasses

from repro_torch.cells.dataflow import CellGraph

# op kind -> hardware unit pools (paper Fig. 8). relu rides the
# activation unit (Li-GRU extension); one_minus is an adder op.
UNIT_POOLS: dict[str, tuple[str, ...]] = {
    "mvm": ("CSB-Engine",),
    "add": ("Sum1", "Sum2"),
    "bias": ("Sum1", "Sum2"),
    "one_minus": ("Sum1", "Sum2"),
    "mul": ("Mult1", "Mult2"),
    "sigmoid": ("Sigmoid",),
    "relu": ("Sigmoid",),
    "tanh": ("Tanh",),
}

ALL_UNITS = ("LoadUnit", "CSB-Engine", "Sum1", "Sum2", "Sigmoid",
             "Tanh", "Mult1", "Mult2", "StoreUnit")


@dataclasses.dataclass(frozen=True)
class MacroSlot:
    unit: str
    op: str               # op name in the cell graph
    count: int            # workload elements (Count operand)


@dataclasses.dataclass
class MacroProgram:
    """One VLIW word per time slot; a slot maps unit -> MacroSlot."""

    words: list[dict[str, MacroSlot]]
    graph_name: str

    @property
    def length(self) -> int:
        return len(self.words)

    def occupancy(self) -> dict[str, float]:
        occ = {u: 0 for u in ALL_UNITS}
        for w in self.words:
            for u in w:
                occ[u] += 1
        n = max(len(self.words), 1)
        return {u: c / n for u, c in occ.items()}


def compile_macro(graph: CellGraph) -> MacroProgram:
    """ASAP list scheduling of the cell DAG onto the unit pools."""
    # dependency levels
    level: dict[str, int] = {}
    for op in graph.ops:
        if op.kind == "input":
            level[op.name] = -1
            continue
    scheduled: dict[str, int] = {}
    words: list[dict[str, MacroSlot]] = []

    def ready(op) -> bool:
        return all(
            (i in scheduled) or graph.op(i).kind == "input"
            for i in op.inputs)

    def dep_slot(op) -> int:
        slots = [-1]
        for i in op.inputs:
            if i in scheduled:
                slots.append(scheduled[i])
        return max(slots)

    remaining = [op for op in graph.ops if op.kind != "input"]
    t = 0
    guard = 0
    while remaining:
        guard += 1
        if guard > 10000:  # pragma: no cover
            raise RuntimeError("scheduling did not converge")
        while len(words) <= t:
            words.append({})
        used = set(words[t])
        placed = []
        usage: dict[str, int] = {}
        for w in words:
            for u in w:
                usage[u] = usage.get(u, 0) + 1
        for op in remaining:
            if not ready(op) or dep_slot(op) >= t:
                continue
            pool = UNIT_POOLS[op.kind]
            free = [u for u in pool if u not in used]
            # least-used unit in the pool: balances Sum1/Sum2, Mult1/Mult2
            unit = min(free, key=lambda u: usage.get(u, 0), default=None)
            if unit is None:
                continue
            count = op.shape[0] if op.shape else graph.hidden_dim
            words[t][unit] = MacroSlot(unit, op.name, int(count))
            used.add(unit)
            scheduled[op.name] = t
            placed.append(op)
        for op in placed:
            remaining.remove(op)
        t += 1
    return MacroProgram(words=[w for w in words if w],
                        graph_name=graph.name)


@dataclasses.dataclass(frozen=True)
class MicroInst:
    """CSB-Engine micro-instruction (paper Fig. 9): one workload partition
    executed by one PEGroup."""

    group: tuple[int, int]        # (k, l)
    sharing: str                  # local | horizontal | vertical
    trip_m: int
    trip_n: int
    block: tuple[int, int]        # source block (i, j) in the weight grid

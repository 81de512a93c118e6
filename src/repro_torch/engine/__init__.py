"""repro_torch.engine — the paper's architecture-compilation co-design
layer: VLIW macro compilation, SMT/greedy workload balancing, cycle
simulation of the CSB-Engine. Host numpy, copied from ``repro.engine``;
its latencies are the paper engine's cycle model, not GPU times."""
from .isa import MacroProgram, MicroInst, compile_macro
from .schedule import (
    Schedule, greedy_schedule, no_sharing_schedule, smt_schedule,
)
from .simulator import (
    EngineConfig, SimResult, dense_latency_us, make_schedule,
    simulate_matrix, simulate_model_layer,
)

__all__ = [
    "MacroProgram", "MicroInst", "compile_macro",
    "Schedule", "greedy_schedule", "no_sharing_schedule", "smt_schedule",
    "EngineConfig", "SimResult", "dense_latency_us", "make_schedule",
    "simulate_matrix", "simulate_model_layer",
]

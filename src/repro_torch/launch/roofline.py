"""Three-term roofline of one step, from the dry run's per-device counts:
the port of ``repro.launch.roofline``.

    compute    = FLOPs per device            / peak FLOP/s per card
    memory     = bytes per device            / HBM rate per card
    collective = collective operand bytes    / collective link rate

The counts come from ``launch.op_cost`` (per device: each rank's own
ops). The JAX package reads them from XLA's optimized HLO text, with
``parse_collectives`` and ``loop_trip_counts``; an eager PyTorch step has
no HLO and no loops to multiply (Python unrolls them), so those parsers
have no counterpart here: ``op_cost.OpCounter`` counts each collective
as it is dispatched.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM), at a power limit of
700.00 W (NVIDIA's data sheet; dense rates without sparsity). A card set
below 700 W runs slower under load than these peaks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

# NVIDIA H100 80GB HBM3, 700.00 W: bf16 dense tensor-core peak
PEAK_FLOPS = 989e12
# NVIDIA H100 80GB HBM3, 700.00 W: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700.00 W: the collective term's link, one
# 400 Gb/s NDR InfiniBand port per GPU (bytes/s). A 16 x 16 mesh spans 32
# eight-GPU nodes, so a "model"-axis collective crosses nodes; conservative,
# as the JAX package's one-link term was.
LINK_BW = 50e9
# NVIDIA H100 80GB HBM3, 700.00 W: NVLink 4 within a node, per direction
# (bytes/s); stated beside LINK_BW, not used by the roofline.
NVLINK_BW = 450e9


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_per_device: float
    useful_ratio: float

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def roofline(flops_per_device: float, bytes_per_device: float,
             collective_bytes: float,
             model_flops_per_device: float) -> Roofline:
    t_c = flops_per_device / PEAK_FLOPS
    t_m = bytes_per_device / HBM_BW
    t_x = collective_bytes / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    ratio = (model_flops_per_device / flops_per_device
             if flops_per_device else 0.0)
    return Roofline(
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes=collective_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        dominant=dominant,
        model_flops_per_device=model_flops_per_device,
        useful_ratio=ratio,
    )


def model_flops(cfg, shape, chips: int) -> float:
    """Analytic 'useful' FLOPs per device: 6*N_active*D for train,
    2*N_active*D for inference cells (fwd only)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.tokens
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.tokens
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    return mult * n_active * tokens / chips

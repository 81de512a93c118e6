"""repro_torch.core — CSB pruning and the CSB storage formats."""
from .csb_format import CSBMatrix, PaddedCSB, padded_csb_from_dense
from .pruning import (
    CSBSpec,
    csb_masks,
    csb_project,
    density,
    element_mask,
    from_blocks,
    kernel_sizes,
    pad_to_blocks,
    to_blocks,
)

__all__ = [
    "CSBMatrix", "PaddedCSB", "padded_csb_from_dense",
    "CSBSpec", "csb_masks", "csb_project", "density", "element_mask",
    "from_blocks", "kernel_sizes", "pad_to_blocks", "to_blocks",
]

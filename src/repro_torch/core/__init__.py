"""repro_torch.core — the paper's primary contribution: CSB pruning.

Public surface (the JAX package's):
  CSBSpec, csb_project, csb_masks, kernel_sizes    (projection, Alg. 1 inner)
  magnitude_project, bank_balanced_project, row_column_project  (baselines)
  CSBMatrix, PaddedCSB, padded_csb_from_dense      (formats, Fig. 3)
  ShardedCSB                                       (block-rows over a mesh)
  ADMMState, admm_init/penalty/update/finalize     (Eqns. 2-6)
  ProgressivePruner                                (Alg. 1 outer loop)
  CSBLinear, csb_specs_for_params                  (the model layer)
"""
from .pruning import (
    CSBSpec,
    bank_balanced_project,
    csb_masks,
    csb_project,
    density,
    element_mask,
    from_blocks,
    kernel_sizes,
    magnitude_project,
    pad_to_blocks,
    row_column_project,
    to_blocks,
)
from .csb_format import (
    CSBMatrix,
    PaddedCSB,
    ShardedCSB,
    padded_csb_from_dense,
)
from .admm import (
    ADMMState,
    admm_finalize,
    admm_init,
    admm_penalty,
    admm_update,
    residual_norm,
    spec_tree_map,
)
from .progressive import ProgressivePruner, ProgressiveState
from .csb_linear import CSBLinear, csb_specs_for_params

__all__ = [
    "CSBSpec", "csb_project", "csb_masks", "kernel_sizes", "density",
    "element_mask", "to_blocks", "from_blocks", "pad_to_blocks",
    "magnitude_project", "bank_balanced_project", "row_column_project",
    "CSBMatrix", "PaddedCSB", "ShardedCSB", "padded_csb_from_dense",
    "ADMMState", "admm_init", "admm_penalty", "admm_update",
    "admm_finalize", "residual_norm", "spec_tree_map",
    "ProgressivePruner", "ProgressiveState",
    "CSBLinear", "csb_specs_for_params",
]

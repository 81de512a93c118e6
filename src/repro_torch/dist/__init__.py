"""repro_torch.dist — the port of ``repro.dist``, as far as the sharded
CSB path needs it (ROADMAP item 21).

``api``           — ``Rules`` (the ``DeviceMesh`` model code shards
                    over), ``use_rules`` (nestable scope) and
                    ``current_rules``; the sharded CSB path runs
                    where the active mesh has a "model" axis larger than 1.
``csb_partition`` — the paper's PEGroup balancing (§5.2) across devices:
                    ``block_row_cycles`` (the engine's cost model),
                    ``plan_block_rows`` (greedy: LPT + ring donation, or
                    equal) and ``partition_padded``, which produces the
                    device-stacked ``ShardedCSB`` that kernel B3
                    (``kernels.csb_sharded``) runs.
``rules``         — ``csb_shard_specs``: the placement (``Shard(0)`` or
                    ``Replicate()``) of every leaf of a parameter tree.
``launch``        — ``spawn_ranks``: one process per rank of a mesh (the
                    port runs SPMD), joined into a process group.
``symm``          — symmetric device buffers, opened in every rank through
                    CUDA IPC: the memory kernel B3 stores its rows in.
``compress``      — int8 error-feedback gradient compression (the DP
                    all-reduce's wire stage; ``train.loop`` runs it).

JAX's ``shard``/``fit_spec`` and the dense ``param_specs``/
``activation_rules`` wait for ROADMAP items 20 and 22.
"""
from .api import Rules, current_rules, use_rules
from .csb_partition import (
    PartitionPlan,
    block_row_cycles,
    partition_padded,
    plan_block_rows,
)
from .rules import csb_shard_specs

__all__ = [
    "Rules", "current_rules", "use_rules", "csb_shard_specs",
    "PartitionPlan", "block_row_cycles", "partition_padded",
    "plan_block_rows",
]

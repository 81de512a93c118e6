"""repro_torch.dist — the port of ``repro.dist``: placements on a mesh.

Model code stays mesh-agnostic, as in JAX: it tags activations with
*logical names* via ``shard(x, name)``, and the launcher decides what (if
anything) each name means by installing :class:`Rules` with
:func:`use_rules`. The port states layouts with JAX's specs (``P``) and
applies them to ``torch.distributed.tensor.DTensor``s over a
``DeviceMesh``, one process a rank.

``api``           — ``P`` (a ``PartitionSpec``), ``to_placements`` (a
                    spec as DTensor placements, one per mesh dim) and
                    ``spec_of`` (back), ``Rules`` (logical name -> spec,
                    plus the mesh), ``use_rules`` (nestable scope),
                    ``current_rules``, ``fit_spec`` (divisibility guard),
                    ``shard`` / ``replicated`` (redistribute a DTensor;
                    the identity outside a mesh or for a plain tensor),
                    ``along`` / ``run_local`` / ``pad`` (work on each
                    rank's part, where DTensor's own op strategies are
                    wrong or missing) and ``place`` / ``whole`` /
                    ``like``.
``rules``         — ``ShardingPolicy`` and JAX's ``param_specs`` (on the
                    port's per-layer list, from JAX's stacked paths and
                    shapes), ``activation_rules``, ``batch_specs``,
                    ``cache_specs`` and ``csb_shard_specs`` (CSB weights
                    beside the dense placements).
``csb_partition`` — the paper's PEGroup balancing (§5.2) across devices:
                    ``block_row_cycles`` (the engine's cost model),
                    ``plan_block_rows`` (greedy: LPT + ring donation, or
                    equal) and ``partition_padded``, which produces the
                    device-stacked ``ShardedCSB`` that kernel B3
                    (``kernels.csb_sharded``) runs.
``launch``        — ``spawn_ranks``: one process per rank of a mesh (the
                    port runs SPMD), joined into a process group.
``symm``          — symmetric device buffers, opened in every rank through
                    CUDA IPC: the memory kernel B3 stores its rows in.
``compress``      — int8 error-feedback gradient compression (the DP
                    all-reduce's wire stage; ``train.loop`` runs it).

The logical names and the layouts they ask for (JAX's table; ``dp`` is
the data axis, or ("pod", "data") on a three-axis mesh; an entry whose
dim does not divide its axis drops):

=============  ==========================  ==============================
name           call site                   layout (guarded)
=============  ==========================  ==============================
residual       lm.layer_apply / embed      (B@dp, S[@model if SP], d)
logits         lm.lm_loss CE chunks        (B@dp, ck, [K,] V@model)
attn_q         layers.attn_qkv, _mla_qkv   (B@dp, S, H@model, D)
attn_kv        layers.attn_qkv, _mla_qkv   (B@dp, S, KV@model, D)
ssd_inner      layers.ssd_prefill / block  (B@dp, S, C), else replicated
moe_groups     layers.moe_apply            (G@dp, C, d)
moe_dispatch   layers.moe_apply            (G@dp, C, E@model, cap)
moe_experts    layers.moe_apply            (G@dp, E@model, cap, d)
kv_cache ...   serving on a mesh           (ROADMAP item 22)
=============  ==========================  ==============================
"""
from .api import (
    P, Rules, current_rules, fit_spec, replicated, shard, to_placements,
    use_rules,
)
from .csb_partition import (
    PartitionPlan,
    block_row_cycles,
    partition_padded,
    plan_block_rows,
)
from .rules import (
    ShardingPolicy, activation_rules, batch_specs, cache_specs,
    csb_shard_specs, param_specs,
)

__all__ = [
    "P", "Rules", "current_rules", "fit_spec", "replicated", "shard",
    "to_placements", "use_rules",
    "ShardingPolicy", "activation_rules", "batch_specs", "cache_specs",
    "csb_shard_specs", "param_specs",
    "PartitionPlan", "block_row_cycles", "partition_padded",
    "plan_block_rows",
]

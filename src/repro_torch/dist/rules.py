"""Placement-rule derivation: model/mesh/policy -> spec trees — the port
of ``repro.dist.rules``.

The JAX package owns every ``PartitionSpec`` of a run here, so train,
serve and the dry-run agree on one mapping; the port keeps the same
specs (:class:`~repro_torch.dist.api.P`), which ``api.to_placements``
turns into DTensor placements.

Conventions (megatron-style, guarded), JAX's:

* "model" axis — tensor parallelism. Column-parallel weights (qkv /
  gate / up / head) shard their output dim; row-parallel weights
  (``wo``/``w_down``/``w_out``) shard their input dim; embeddings shard
  the vocab dim; MoE expert tensors shard the expert dim.
* "data" (+ "pod") axes — batch/FSDP parallelism.
* Every assignment is divisibility-guarded against the mesh axis size,
  so reduced smoke configs simply replicate what cannot shard.

The JAX package stacks a decoder's layers on a leading L axis; the port
keeps ``params["layers"]`` as a list of per-layer dicts
(``repro_torch._tree``). A spec is derived from JAX's path and stacked
``(L, ...)`` shape, then its layer entry (always ``None``: nothing
splits the layers) is dropped for each per-layer tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from .api import P, Rules, axis_sizes, fit_spec, to_placements

PyTree = Any

# weights whose *input* dim is model-sharded (their matmul reduces over
# the sharded dim, putting the all-reduce after the projection)
_ROW_PARALLEL = {"wo", "w_down", "w_out"}
# per-expert MoE tensors: (L, E, in, out) — shard the expert axis
_EXPERT_WEIGHTS = {"w_gate", "w_up", "w_down"}


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Per-cell distribution knobs (derived in configs/registry.py).

    fsdp            — additionally shard weights over the data axes
                      (30B+ models; weights do not fit replicated).
    seq_shard       — sequence parallelism: residuals shard their seq
                      dim over "model" (off for MoE archs, see registry).
    shard_cache_seq — decode caches shard their time dim over "model".
    """

    fsdp: bool = False
    seq_shard: bool = False
    shard_cache_seq: bool = True


def _axis_size(mesh, ax) -> int:
    return axis_sizes(mesh).get(ax, 0)


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(ax for ax in mesh.mesh_dim_names if ax != "model")


def _dp_entry(mesh, batch: int | None = None):
    """The spec entry for a batch-like dim (None when it cannot shard)."""
    dp = _dp_axes(mesh)
    if not dp:
        return None
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[ax] for ax in dp)
    if batch is not None and batch % max(total, 1) != 0:
        return None
    return dp if len(dp) > 1 else dp[0]


def _leaf_spec(keys: tuple, shape: tuple, mesh, policy: ShardingPolicy) -> P:
    """JAX's spec of the leaf at path ``keys`` of (JAX's) ``shape``."""
    name = keys[-1] if keys else ""
    in_layers = bool(keys) and keys[0] == "layers"
    nd = len(shape)
    # effective weight rank ignores the stacked layer axis
    eff = nd - 1 if in_layers else nd

    entries: list[Any] = [None] * nd
    model_dim = None
    if eff >= 2:
        if name == "embed":
            model_dim = nd - 2                    # vocab dim
        elif name in _EXPERT_WEIGHTS and eff >= 3:
            model_dim = nd - 3                    # expert dim
        elif name in _ROW_PARALLEL:
            model_dim = nd - 2                    # input dim
        else:
            model_dim = nd - 1                    # output dim
    if model_dim is not None:
        msize = _axis_size(mesh, "model")
        if msize and shape[model_dim] % msize == 0:
            entries[model_dim] = "model"

    if policy.fsdp and eff >= 2:
        dsize = _axis_size(mesh, "data")
        cands = [d for d in range(nd)
                 if entries[d] is None and not (in_layers and d == 0)]
        cands.sort(key=lambda d: -shape[d])
        for d in cands:
            if dsize and shape[d] % dsize == 0:
                entries[d] = "data"
                break
    return P(*entries)


def _map_with_paths(fn, tree: PyTree, is_leaf=lambda x: False,
                    keys: tuple = (), stack: int = 0) -> PyTree:
    """``fn(keys, leaf, n_layers)`` on every leaf of the port's ``tree``,
    rebuilt in its structure: ``keys`` is JAX's path (a list under the
    top-level ``"layers"`` key is JAX's stacked layer axis, ``n_layers``
    its length, 0 elsewhere; any other list or tuple is a JAX sequence
    keyed by index)."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(keys, tree, stack)
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, is_leaf, keys + (str(k),), stack)
                for k, v in tree.items()}
    if isinstance(tree, list) and keys == ("layers",):
        return [_map_with_paths(fn, t, is_leaf, keys, len(tree))
                for t in tree]
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, is_leaf, keys + (str(i),),
                                          stack)
                          for i, v in enumerate(tree))
    return fn(keys, tree, stack)


def _port_spec(keys, leaf, n_layers, mesh, policy) -> P:
    """The spec of one of the port's tensors: JAX's spec of its stacked
    leaf, the layer entry dropped for a per-layer tensor."""
    shape = tuple(leaf.shape)
    if not n_layers:
        return _leaf_spec(keys, shape, mesh, policy)
    spec = _leaf_spec(keys, (n_layers,) + shape, mesh, policy)
    assert spec[0] is None, spec      # nothing splits the layer axis
    return P(*spec[1:])


def param_specs(cfg, params: PyTree, mesh, policy: ShardingPolicy) -> PyTree:
    """A :class:`P` per parameter tensor, in the port's tree (works on
    tensors or anything with a ``shape``)."""
    return _map_with_paths(
        lambda keys, leaf, n: _port_spec(keys, leaf, n, mesh, policy),
        params)


def activation_rules(cfg, mesh, policy: ShardingPolicy, *,
                     global_batch: int | None = None) -> Rules:
    """The logical-name table ``models/*`` routes through ``shard()``."""
    dp = _dp_entry(mesh, global_batch)
    seq = "model" if policy.seq_shard else None
    cache_seq = "model" if policy.shard_cache_seq else None
    if cfg.n_codebooks:
        logits = P(dp, None, None, "model")       # (B, ck, K, V)
    else:
        logits = P(dp, None, "model")             # (B, ck, V)
    table = {
        "residual": P(dp, seq, None),             # (B, S, d)
        "logits": logits,
        "kv_cache": P(dp, cache_seq, None, None),  # (B, T, KV, D)
        "mla_cache": P(dp, cache_seq, None),      # (B, T, kv_lora)
        # paged pools: pages data-parallel, page dims replicated (the
        # page table is replicated, so every replica can reach any page)
        "kv_pages": P(dp, None, None, None),      # (N, P, KV, D)
        "mla_pages": P(dp, None, None),           # (N, P, kv_lora)
        "attn_q": P(dp, None, "model", None),     # (B, S, H, D)
        "attn_kv": P(dp, None, "model", None),    # (B, S, KV, D)
        # SSD block streams (B, S, C): batch-parallel only (call sites
        # use fallback="replicate": no weight's split may reach the
        # conv shifts and the scan's cumulative sums along S)
        "ssd_inner": P(dp, None, None),
        "moe_groups": P(dp, None, None),          # (G, C, d)
        "moe_dispatch": P(dp, None, "model", None),  # (G, C, E, cap)
        "moe_experts": P(dp, "model", None, None),   # (G, E, cap, d)
    }
    return Rules(table, mesh=mesh)


def csb_shard_specs(obj: Any, mesh, *, axis: str = "model",
                    policy: ShardingPolicy | None = None) -> Any:
    """A tree of the structure of ``obj`` (nested dicts, lists and tuples;
    CSB containers are leaves) holding each leaf's placement on ``mesh``.

    A CSB container gets a container of the same kind whose arrays hold
    their placement along ``axis`` (the leading device axis split,
    ``Shard(0)``, or ``Replicate()``), with JAX's guards: a
    ``ShardedCSB`` shards only when its split width equals the axis size
    and exceeds 1; an unsplit ``PaddedCSB`` and a split of another width
    are replicated. A dense leaf gets the placements (one per mesh dim) of
    its ``param_specs`` spec under ``policy`` (default: no FSDP), as
    JAX's dense leaves fall through to ``_leaf_spec``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.csb_format import PaddedCSB, ShardedCSB

    policy = policy or ShardingPolicy()
    size = axis_sizes(mesh).get(axis, 1)

    def is_csb(x):
        return isinstance(x, (PaddedCSB, ShardedCSB))

    def one(keys, leaf, n_layers):
        if isinstance(leaf, ShardedCSB):
            lead = Shard(0) if size == leaf.n_dev > 1 else Replicate()
            return ShardedCSB(vals=lead, row_idx=lead, col_idx=lead, m=lead,
                              n=lead, shape=leaf.shape, grid=leaf.grid,
                              block=leaf.block, row_map=leaf.row_map,
                              rank=leaf.rank)
        if isinstance(leaf, PaddedCSB):
            rep = Replicate()
            return PaddedCSB(vals=rep, row_idx=rep, col_idx=rep, m=rep,
                             n=rep, shape=leaf.shape, grid=leaf.grid,
                             block=leaf.block)
        return to_placements(_port_spec(keys, leaf, n_layers, mesh, policy),
                             mesh)

    return _map_with_paths(one, obj, is_leaf=is_csb)


def batch_specs(cfg, kind: str, mesh, *,
                global_batch: int | None = None) -> dict[str, P]:
    """Input-batch specs per key for a train/prefill/decode step."""
    dp = _dp_entry(mesh, global_batch)
    tok = P(dp, None, None) if cfg.n_codebooks else P(dp, None)
    specs = {"tokens": tok}
    if kind == "train":
        specs["labels"] = tok
    if cfg.n_img_tokens:
        specs["img_embeds"] = P(dp, None, None)
    if kind == "decode":
        specs["pos"] = P(dp)          # (B,) per-slot positions
    return specs


def cache_specs(cfg, cache: PyTree, mesh,
                policy: ShardingPolicy, *, paged: bool = False) -> PyTree:
    """Decode-cache specs. The port's caches are stacked as JAX's are:
    leaves carry a leading layer axis (always replicated).

    ``paged=True`` describes the page-pool layout (``serve.paging``):
    time-keyed leaves are pools shaped (L, N_pages, page_size, ...)
    shared by every slot, sharded over the data axes on the *page* dim.
    State leaves (SSM/conv) keep their per-slot batch sharding in both
    modes. Divisibility guards apply as everywhere: a leaf that cannot
    carry its spec replicates."""
    dp = _dp_entry(mesh)
    cs = "model" if policy.shard_cache_seq else None

    def one(keys, leaf, _):
        name = keys[-1]
        nd = len(leaf.shape)
        if paged and name in ("k", "v"):        # (L, N, P, KV, D)
            spec = P(None, dp, None, None, None)
        elif paged and name in ("c_kv", "k_rope"):  # (L, N, P, d)
            spec = P(None, dp, None, None)
        elif name in ("k", "v"):          # (L, B, T, KV, D)
            spec = P(None, dp, cs, None, None)
        elif name in ("c_kv", "k_rope"):  # (L, B, T, lora/rd)
            spec = P(None, dp, cs, None)
        elif name == "ssm":               # (L, B, H, P, N)
            spec = P(None, dp, "model", None, None)
        else:                             # conv state etc: batch only
            spec = P(None, dp)
        fitted = fit_spec(spec, tuple(leaf.shape), mesh)
        return fitted if fitted is not None else P(*([None] * nd))

    return _map_with_paths(one, cache)

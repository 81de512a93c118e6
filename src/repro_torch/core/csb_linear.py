"""CSBLinear: a three-mode linear layer — the CSB technique as a model
feature. The port of ``repro.core.csb_linear``.

Modes:
  dense   — plain matmul (training before pruning starts)
  masked  — dense matmul against the CSB-projected weight (ADMM training:
            the projection is the Z-update; autograd sees ``w * mask``)
  csb     — the ``PaddedCSB`` format through ``kernels.ops.csb_matvec``
            (serving: the CUDA kernel on the card, its plain version on
            the CPU). When a mesh with a "model" axis larger than 1 is
            active (``dist.use_rules``), or passed as ``mesh``, the block
            grid is partitioned over that axis by cycle cost
            (``dist.csb_partition``) and run through kernel B3
            (``kernels.csb_sharded``); ``shard_for_mesh`` builds and
            caches this rank's shard.

`csb_specs_for_params` builds the spec tree that ADMM consumes,
selecting every >= min_dim 2-D/stacked-3-D projection of a model.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .csb_format import PaddedCSB, padded_csb_from_dense
from .pruning import CSBSpec, csb_masks, csb_project

PyTree = Any


class CSBLinear(nn.Module):
    """Stateful wrapper around one projection weight.

    ``weight`` is ``(out, in)``, or ``(in, out)`` with ``transposed``; an
    ``nn.Parameter`` stays a parameter of the module, any other tensor is
    held as a buffer."""

    def __init__(self, weight: torch.Tensor, spec: CSBSpec,
                 mode: str = "dense", transposed: bool = False,
                 packed: PaddedCSB | None = None):
        super().__init__()
        if mode not in ("dense", "masked", "csb"):
            raise ValueError(mode)
        if isinstance(weight, nn.Parameter):
            self.weight = weight
        else:
            self.register_buffer("weight", weight)
        self.spec = spec
        self.mode = mode
        self.transposed = transposed
        self._packed = packed
        # (n_dev, axis) -> (PartitionPlan, this rank's ShardedCSB): the
        # placement runs once per mesh width, not once per call; a new
        # module (freeze) starts with an empty cache
        self._shards: dict = {}

    def _w_oi(self) -> torch.Tensor:
        return self.weight.T if self.transposed else self.weight

    def freeze(self, pad_to: int = 8) -> "CSBLinear":
        """Project + pack for serving: a new module in csb mode, on the
        weight's device. The masks are those of the projected weight."""
        with torch.no_grad():
            w = csb_project(self._w_oi().detach(), self.spec)
            rm, cm = csb_masks(w, self.spec)
            packed = padded_csb_from_dense(
                w, self.spec.bm, self.spec.bn, pad_to=pad_to,
                row_mask=rm, col_mask=cm, device=w.device)
        return CSBLinear(self.weight, self.spec, "csb", self.transposed,
                         packed)

    def shard_for_mesh(self, mesh, axis: str = "model"):
        """(plan, ShardedCSB) for this weight on ``mesh[axis]``: cycle-
        balanced by the greedy planner, planned on the host by every rank
        alike (checked across the axis), cached per mesh width; the
        ShardedCSB holds this rank's shard alone, on the weight's
        device."""
        if self._packed is None:
            raise RuntimeError("call freeze() first")
        import torch.distributed as dist

        from repro_torch.dist.api import axis_sizes, require_mesh
        from repro_torch.dist.csb_partition import (
            check_plans, partition_padded,
        )
        n_dev = axis_sizes(require_mesh(mesh))[axis]
        key = (n_dev, axis)
        if key not in self._shards:
            group = mesh.get_group(axis)
            plan, s = partition_padded(self._packed.to("cpu"), n_dev)
            check_plans([s.row_map], group)
            self._shards[key] = (plan, s.local(dist.get_rank(group)).to(
                self._packed.vals.device))
        return self._shards[key]

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """``mesh`` (a ``DeviceMesh``) defaults to the active Rules' mesh;
        either runs the csb mode sharded where its "model" axis is larger
        than 1."""
        if self.mode == "dense":
            w = self._w_oi()
        elif self.mode == "masked":
            w = csb_project(self._w_oi(), self.spec)
        else:
            if self._packed is None:
                raise RuntimeError("call freeze() first")
            from repro_torch.dist.api import (
                active_model_mesh, axis_sizes, require_mesh,
            )
            if mesh is None or axis_sizes(require_mesh(mesh)).get(
                    "model", 1) <= 1:
                mesh = active_model_mesh()
            if mesh is not None:
                from repro_torch.kernels.csb_sharded import (
                    csb_matvec_sharded,
                )
                _, sharded = self.shard_for_mesh(mesh)
                return csb_matvec_sharded(sharded, x, mesh=mesh).to(x.dtype)
            # imported here: kernels.ops imports core.csb_format
            from repro_torch.kernels.ops import csb_matvec
            return csb_matvec(self._packed, x, device=x.device).to(x.dtype)
        return torch.einsum("...i,oi->...o", x, w.to(x.dtype))

    def compression(self) -> float:
        if self._packed is None:
            return 1.0
        return (self._packed.shape[0] * self._packed.shape[1]
                / max(self._packed.true_flops_per_mvm() // 2, 1))


def _key(k) -> str:
    """A path key as JAX's ``tree_map_with_path`` names it (``"[i]"`` for
    a sequence index)."""
    return k if isinstance(k, str) else f"[{k}]"


def csb_specs_for_params(params: PyTree, spec: CSBSpec,
                         min_dim: int = 64,
                         exclude: tuple[str, ...] = ("embed", "head",
                                                     "router")) -> PyTree:
    """Spec tree (CSBSpec | None per leaf, the structure of ``params``)
    for ADMM pruning of a model's projections — 2-D weights and stacked
    (L, in, out) layer weights.

    The JAX package stacks a decoder's layers on a leading axis under
    ``"layers"``; the port keeps a list of per-layer dicts there
    (``convert.lm_params_from_numpy``). A leaf inside that list is judged
    by the shape it has in JAX's stack, ``(len(list), *shape)``, so that
    both packages select the same weights."""

    def assign(keys, leaf, stack):
        if any(e in keys[-1] for e in exclude):
            return None
        shape = tuple(leaf.shape) if stack is None \
            else (stack, *leaf.shape)
        if len(shape) == 2 and min(shape) >= min_dim:
            return spec
        if len(shape) == 3 and min(shape[1:]) >= min_dim \
                and "layers" in keys:
            return spec
        return None

    def walk(t, keys, stack):
        if isinstance(t, dict):
            return {k: walk(v, keys + (_key(k),), stack)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            if keys and keys[-1] == "layers" and stack is None:
                return type(t)(walk(v, keys, len(t)) for v in t)
            return type(t)(walk(v, keys + (_key(i),), stack)
                           for i, v in enumerate(t))
        return None if t is None else assign(keys, t, stack)

    return walk(params, (), None)

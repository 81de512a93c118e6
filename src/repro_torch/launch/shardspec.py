"""Spec derivation for optimizer states, and spec trees as placements —
the port of ``repro.launch.shardspec``."""
from __future__ import annotations

from typing import Any

from repro_torch import _tree
from repro_torch.dist.api import NamedSharding, P
from repro_torch.dist.api import to_placements as _placements
from repro_torch.optim.optimizers import (
    Optimizer, OptState, adafactor_state_specs,
)

PyTree = Any


def opt_state_specs(opt: Optimizer, param_specs: PyTree) -> OptState:
    """A spec tree shaped like ``opt.init(params)``'s output, from the
    port's ``param_specs`` (``dist.rules.param_specs``). SGD's and
    AdamW's state mirrors the params; Adafactor keeps its state in JAX's
    stacked tree, so its specs are JAX's: a stacked leaf's spec gets the
    layer entry back (``optim.adafactor_state_specs`` does the rest)."""
    if opt.name == "sgd":
        inner = param_specs
    elif opt.name == "adamw":
        inner = {"m": param_specs, "v": param_specs}
    elif opt.name == "adafactor":
        def one(specs, stacked):
            if stacked and any(s != specs[0] for s in specs):
                raise ValueError(f"the layers of one leaf have different "
                                 f"specs: {specs}")
            return adafactor_state_specs(
                P(None, *specs[0]) if stacked else specs[0])

        inner = _tree.jax_structure(param_specs, one)
    else:  # pragma: no cover
        raise ValueError(opt.name)
    return OptState(inner=inner, step=P())


def _map_specs(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, P):
        return fn(tree)
    if tree is None:
        return None
    if _tree.is_state(tree):
        return OptState(inner=_map_specs(fn, tree.inner),
                        step=_map_specs(fn, tree.step))
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"spec tree node {type(tree).__name__}")


def to_placements(mesh, tree: PyTree) -> PyTree:
    """Each spec of ``tree`` as its DTensor placements on ``mesh``."""
    return _map_specs(lambda s: _placements(s, mesh), tree)


def to_named(mesh, tree: PyTree) -> PyTree:
    """Each spec of ``tree`` as a ``NamedSharding`` (mesh, placements):
    what ``train.checkpoint.restore``'s ``shardings`` takes."""
    return _map_specs(lambda s: NamedSharding(mesh, _placements(s, mesh)),
                      tree)

"""Carry parameters across from the JAX package.

``cell_params_from_numpy`` takes a cell's parameters as numpy arrays —
what ``np.asarray`` makes of the JAX package's weights — and returns the
port's parameters, so that both packages can run identical weights. A
dense weight or bias is an ndarray; a ``PaddedCSB`` is a mapping with
the keys ``vals``, ``row_idx``, ``col_idx``, ``m``, ``n``, ``shape``,
``grid`` and ``block``. ``lm_params_from_numpy`` does the same for a
decoder LM's parameter tree, and ``sharded_csb_from_numpy`` for a
``ShardedCSB`` (the same mapping plus ``row_map``). bf16 arrays (numpy's
``bfloat16`` extension type) keep their bits. This module imports no JAX.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.csb_format import PaddedCSB, ShardedCSB

_CSB_ARRAYS = ("vals", "row_idx", "col_idx", "m", "n")


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a copy the port owns
    return t.to(device)


def cell_params_from_numpy(params: Mapping, device=None) -> dict:
    """{name: ndarray | CSB mapping} -> {name: tensor | PaddedCSB} on
    ``device`` (``None`` means the card)."""
    dev = resolve_device(device)
    out = {}
    for name, w in params.items():
        if isinstance(w, Mapping):
            out[name] = PaddedCSB(
                **{k: _tensor(w[k], dev) for k in _CSB_ARRAYS},
                shape=tuple(int(v) for v in w["shape"]),
                grid=tuple(int(v) for v in w["grid"]),
                block=tuple(int(v) for v in w["block"]))
        else:
            out[name] = _tensor(w, dev)
    return out


def sharded_csb_from_numpy(leaves: Mapping, device=None) -> ShardedCSB:
    """The JAX package's ``ShardedCSB`` as a mapping of numpy leaves
    (``vals``, ``row_idx``, ``col_idx``, ``m``, ``n``, each with its
    leading device axis) and statics (``shape``, ``grid``, ``block``,
    ``row_map``) -> the port's, every device's shard on ``device``
    (``None`` means the card)."""
    dev = resolve_device(device)
    return ShardedCSB(
        **{k: _tensor(leaves[k], dev) for k in _CSB_ARRAYS},
        shape=tuple(int(v) for v in leaves["shape"]),
        grid=tuple(int(v) for v in leaves["grid"]),
        block=tuple(int(v) for v in leaves["block"]),
        row_map=tuple(tuple(int(r) for r in rows)
                      for rows in leaves["row_map"]))


def _tree(t, dev):
    if isinstance(t, Mapping):
        return {k: _tree(v, dev) for k, v in t.items()}
    return _tensor(t, dev)


def lm_params_from_numpy(params: Mapping, device=None) -> dict:
    """The JAX package's LM parameter tree (nested mappings of arrays, as
    ``jax.tree.map(np.asarray, params)`` gives it) -> the port's, on
    ``device`` (``None`` means the card). JAX stacks every layer's
    weights on a leading L axis under ``"layers"``; the port keeps a list
    of per-layer dicts, so each stacked leaf is cut along that axis."""
    dev = resolve_device(device)
    stacked = _tree(params["layers"], dev)

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return t[i].clone()      # its own storage, not a view of the stack

    n_layers = next(iter(_leaves(stacked))).shape[0]
    out = {k: _tree(v, dev) for k, v in params.items() if k != "layers"}
    out["layers"] = [layer(stacked, i) for i in range(n_layers)]
    return out


def _leaves(t):
    for v in t.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v

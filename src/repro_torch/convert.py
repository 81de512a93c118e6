"""Carry parameters across from the JAX package.

``cell_params_from_numpy`` takes a cell's parameters as numpy arrays —
what ``np.asarray`` makes of the JAX package's weights — and returns the
port's parameters, so that both packages can run identical weights. A
dense weight or bias is an ndarray; a ``PaddedCSB`` is a mapping with
the keys ``vals``, ``row_idx``, ``col_idx``, ``m``, ``n``, ``shape``,
``grid`` and ``block``. ``lm_params_from_numpy`` does the same for a
decoder LM's parameter tree, and ``sharded_csb_from_numpy`` for a
``ShardedCSB`` (the same mapping plus ``row_map``). bf16 arrays (numpy's
``bfloat16`` extension type) keep their bits. ``opt_state_from_numpy``
carries an optimizer's state across (sgd, adamw, adafactor), and
``params_to_numpy`` / ``opt_state_to_numpy`` go the other way, into
JAX's stacked layout. This module imports no JAX.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch import _tree
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


def _tensors(t, dev):
    if isinstance(t, Mapping):
        return {k: _tensors(v, dev) for k, v in t.items()}
    return _tensor(t, dev)


def lm_params_from_numpy(params: Mapping, device=None) -> dict:
    """The JAX package's LM parameter tree (nested mappings of arrays, as
    ``jax.tree.map(np.asarray, params)`` gives it) -> the port's, on
    ``device`` (``None`` means the card). JAX stacks every layer's
    weights on a leading L axis under ``"layers"``; the port keeps a list
    of per-layer dicts, so each stacked leaf is cut along that axis."""
    dev = resolve_device(device)
    stacked = _tensors(params["layers"], dev)

    def layer(t, i):
        if isinstance(t, dict):
            return {k: layer(v, i) for k, v in t.items()}
        return t[i].clone()      # its own storage, not a view of the stack

    n_layers = next(iter(_leaves(stacked))).shape[0]
    out = {k: _tensors(v, dev) for k, v in params.items() if k != "layers"}
    out["layers"] = [layer(stacked, i) for i in range(n_layers)]
    return out


def _leaves(t):
    for v in t.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _jax_leaves(t):
    """The leaves of a JAX tree held as numpy (nested mappings; an
    ``OptState`` as anything with ``inner`` and ``step``) in JAX's
    flatten order: keys sorted, ``inner`` before ``step``."""
    if t is None:
        return
    if hasattr(t, "inner") and hasattr(t, "step"):
        yield from _jax_leaves(t.inner)
        yield t.step
    elif isinstance(t, Mapping):
        for k in sorted(t):
            yield from _jax_leaves(t[k])
    else:
        yield t


def opt_state_from_numpy(state, like, device=None):
    """The JAX package's ``OptState`` of sgd, adamw or adafactor, its
    leaves as numpy (``jax.tree.map(np.asarray, state)``) -> the port's,
    in the structure of ``like`` (the port's ``opt.init(params)`` of the
    same optimizer), on ``device`` (``None`` means the card): the
    moments' stacked layers cut into the port's per-layer list,
    Adafactor's state kept stacked as the port keeps it."""
    dev = resolve_device(device)
    return _tree.unstack(like, [_tensor(a, dev)
                                for a in _jax_leaves(state)])


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _jax_layout(tree) -> dict:
    return _tree.jax_structure(
        tree, lambda ps, stacked: np.stack([_numpy(p) for p in ps])
        if stacked else _numpy(ps[0]))


def params_to_numpy(params) -> dict:
    """The port's parameter tree -> JAX's layout as numpy: each
    ``"layers"`` weight stacked on a leading L axis. bf16 comes out as
    its exact fp32 upcast (numpy has no bf16 without JAX's ``ml_dtypes``):
    ``jnp.asarray(a, jnp.bfloat16)`` gives JAX's array back bit for bit."""
    return _jax_layout(params)


def opt_state_to_numpy(state) -> dict:
    """The port's ``OptState`` -> {"inner": JAX's layout as numpy, "step":
    int32 0-d}: ``repro.optim.OptState(**)`` of it, leaves as jnp arrays,
    is JAX's state."""
    return {"inner": _jax_layout(state.inner), "step": _numpy(state.step)}

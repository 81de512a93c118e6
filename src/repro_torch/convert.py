"""Carry cell parameters across from the JAX package.

``cell_params_from_numpy`` takes a cell's parameters as numpy arrays —
what ``np.asarray`` makes of the JAX package's weights — and returns the
port's parameters, so that both packages can run identical weights. A
dense weight or bias is an ndarray; a ``PaddedCSB`` is a mapping with
the keys ``vals``, ``row_idx``, ``col_idx``, ``m``, ``n``, ``shape``,
``grid`` and ``block``. bf16 arrays (numpy's ``bfloat16`` extension
type) keep their bits. This module imports no JAX.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.csb_format import PaddedCSB

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

"""LSTMP, the LSTM with a recurrent projection (Sak et al.; the paper's
SR1), in plain PyTorch. The equations are written out from the cell's
definition in ``src/repro_torch/cells/cells.py::lstmp``, a frozen copy;
nothing of the program is imported.

    i = sigmoid(W_i x + U_i h + b_i)     f, o likewise
    g = tanh(W_g x + U_g h + b_g)
    c' = f * c + i * g
    m = o * tanh(c')
    h' = W_proj m                        the output, and the h carried on
"""
from __future__ import annotations

import torch

GATES = ("i", "f", "o", "g")
# the vector each matrix multiplies
MVM_INPUT = {**{f"W_{g}": "x" for g in GATES},
             **{f"U_{g}": "h" for g in GATES}, "W_proj": "m"}
# the products the cell adds at once, each group writing one vector
OUTPUT_GROUPS = tuple((f"W_{g}", f"U_{g}") for g in GATES) + (("W_proj",),)


def weight_shapes(layer: dict) -> dict:
    i, h, p = layer["n_input"], layer["n_hidden"], layer["proj"]
    shapes = {}
    for g in GATES:
        shapes[f"W_{g}"] = (h, i)
        shapes[f"U_{g}"] = (h, p)
        shapes[f"b_{g}"] = (h,)
    shapes["W_proj"] = (p, h)
    return shapes


def state_widths(layer: dict) -> dict:
    return {"h": layer["proj"], "c": layer["n_hidden"]}


def out_width(layer: dict) -> int:
    return layer["proj"]


def prepare(w: dict, as_operand) -> dict:
    """The four gates' matrices stacked, transposed for ``x @ W``; each
    passed through ``as_operand`` (the precision of the products)."""
    return {
        "W": as_operand(torch.cat([w[f"W_{g}"] for g in GATES]).T),
        "U": as_operand(torch.cat([w[f"U_{g}"] for g in GATES]).T),
        "b": torch.cat([w[f"b_{g}"] for g in GATES]),
        "P": as_operand(w["W_proj"].T),
    }


def step(p: dict, x: torch.Tensor, state: dict, mm):
    s = mm(x, p["W"]) + mm(state["h"], p["U"]) + p["b"]
    i, f, o, g = s.chunk(4, dim=-1)
    c = torch.sigmoid(f) * state["c"] + torch.sigmoid(i) * torch.tanh(g)
    m = torch.sigmoid(o) * torch.tanh(c)
    h = mm(m, p["P"])
    return h, {"h": h, "c": c}

"""The GRU (the paper's SR2) in plain PyTorch. The equations are written
out from the cell's definition in ``src/repro_torch/cells/cells.py::gru``,
a frozen copy; nothing of the program is imported.

    z = sigmoid(W_z x + U_z h + b_z)
    r = sigmoid(W_r x + U_r h + b_r)
    n = tanh(W_n x + U_n (r * h) + b_n)
    h' = z * h + (1 - z) * n            the output, and the h carried on
"""
from __future__ import annotations

import torch

MVM_INPUT = {"W_z": "x", "U_z": "h", "W_r": "x", "U_r": "h",
             "W_n": "x", "U_n": "rh"}
OUTPUT_GROUPS = (("W_z", "U_z"), ("W_r", "U_r"), ("W_n", "U_n"))


def weight_shapes(layer: dict) -> dict:
    i, h = layer["n_input"], layer["n_hidden"]
    shapes = {}
    for g in ("z", "r"):
        shapes[f"W_{g}"] = (h, i)
        shapes[f"U_{g}"] = (h, h)
        shapes[f"b_{g}"] = (h,)
    shapes.update({"W_n": (h, i), "U_n": (h, h), "b_n": (h,)})
    return shapes


def state_widths(layer: dict) -> dict:
    return {"h": layer["n_hidden"]}


def out_width(layer: dict) -> int:
    return layer["n_hidden"]


def prepare(w: dict, as_operand) -> dict:
    """z's and r's matrices stacked, transposed for ``x @ W``; each passed
    through ``as_operand`` (the precision of the products)."""
    return {
        "W": as_operand(torch.cat([w["W_z"], w["W_r"], w["W_n"]]).T),
        "U": as_operand(torch.cat([w["U_z"], w["U_r"]]).T),
        "Un": as_operand(w["U_n"].T),
        "b": torch.cat([w["b_z"], w["b_r"], w["b_n"]]),
    }


def step(p: dict, x: torch.Tensor, state: dict, mm):
    h = state["h"]
    wx = mm(x, p["W"]) + p["b"]
    wz, wr, wn = wx.chunk(3, dim=-1)
    uz, ur = mm(h, p["U"]).chunk(2, dim=-1)
    z = torch.sigmoid(wz + uz)
    r = torch.sigmoid(wr + ur)
    n = torch.tanh(wn + mm(r * h, p["Un"]))
    h = z * h + (1.0 - z) * n
    return h, {"h": h}

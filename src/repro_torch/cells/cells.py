"""The four RNN cell types the paper evaluates (Table 1): LSTM, GRU,
LSTMP (LSTM w/ recurrent projection, Sak et al.) and Li-GRU (Ravanelli
et al.), each expressed as a dataflow graph over the paper's primitives.
A copy of ``repro.cells.cells``, which builds graphs only.
"""
from __future__ import annotations

from .dataflow import CellGraph, GraphBuilder


def lstm(input_dim: int, hidden_dim: int) -> CellGraph:
    g = GraphBuilder("lstm", input_dim, hidden_dim)
    x, h, c = g.input("x"), g.input("h"), g.input("c")
    i = g.gate("i", x, h, "sigmoid", input_dim, hidden_dim)
    f = g.gate("f", x, h, "sigmoid", input_dim, hidden_dim)
    o = g.gate("o", x, h, "sigmoid", input_dim, hidden_dim)
    gg = g.gate("g", x, h, "tanh", input_dim, hidden_dim)
    c_new = g.add(g.mul(f, c), g.mul(i, gg))
    h_new = g.mul(o, g.tanh(c_new))
    return g.build(("h", "c"), {"h": h_new, "c": c_new}, h_new)


def gru(input_dim: int, hidden_dim: int) -> CellGraph:
    g = GraphBuilder("gru", input_dim, hidden_dim)
    x, h = g.input("x"), g.input("h")
    z = g.gate("z", x, h, "sigmoid", input_dim, hidden_dim)
    r = g.gate("r", x, h, "sigmoid", input_dim, hidden_dim)
    rh = g.mul(r, h)
    wx = g.mvm("W_n", x, hidden_dim, input_dim)
    un = g.mvm("U_n", rh, hidden_dim, hidden_dim)
    n = g.tanh(g.bias("b_n", g.add(wx, un), hidden_dim))
    h_new = g.add(g.mul(z, h), g.mul(g.one_minus(z), n))
    return g.build(("h",), {"h": h_new}, h_new)


def lstmp(input_dim: int, hidden_dim: int, proj_dim: int) -> CellGraph:
    """LSTM with a recurrent projection layer (paper benchmark SR1)."""
    g = GraphBuilder("lstmp", input_dim, hidden_dim)
    x, h, c = g.input("x"), g.input("h"), g.input("c")  # h: (proj_dim,)
    i = g.gate("i", x, h, "sigmoid", input_dim, proj_dim, hidden_dim)
    f = g.gate("f", x, h, "sigmoid", input_dim, proj_dim, hidden_dim)
    o = g.gate("o", x, h, "sigmoid", input_dim, proj_dim, hidden_dim)
    gg = g.gate("g", x, h, "tanh", input_dim, proj_dim, hidden_dim)
    c_new = g.add(g.mul(f, c), g.mul(i, gg))
    m = g.mul(o, g.tanh(c_new))
    h_new = g.mvm("W_proj", m, proj_dim, hidden_dim)
    return g.build(("h", "c"), {"h": h_new, "c": c_new}, h_new)


def ligru(input_dim: int, hidden_dim: int) -> CellGraph:
    """Light GRU: no reset gate, ReLU candidate (batch-norm folded)."""
    g = GraphBuilder("ligru", input_dim, hidden_dim)
    x, h = g.input("x"), g.input("h")
    z = g.gate("z", x, h, "sigmoid", input_dim, hidden_dim)
    wx = g.mvm("W_n", x, hidden_dim, input_dim)
    un = g.mvm("U_n", h, hidden_dim, hidden_dim)
    n = g.relu(g.bias("b_n", g.add(wx, un), hidden_dim))
    h_new = g.add(g.mul(z, h), g.mul(g.one_minus(z), n))
    return g.build(("h",), {"h": h_new}, h_new)


CELL_BUILDERS = {
    "lstm": lstm,
    "gru": gru,
    "lstmp": lstmp,
    "ligru": ligru,
}


def make_cell(kind: str, input_dim: int, hidden_dim: int,
              proj_dim: int | None = None) -> CellGraph:
    if kind == "lstmp":
        return lstmp(input_dim, hidden_dim, proj_dim or hidden_dim // 2)
    return CELL_BUILDERS[kind](input_dim, hidden_dim)

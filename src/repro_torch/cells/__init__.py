"""repro_torch.cells — the paper's RNN cell zoo as programmable dataflow graphs."""
from .dataflow import (
    CellGraph,
    GraphBuilder,
    Op,
    cell_apply,
    init_params,
    init_state,
    rnn_scan,
)
from .cells import CELL_BUILDERS, gru, ligru, lstm, lstmp, make_cell

__all__ = [
    "CellGraph", "GraphBuilder", "Op", "cell_apply", "init_params",
    "init_state", "rnn_scan",
    "CELL_BUILDERS", "lstm", "gru", "lstmp", "ligru", "make_cell",
]

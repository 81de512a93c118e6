"""Programmable RNN dataflow (paper §4.2 / §5.1) — the port of
``repro.cells.dataflow``.

An RNN cell is a DAG of the paper's arithmetic primitives — MVM
(CSB-Engine), element-wise mul/add, sigmoid, tanh (+ relu and 1-x, needed
by Li-GRU/GRU). ``Op``, ``CellGraph`` and ``GraphBuilder`` are copies of
the JAX package's (plain Python); ``cell_apply`` interprets the DAG on
tensors, so every cell type runs on one code path. MVM weights may be
dense tensors or ``PaddedCSB`` matrices, which go through
``kernels.ops.csb_matvec`` (the CUDA kernel on the card), or, under a
``use_rules`` mesh with a "model" axis larger than 1, ``ShardedCSB``
matrices, which go through kernel B3 (``kernels.csb_sharded``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.csb_format import PaddedCSB, ShardedCSB
from repro_torch.kernels.ops import csb_matvec

KINDS = ("input", "mvm", "bias", "add", "mul",
         "sigmoid", "tanh", "relu", "one_minus")


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    kind: str
    inputs: tuple[str, ...] = ()
    shape: tuple[int, int] | None = None  # (out, in) for mvm; (out,) bias

    def __post_init__(self):
        assert self.kind in KINDS, self.kind


@dataclasses.dataclass(frozen=True)
class CellGraph:
    """A cell = DAG + state protocol."""

    name: str
    input_dim: int
    hidden_dim: int
    ops: tuple[Op, ...]
    state_vars: tuple[str, ...]          # e.g. ("h", "c") — fed as inputs
    next_state: dict[str, str]           # state var -> producing op name
    output: str                          # op name of the cell output h_t

    def op(self, name: str) -> Op:
        for o in self.ops:
            if o.name == name:
                return o
        raise KeyError(name)

    @property
    def mvm_ops(self) -> tuple[Op, ...]:
        return tuple(o for o in self.ops if o.kind == "mvm")

    def weight_shapes(self) -> dict[str, tuple[int, ...]]:
        out = {}
        for o in self.ops:
            if o.kind in ("mvm", "bias"):
                out[o.name] = o.shape
        return out

    def param_count(self) -> int:
        return int(sum(np.prod(s) for s in self.weight_shapes().values()))


class GraphBuilder:
    """Tiny DSL for cell graphs."""

    def __init__(self, name: str, input_dim: int, hidden_dim: int):
        self.name = name
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self._ops: list[Op] = []
        self._n = 0

    def _emit(self, kind, inputs=(), shape=None, name=None) -> str:
        name = name or f"{kind}{self._n}"
        self._n += 1
        self._ops.append(Op(name, kind, tuple(inputs), shape))
        return name

    def input(self, name: str) -> str:
        return self._emit("input", name=name)

    def mvm(self, w_name: str, x: str, out_dim: int, in_dim: int) -> str:
        return self._emit("mvm", (x,), (out_dim, in_dim), name=w_name)

    def bias(self, b_name: str, x: str, dim: int) -> str:
        return self._emit("bias", (x,), (dim,), name=b_name)

    def add(self, a: str, b: str) -> str:
        return self._emit("add", (a, b))

    def mul(self, a: str, b: str) -> str:
        return self._emit("mul", (a, b))

    def sigmoid(self, a: str) -> str:
        return self._emit("sigmoid", (a,))

    def tanh(self, a: str) -> str:
        return self._emit("tanh", (a,))

    def relu(self, a: str) -> str:
        return self._emit("relu", (a,))

    def one_minus(self, a: str) -> str:
        return self._emit("one_minus", (a,))

    def gate(self, prefix: str, x: str, h: str, act: str,
             in_dim: int, hid: int, out_dim: int | None = None) -> str:
        """act(W@x + U@h + b) — the standard RNN gate idiom."""
        out_dim = out_dim or hid
        wx = self.mvm(f"W_{prefix}", x, out_dim, in_dim)
        uh = self.mvm(f"U_{prefix}", h, out_dim, hid)
        s = self.add(wx, uh)
        s = self.bias(f"b_{prefix}", s, out_dim)
        return getattr(self, act)(s)

    def build(self, state_vars, next_state, output) -> CellGraph:
        return CellGraph(
            name=self.name, input_dim=self.input_dim,
            hidden_dim=self.hidden_dim, ops=tuple(self._ops),
            state_vars=tuple(state_vars), next_state=dict(next_state),
            output=output,
        )


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def _apply_mvm(w, x: torch.Tensor) -> torch.Tensor:
    if isinstance(w, ShardedCSB):
        from repro_torch.dist.api import active_model_mesh
        from repro_torch.kernels.csb_sharded import csb_matvec_sharded
        mesh = active_model_mesh()
        if mesh is None:
            raise ValueError(
                "ShardedCSB cell weight needs an active use_rules scope "
                "whose mesh has a non-trivial 'model' axis")
        return csb_matvec_sharded(w, x, mesh=mesh).to(x.dtype)
    if isinstance(w, PaddedCSB):
        return csb_matvec(w, x, device=x.device).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype).T)


_UNARY = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "one_minus": lambda a: 1.0 - a,
}


def cell_apply(
    graph: CellGraph,
    params: dict,
    x: torch.Tensor,
    state: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One cell step. x: (..., input_dim); state vars: (..., hidden_dim)."""
    env: dict[str, torch.Tensor] = {"x": x, **state}
    for op in graph.ops:
        if op.kind == "input":
            assert op.name in env, f"missing input {op.name}"
            continue
        a = env[op.inputs[0]]
        if op.kind == "mvm":
            env[op.name] = _apply_mvm(params[op.name], a)
        elif op.kind == "bias":
            env[op.name] = a + params[op.name].to(a.dtype)
        elif op.kind == "add":
            env[op.name] = a + env[op.inputs[1]]
        elif op.kind == "mul":
            env[op.name] = a * env[op.inputs[1]]
        else:
            env[op.name] = _UNARY[op.kind](a)
    new_state = {k: env[v] for k, v in graph.next_state.items()}
    return env[graph.output], new_state


def init_state(graph: CellGraph, batch_shape: tuple[int, ...],
               dtype: torch.dtype = torch.float32,
               device=None) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dims = {"h": graph.hidden_dim, "c": graph.hidden_dim}
    # LSTMP: h is the projected (output) dim
    out_op = graph.op(graph.next_state.get("h", graph.output))
    if out_op.kind == "mvm" and out_op.shape is not None:
        dims["h"] = out_op.shape[0]
    return {
        k: torch.zeros((*batch_shape, dims.get(k, graph.hidden_dim)),
                       dtype=dtype, device=dev)
        for k in graph.state_vars
    }


def init_params(graph: CellGraph, generator: torch.Generator | None = None,
                device=None, dtype: torch.dtype = torch.float32,
                scale: float | None = None) -> dict[str, torch.Tensor]:
    """Normal(0, scale) weights (default ``1/sqrt(in)``) and zero biases.

    The numbers come from ``generator`` (a CPU generator; ``None`` uses
    PyTorch's global one) and are then moved to ``device``, so a seed
    gives the same weights on every device. They differ from the JAX
    package's, whose PRNG has no PyTorch counterpart."""
    dev = resolve_device(device)
    params = {}
    for name, shape in graph.weight_shapes().items():
        if len(shape) == 1:
            params[name] = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            s = scale or (1.0 / np.sqrt(shape[1]))
            w = torch.randn(shape, generator=generator) * s
            params[name] = w.to(device=dev, dtype=dtype)
    return params


def rnn_scan(
    graph: CellGraph,
    params: dict,
    xs: torch.Tensor,                   # (T, ..., input_dim)
    state: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Run the cell over a time-major sequence; returns (ys, final state)."""
    if state is None:
        state = init_state(graph, tuple(xs.shape[1:-1]), xs.dtype,
                           device=xs.device)
    ys = []
    for x_t in xs:
        y, state = cell_apply(graph, params, x_t, state)
        ys.append(y)
    return torch.stack(ys), state

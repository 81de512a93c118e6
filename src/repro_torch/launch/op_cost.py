"""Per-device cost of one eager step, counted op by op as it dispatches:
the port of ``repro.launch.hlo_cost.analyze``.

The JAX package re-derives FLOPs, HBM bytes and collective bytes from a
compiled program's optimized HLO text, multiplying while-loop bodies by
their trip counts. A PyTorch step runs eagerly: :class:`OpCounter` is a
``TorchDispatchMode`` that sees every aten op the step dispatches and
counts it under ``hlo_cost``'s accounting model:

  - matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
    ``dot``; ``einsum`` and ``matmul`` lower to them):
    2 * prod(output dims) * contracted size (``addmm``/``baddbmm`` add
    one per output element for the sum)
  - elementwise arithmetic/transcendental: 1 flop per output element
  - reductions: 1 flop per *input* element (softmax: 5, its max, the
    subtraction, the exp, the sum and the division)
  - bytes: per op, operand bytes + output bytes. Eager fuses nothing, so
    this is what the eager step moves. Views and metadata ops count zero
    (``hlo_cost``'s ``bitcast``/``tuple``); gathers and indexing read
    what they produce (2 x output bytes), scatters and index writes
    2 x the update; ``copy_`` reads its source and writes its
    destination; ``fill_``/``zero_`` write their output
  - collectives: by op, under JAX's names, with their operand bytes (an
    all-gather's input), whichever registration runs them: the fake
    backend, NCCL, or ``dist.gloo_cuda``'s synchronous ones (the mode
    sees the functional op before its kernel runs)
  - no loop trip counts: Python loops are unrolled, each call counted.

Every count is per device. A ``DTensor`` op is never counted as such
(``torch.utils.flop_counter.FlopCounterMode`` counts it at its global
shape): the mode hands it on to DTensor, and counts the local ops on
this rank's parts that DTensor then runs, its collectives included.
DTensor also runs each new op once on fake tensors of the *global*
shapes, to learn its output's shape (sharding propagation); those runs
are not the step's work, and the counter does not see them.

:class:`OpCounter` also tracks the live storage the step allocates
(``memory()``): the bytes its arguments hold, the peak of everything
live during the step, and the outputs, in the JAX dry run's
``memory_analysis`` terms. Under ``FakeTensorMode`` nothing is
allocated and the count is the estimate; on the card it is the eager
step's own.

``hlo_cost.f32_convert_overhead`` and the dry run's
``peak_bytes_tpu_estimate`` correct for buffers XLA:CPU allocates and a
TPU build would not; an eager step on the card allocates what it
allocates, so they have no counterpart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# collective op (namespace.name) -> (JAX's name, index of its operand)
_COLLECTIVES = {}
for _ns in ("_c10d_functional", "_c10d_functional_autograd"):
    _COLLECTIVES.update({
        f"{_ns}.all_gather_into_tensor": ("all-gather", 0),
        f"{_ns}.all_gather_into_tensor_coalesced": ("all-gather", 0),
        f"{_ns}.all_gather_into_tensor_out": ("all-gather", 0),
        f"{_ns}.all_reduce": ("all-reduce", 0),
        f"{_ns}.all_reduce_": ("all-reduce", 0),
        f"{_ns}.all_reduce_coalesced": ("all-reduce", 0),
        f"{_ns}.all_reduce_coalesced_": ("all-reduce", 0),
        f"{_ns}.reduce_scatter_tensor": ("reduce-scatter", 0),
        f"{_ns}.reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
        f"{_ns}.all_to_all_single": ("all-to-all", 0),
        f"{_ns}.broadcast": ("broadcast", 0),
        f"{_ns}.broadcast_": ("broadcast", 0),
    })
_COLLECTIVES.update({
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_coalesced_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.recv_": ("collective-permute", 0),
    "c10d.broadcast_": ("broadcast", 0),
})

# the wait of an async collective: its work was counted at the start
_WAITS = {"_c10d_functional.wait_tensor", "c10d.wait"}

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp",
    "exp2", "tanh", "log", "log2", "rsqrt", "sqrt", "pow", "neg", "abs",
    "floor", "ceil", "sign", "cos", "sin", "sigmoid", "expm1", "log1p",
    "atan2", "remainder", "fmod", "reciprocal", "erf", "where", "clamp",
    "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "masked_fill", "silu", "gelu", "softplus", "relu", "addcmul",
    "addcdiv", "lerp", "square", "mish",
    "tanh_backward", "sigmoid_backward", "silu_backward",
    "gelu_backward", "softplus_backward", "threshold_backward",
}
_SOFTMAX = {"_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "prod", "var", "std", "var_mean", "std_mean",
               "logsumexp", "cumsum", "cumprod", "norm",
               "linalg_vector_norm", "any", "all"}
# no data moved: allocation without a write, or metadata
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "is_same_size"}
# write their output and read nothing
_WRITES = {"fill_", "zero_", "zeros", "ones", "full", "zeros_like",
           "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
           "scalar_tensor", "arange", "randn", "rand", "normal_",
           "uniform_"}
# read what they produce (JAX's gather/dynamic-slice: 2 x output bytes)
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "masked_select"}
# write an update into a tensor (2 x the update's bytes); the update's
# argument index
_SCATTERS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "index_add": 3, "index_add_": 3,
             "index_copy": 3, "index_copy_": 3, "slice_scatter": 1,
             "select_scatter": 1, "masked_scatter": 2,
             "masked_scatter_": 2, "embedding_dense_backward": 0}


@dataclasses.dataclass
class Cost:
    """``hlo_cost.Cost``'s fields, plus ``dot_flops``: the FLOPs of the
    matrix products alone (HLO's ``dot``)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict | None = None
    coll_count: dict | None = None
    dot_flops: float = 0.0

    def __post_init__(self):
        self.coll_bytes = self.coll_bytes or {}
        self.coll_count = self.coll_count or {}

    @property
    def collective_total(self) -> float:
        return sum(self.coll_bytes.values())


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args, out) -> float:
    """2 * out elements * contracted size of a matrix product (None
    where ``name`` is none)."""
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "mv":
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    if name == "addmv":
        return 2.0 * out.numel() * args[1].shape[-1]
    return None


def _op_flops(name: str, args, outs) -> tuple[float, float]:
    """(all FLOPs, matrix-product FLOPs) of one op."""
    out = outs[0] if outs else None
    if out is not None:
        dot = _dot_flops(name, args, out)
        if dot is not None:
            extra = out.numel() if name in ("addmm", "baddbmm",
                                            "addmv") else 0
            return dot + extra, dot
    base = name.rstrip("_")
    if base in _ELEMENTWISE:
        return float(sum(o.numel() for o in outs)), 0.0
    if name in _SOFTMAX:
        return 5.0 * out.numel(), 0.0
    if base in _REDUCTIONS:
        first = next(_tensors(args), None)
        return float(first.numel() if first is not None else 0), 0.0
    return 0.0, 0.0


_PAUSE = threading.local()


def _paused() -> bool:
    return getattr(_PAUSE, "depth", 0) > 0


@contextlib.contextmanager
def _shape_propagation_unseen():
    """Hide DTensor's sharding propagation from the counter: it runs each
    new op on fake tensors of the global shapes to learn the output's
    shape, work that is not the step's. Raises where this torch has no
    such method (the counts would then hold global ops)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in ("_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta")
             if n in ShardingPropagator.__dict__]
    if not names:
        raise RuntimeError("DTensor's ShardingPropagator has no "
                           "_propagate_tensor_meta: cannot tell its "
                           "shape runs from the step's ops")
    saved = {n: ShardingPropagator.__dict__[n] for n in names}

    def hidden(fn):
        def run(self, *args, **kwargs):
            _PAUSE.depth = getattr(_PAUSE, "depth", 0) + 1
            try:
                return fn(self, *args, **kwargs)
            finally:
                _PAUSE.depth -= 1
        return run

    for n, fn in saved.items():
        setattr(ShardingPropagator, n, hidden(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


class OpCounter(TorchDispatchMode):
    """Counts the ops a step dispatches, per device (module docstring).

    >>> with OpCounter() as c:
    ...     c.hold(args)          # the step's arguments, live throughout
    ...     out = step(*args)
    ...     c.outputs(out)
    >>> c.cost.flops, c.memory()["peak_bytes_per_device"]
    """

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.ops = 0
        self._live: dict[int, int] = {}
        self._live_bytes = 0
        self.peak_bytes = 0
        self._args: set[int] = set()
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_shape_propagation_unseen())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    # -- live storage --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int | None:
        """Count ``t``'s storage as live until it is freed; its key."""
        if type(t).__name__ == "DTensor":
            t = t._local_tensor
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return None
        key = st._cdata
        if key in self._live:
            return key
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self._live_bytes -= n

    def hold(self, tree) -> int:
        """Count the step's arguments (any nest of dicts, lists and
        tensors; DTensors by their local part) as live; returns their
        bytes."""
        for t in _tensors(tree):
            key = self._track(t)
            if key is not None and key not in self._args:
                self._args.add(key)
                self.argument_bytes += self._live[key]
        return self.argument_bytes

    def outputs(self, tree) -> None:
        """Record the step's outputs: their bytes, and those that are an
        argument's storage (updated in place) as aliased."""
        seen = set()
        for t in _tensors(tree):
            key = self._track(t)
            if key is None or key in seen:
                continue
            seen.add(key)
            n = self._live[key]
            self.output_bytes += n
            if key in self._args:
                self.alias_bytes += n

    def memory(self) -> dict:
        """The dry run's ``memory`` block: argument, output, temp and
        alias bytes, with peak = argument + output + temp - alias."""
        temp = (self.peak_bytes - self.argument_bytes - self.output_bytes
                + self.alias_bytes)
        return {"argument_bytes": int(self.argument_bytes),
                "output_bytes": int(self.output_bytes),
                "temp_bytes": int(temp),
                "alias_bytes": int(self.alias_bytes),
                "peak_bytes_per_device": int(self.peak_bytes)}

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            # DTensor runs this op as local ops on this rank's parts (and
            # its collectives): those are what this device does
            return NotImplemented
        out = func(*args, **kwargs)
        if not _paused():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        full = f"{ns}.{name}"
        outs = list(_tensors(out))
        c = self.cost
        if full in _WAITS:
            return
        if full in _COLLECTIVES:
            kind, idx = _COLLECTIVES[full]
            operand = args[idx] if idx < len(args) else ()
            size = sum(_nbytes(t) for t in _tensors(operand))
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0) + size
            c.coll_count[kind] = c.coll_count.get(kind, 0) + 1
            c.bytes += size + sum(_nbytes(t) for t in outs)
            for t in outs:
                self._track(t)
            return
        if ns == "prim" or name in _NO_BYTES or func.is_view:
            return
        ins = list(_tensors((args, kwargs)))
        f, dot = _op_flops(name, args, outs)
        c.flops += f
        c.dot_flops += dot
        if name in _GATHERS:
            c.bytes += 2 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTERS:
            i = _SCATTERS[name]
            upd = args[i] if i < len(args) else None
            c.bytes += 2 * sum(_nbytes(t) for t in _tensors(upd))
        elif name == "copy_":
            c.bytes += _nbytes(args[0]) + _nbytes(args[1])
        elif name in _WRITES:
            c.bytes += sum(_nbytes(t) for t in outs)
        else:
            aliased = _aliases(outs, ins)
            if aliased and not name.endswith("_"):
                return  # a view by another name (_unsafe_view, ...)
            c.bytes += (sum(_nbytes(t) for t in ins)
                        + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)


def _aliases(outs, ins) -> bool:
    """Whether every output shares storage with an input."""
    if not outs:
        return False
    keys = set()
    for t in ins:
        try:
            keys.add(t.untyped_storage()._cdata)
        except (NotImplementedError, RuntimeError):
            pass
    try:
        return all(o.untyped_storage()._cdata in keys for o in outs)
    except (NotImplementedError, RuntimeError):
        return False


def count(step, *args, **kwargs) -> tuple:
    """``(result, OpCounter)`` of ``step(*args, **kwargs)`` run under a
    counter, with ``args`` held as the step's arguments and the result as
    its outputs."""
    with OpCounter() as c:
        c.hold((args, kwargs))
        out = step(*args, **kwargs)
        c.outputs(out)
    return out, c

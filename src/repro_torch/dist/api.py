"""Context-scoped placement rules — the port of ``repro.dist.api``.

``shard(x, "residual")`` is the single call model code uses to pin a
logical activation to the mesh. Which spec (if any) that name maps to is
decided by the active :class:`Rules` installed with :func:`use_rules`, so
the same forward function serves the one-device path and a mesh
unchanged.

The JAX package states a layout as a ``PartitionSpec`` (one entry per
tensor dim: ``None``, a mesh axis name, or a tuple of names) and applies
it with ``with_sharding_constraint``. The port keeps the spec, as
:class:`P`, and applies it to a ``torch.distributed.tensor.DTensor``:
:func:`to_placements` turns a spec into DTensor placements, one per mesh
dim (``Shard(d)`` where tensor dim d names that mesh axis,
``Replicate()`` otherwise), and :func:`shard` redistributes. The values
do not change, only where they live.

Outside a ``use_rules`` scope, inside one whose mesh is trivial, for an
unknown name, for a plain (non-DTensor) tensor, or when no dim fits,
``shard`` is the identity, returning its argument untouched. Dims that do
not divide their mesh axis, and axes the mesh lacks, drop out of a spec
(:func:`fit_spec`), so reduced configs never ask for an uneven split.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Mapping, NamedTuple

import torch


class P(tuple):
    """A partition spec, the port of ``jax.sharding.PartitionSpec``: a
    tuple of entries, one per tensor dim (missing trailing entries mean
    ``None``), each ``None``, a mesh axis name, or a tuple of names (that
    dim split over several mesh axes, major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor())


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or any object with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d's entry names that mesh axis and the
    axis is larger than 1, ``Replicate()`` otherwise (a split over one
    device is no split, and DTensor refuses to reshape a dim "split"
    over one). A tuple entry must name its axes in the mesh's order
    (JAX's major-to-minor split, which DTensor's placements give in that
    order); an axis the mesh lacks, or one named twice, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {spec!r} names axis {ax!r}, not in "
                                 f"the mesh's {names}")
            if ax in where:
                raise ValueError(f"spec {spec!r} names axis {ax!r} twice")
            where[ax] = d
            idx.append(names.index(ax))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} must list its axes in "
                             f"the mesh's order {names}")
    sizes = axis_sizes(mesh)
    return tuple(Shard(where[ax]) if ax in where and sizes[ax] > 1
                 else Replicate() for ax in names)


def spec_of(placements, ndim: int, mesh) -> P:
    """The spec that :func:`to_placements` turns into ``placements`` (a
    tensor of ``ndim`` dims); a partial placement raises."""
    from torch.distributed.tensor import Replicate, Shard

    entries: list[list] = [[] for _ in range(ndim)]
    for ax, pl in zip(mesh.mesh_dim_names, placements):
        if isinstance(pl, Shard):
            entries[pl.dim % ndim].append(ax)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"no spec for placement {pl!r}")
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries))


class NamedSharding(NamedTuple):
    """A mesh and the placements of a tensor on it (the port's
    ``jax.sharding.NamedSharding``)."""

    mesh: Any
    placements: tuple


def place(x, sharding: NamedSharding):
    """``x`` (a tensor that every rank holds whole and alike) as a
    DTensor on ``sharding``: each rank keeps its own part, no
    communication. A part that is a view of a larger tensor is copied,
    so that ``x``'s memory goes once ``x`` does."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    out = distribute_tensor(x, sharding.mesh, sharding.placements,
                            src_data_rank=None)
    loc = out.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        out = DTensor.from_local(loc.clone(), sharding.mesh,
                                 sharding.placements, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def place_tree(tree, shardings):
    """Place, in place, every tensor of ``tree`` (nested dicts and lists)
    on ``shardings`` (a tree of its structure holding
    ``NamedSharding``s): each is replaced by its DTensor in turn, so the
    whole tensor can go as soon as it is placed. Returns ``tree``."""
    for k in (list(tree) if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            place_tree(tree[k], shardings[k])
        else:
            tree[k] = place(tree[k], shardings[k])
    return tree


def whole(x):
    """The whole tensor on every rank: a DTensor's ``full_tensor()``
    (a collective: every rank must call it), any other tensor itself."""
    return x.full_tensor() if is_dtensor(x) else x


def reduced(x):
    """The DTensor ``x`` with its partial sums reduced (each ``Partial``
    placement made ``Replicate``; its splits kept), the values unchanged;
    any other tensor itself. A partial sum that several ops consume would
    otherwise be reduced again by each of them."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, _whole_dims(x, set()))


def like(x, ref):
    """``x`` (whole, alike on every rank) placed as ``ref`` is, when
    ``ref`` is a DTensor; ``x`` itself otherwise."""
    if not is_dtensor(ref):
        return x
    return place(x, NamedSharding(ref.device_mesh, tuple(ref.placements)))


def _whole_dims(x, dims) -> tuple:
    """x's placements with every split of ``dims`` and every partial sum
    replaced by ``Replicate()``."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_partial() or (
        p.is_shard() and p.dim % x.ndim in dims) else p
        for p in x.placements)


class _Contiguous(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grad(t):
    """``t`` itself, whose gradient is made contiguous on its way back
    into a DTensor: DTensor reads a part's strides as its own, and a view
    of a gradient part that is not contiguous (autograd's gradient of a
    permute) fails."""
    return _Contiguous.apply(t) if t.requires_grad else t


def _wrap(local, mesh, placements):
    """A DTensor of this rank's ``local`` part, made contiguous: the
    DTensor's strides are read from the part's, and a view of it in the
    backward pass fails on a part that is not contiguous."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False)


def along(x, dims, fn):
    """``fn(x)``, for an ``fn`` that works along ``dims`` of ``x`` and
    element by element over its other dims (keeping their sizes). On a
    DTensor each rank runs ``fn`` on its own part, with ``dims`` whole on
    every rank (their splits and any partial sum made whole first), and
    the result keeps that part's placements. DTensor's own strategies
    for such ops cannot be trusted on every version: ``torch.flip`` has
    none in torch 2.11, its pad misplaces its result there, and its
    ``torch.cumsum`` along a split dim has been seen to return each
    shard's own running sum, with no error."""
    if not is_dtensor(x):
        return fn(x)
    dims = {d % x.ndim for d in ((dims,) if isinstance(dims, int)
                                 else dims)}
    pls = _whole_dims(x, dims)
    if pls != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pls)
    return _wrap(fn(_contiguous_grad(x.to_local())), x.device_mesh, pls)


def run_local(fn, args, placements, out_placements):
    """``fn`` on each rank's parts: every DTensor of ``args`` moved to its
    ``placements`` entry, ``fn`` called on the local tensors (any other
    argument passed as it is), and its result placed on
    ``out_placements`` (a tuple of them where ``fn`` returns a tuple);
    for an ``fn`` whose result on the parts is the part of its result on
    the whole tensors. An argument held whole on a mesh dim whose ranks
    compute different parts gets a partial gradient there (each rank's
    share), which autograd's next redistribution sums."""
    from torch.distributed.tensor import Partial
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    outs = (out_placements if isinstance(out_placements[0], (tuple, list))
            else (out_placements,))
    # mesh dims whose ranks compute different parts: there an argument
    # they all hold whole gets only its own rank's share of the gradient
    split = {i for o in outs for i, p in enumerate(o)
             if not p.is_replicate()}
    local = []
    for a, pls in zip(args, placements):
        if is_dtensor(a):
            if tuple(a.placements) != tuple(pls):
                a = a.redistribute(mesh, pls)
            a = _contiguous_grad(a.to_local(grad_placements=tuple(
                Partial() if i in split and p.is_replicate() else p
                for i, p in enumerate(pls))))
        local.append(a)
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(_wrap(o, mesh, pls)
                     for o, pls in zip(out, out_placements))
    return _wrap(out, mesh, out_placements)


def part_bounds(x) -> list[tuple[int, int]]:
    """Per dim of the DTensor ``x``, the ``[lo, hi)`` of the whole tensor
    that this rank's part holds (every split even, as ``fit_spec``
    guarantees; several mesh dims splitting one tensor dim nest, the
    first outermost, as DTensor nests them)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    lo, size = [0] * x.ndim, list(x.shape)
    for i, p in enumerate(x.placements):
        if p.is_shard():
            d = p.dim % x.ndim
            if size[d] % mesh.size(i):
                raise ValueError(f"dim {d} of {tuple(x.shape)} splits "
                                 f"unevenly over {mesh.size(i)} ranks")
            size[d] //= mesh.size(i)
            lo[d] += coord[i] * size[d]
    return [(a, a + n) for a, n in zip(lo, size)]


def write_parts(buf, index: tuple, value, first: int = 0) -> None:
    """``buf[(:,) * first + index] = value`` in place, where ``index``
    holds one integer tensor per dim from ``first`` on (broadcast
    together to a shape S) in the whole tensor's coordinates, and
    ``value`` is whole on every rank: ``buf``'s leading dims, then S,
    then its trailing dims (or a number). On a DTensor each rank writes
    the entries that fall in its part, at local indices, into its local
    tensor (which the DTensor shares); nothing is communicated, and no
    rank makes ``buf`` whole. Splits of the leading dims raise."""
    if not is_dtensor(buf):
        buf[(slice(None),) * first + tuple(
            torch.as_tensor(i, device=buf.device) for i in index)] = value
        return
    bounds = part_bounds(buf)
    if any(hi - lo != buf.shape[d]
           for d, (lo, hi) in enumerate(bounds[:first])):
        raise ValueError("write_parts: a leading dim is split")
    loc = buf.to_local()
    idx = torch.broadcast_tensors(*[torch.as_tensor(i, device=loc.device)
                                    for i in index])
    ok = torch.ones(idx[0].shape, dtype=torch.bool, device=loc.device)
    for d, i in enumerate(idx, start=first):
        lo, hi = bounds[d]
        ok &= (i >= lo) & (i < hi)
    if not bool(ok.any()):
        return
    local_idx = tuple(i[ok] - bounds[d][0]
                      for d, i in enumerate(idx, start=first))
    if torch.is_tensor(value):
        value = value[(slice(None),) * first + (ok,)]
        # trailing dims: this rank's part of each split one
        tail = first + len(index)
        for d in range(tail, buf.ndim):
            lo, hi = bounds[d]
            if hi - lo != buf.shape[d]:
                value = value.narrow(first + 1 + d - tail, lo, hi - lo)
        value = value.to(loc.dtype)
    loc[(slice(None),) * first + local_idx] = value


def take_whole(x, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, index)``, whole on every rank (a plain
    tensor). On a DTensor each rank picks, from its own part, the indexed
    rows that its part holds along ``dim`` (zeros for the others); the
    picks are summed over the mesh dims that split ``dim`` (exact: every
    entry is one row plus zeros) and gathered over the others' splits.
    Only the selection moves: no rank makes ``x`` whole."""
    if not is_dtensor(x):
        return x.index_select(dim, index.to(x.device))
    from torch.distributed.tensor import DTensor, Partial
    dim %= x.ndim
    loc = x.to_local()
    lo, hi = part_bounds(x)[dim]
    index = index.to(loc.device)
    ok = (index >= lo) & (index < hi)
    part = loc.index_select(dim, (index - lo).clamp(0, hi - lo - 1))
    shape = [1] * loc.ndim
    shape[dim] = -1
    part = torch.where(ok.view(shape), part, torch.zeros((), dtype=part.dtype,
                                                         device=part.device))
    out = tuple(Partial() if p.is_shard() and p.dim % x.ndim == dim else p
                for p in x.placements)
    return DTensor.from_local(part, x.device_mesh, out,
                              run_check=False).full_tensor()


def copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place, for ``src`` of ``dst``'s shape: on a
    DTensor ``dst`` (and ``src``) each rank copies its own part, ``src``
    redistributed to ``dst``'s placements first."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def select_part(x, i: int):
    """``x[i]`` of a DTensor whose dim 0 is whole, as a DTensor sharing
    ``x``'s memory (the layer slice of a stacked cache, written in place
    through its parts); ``x[i]`` of any other tensor."""
    if not is_dtensor(x):
        return x[i]
    from torch.distributed.tensor import DTensor, Shard
    if any(p.is_shard() and p.dim % x.ndim == 0 for p in x.placements):
        raise ValueError("select_part: dim 0 is split")
    pls = tuple(Shard(p.dim % x.ndim - 1) if p.is_shard() else p
                for p in x.placements)
    return DTensor.from_local(x.to_local()[i], x.device_mesh, pls,
                              run_check=False)


def stack_parts(ts: list):
    """``torch.stack(ts)`` of DTensors placed alike, stacked part by part
    (no communication); ``torch.stack`` of plain tensors."""
    if not is_dtensor(ts[0]):
        return torch.stack(ts)
    from torch.distributed.tensor import DTensor, Shard
    t0 = ts[0]
    pls = tuple(Shard(p.dim % t0.ndim + 1) if p.is_shard() else p
                for p in t0.placements)
    return DTensor.from_local(torch.stack([t.to_local() for t in ts]),
                              t0.device_mesh, pls, run_check=False)


def replicate_on(x, mesh):
    """The plain tensor ``x`` (whole, alike on every rank) as a DTensor
    replicated on ``mesh``; a DTensor unchanged."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def plain_as_replicated(on: bool):
    """A scope in which a plain tensor meeting a DTensor (a constant, a
    mask, a position) counts as replicated (DTensor's
    ``implicit_replication``), where ``on``; a null scope otherwise."""
    if not on:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def pad(x, widths, value: float = 0.0):
    """``F.pad(x, widths, value=value)`` (constant mode), on a DTensor
    through :func:`along` (torch 2.11's DTensor pad places its result
    wrongly on a two-axis mesh: an input replicated over "model" came out
    with a part twice its peer's width)."""
    import torch.nn.functional as F
    dims = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    if not dims and is_dtensor(x):
        return x
    return along(x, dims, lambda t: F.pad(t, widths, value=value))


class Rules:
    """Immutable mapping: logical activation name -> :class:`P`.

    Optionally carries the mesh (a ``DeviceMesh`` with
    ``mesh_dim_names``) the specs refer to; without a mesh the rules are
    inert (``shard`` stays the identity), which keeps one-device paths
    untouched. The sharded CSB path runs where the active mesh has a
    "model" axis larger than 1 (``core.csb_linear``, ``cells.dataflow``).
    """

    def __init__(self, table: Mapping[str, P] | None = None, mesh=None):
        self._table = dict(table or {})
        self.mesh = mesh

    def get(self, name: str, default: P | None = None) -> P | None:
        return self._table.get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in self._table

    def items(self):
        return self._table.items()

    def updated(self, **specs: P) -> "Rules":
        """A new Rules with the given names added/overridden."""
        return Rules({**self._table, **specs}, mesh=self.mesh)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Rules({self._table!r}, mesh={self.mesh!r})"


_state = threading.local()


def current_rules() -> Rules | None:
    """The innermost active Rules, or None outside any ``use_rules``."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_rules(rules: Rules | None):
    """Install ``rules`` for the dynamic extent of the block (nestable;
    exiting, also by an exception, restores the outer rules). ``None``
    installs nothing. The scope is the thread's: code that runs a model
    in another thread (autograd's device threads recompute checkpointed
    layers) installs the caller's rules there again."""
    if rules is None:
        yield None
        return
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(rules)
    try:
        yield rules
    finally:
        stack.pop()


def fit_spec(spec, shape: tuple[int, ...], mesh) -> P | None:
    """Clip ``spec`` to what ``shape`` can actually carry on ``mesh``.

    Drops axis assignments whose dim does not divide the mesh axis size
    (or that name axes the mesh lacks). Returns None when nothing
    survives — the caller should skip the constraint entirely.
    """
    sizes = axis_sizes(mesh)
    entries = []
    any_live = False
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        if e is None:
            entries.append(None)
            continue
        axes = _axes(e)
        if not all(ax in sizes for ax in axes):
            entries.append(None)
            continue
        total = math.prod(sizes[ax] for ax in axes)
        if dim % total != 0:
            entries.append(None)
            continue
        entries.append(e)
        any_live = any_live or total > 1
    if not any_live:
        return None
    return P(*entries)


def _live_mesh():
    """The active rules and their mesh, when the mesh has more than one
    device; (rules or None, None) otherwise."""
    rules = current_rules()
    mesh = getattr(rules, "mesh", None)
    if mesh is None or math.prod(mesh.shape) <= 1:
        return rules, None
    return rules, mesh


def shard(x: Any, name: str, *, fallback: str | None = None) -> Any:
    """Place the DTensor ``x`` on the active rule for ``name`` (identity
    when no rules/mesh are active, the name is unknown, ``x`` is not a
    DTensor, or no dim fits).

    ``fallback="replicate"`` replicates ``x`` when the rule exists but no
    dim fits, instead of leaving whatever layout ``x`` arrived in. The
    SSD streams use it: their chunked scan takes cumulative sums along
    the sequence, which a layout inherited from a weight's split must
    not reach (see :func:`along`).
    """
    rules, mesh = _live_mesh()
    if mesh is None:
        return x
    spec = rules.get(name)
    if spec is None or not is_dtensor(x):
        return x
    fitted = fit_spec(spec, tuple(x.shape), mesh)
    if fitted is None:
        if fallback != "replicate":
            return x
        fitted = P(*([None] * x.ndim))
    pls = to_placements(fitted, mesh)
    return x if tuple(x.placements) == pls else x.redistribute(mesh, pls)


def replicated(x: Any) -> Any:
    """Pin the DTensor ``x`` fully replicated on the active rules mesh
    (identity without one, or for a plain tensor, like ``shard``). The
    MLA prefill's nope+rope concats use it, as in JAX."""
    _, mesh = _live_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pls = (Replicate(),) * mesh.ndim
    return x if tuple(x.placements) == pls else x.redistribute(mesh, pls)


def require_mesh(mesh):
    """``mesh`` itself, or TypeError unless it is a
    ``torch.distributed.device_mesh.DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def active_model_mesh(axis: str = "model"):
    """The mesh of the active Rules when its ``axis`` is larger than 1 —
    the signal that the sharded CSB path should run; None otherwise, so
    single-device paths stay on the local kernel."""
    mesh = getattr(current_rules(), "mesh", None)
    if mesh is None:
        return None
    return mesh if axis_sizes(mesh).get(axis, 1) > 1 else None

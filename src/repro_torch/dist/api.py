"""Context-scoped sharding rules — the port of ``repro.dist.api``'s
``Rules``, ``current_rules`` and ``use_rules``.

A :class:`Rules` carries the mesh that model code shards over: a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``.
:func:`use_rules` installs one for the dynamic extent of a block
(nestable; leaving a scope, also by an exception, restores the outer
one), and model code reads the active mesh through :func:`current_rules`:
the sharded CSB path runs where that mesh has a "model" axis larger
than 1 (``core.csb_linear``, ``cells.dataflow``).

The JAX package's ``Rules`` also carries a table (logical activation name
-> placement) that ``shard``/``fit_spec`` apply and from which
``rules.param_specs`` derives dense parameter placements; those wait for
the port of its sharded dense layers (ROADMAP item 20), and the table
comes with them. Until then ``Rules`` refuses a non-empty table rather
than carry placements that nothing applies.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping


class Rules:
    """The mesh that model code shards over (None: the rules are inert).
    ``table`` keeps the JAX package's signature and must be empty."""

    def __init__(self, table: Mapping[str, Any] | None = None, mesh=None):
        if table:
            raise NotImplementedError(
                "placement tables are not applied yet (ROADMAP item 20); "
                "pass only the mesh")
        self.mesh = mesh

    def __repr__(self) -> str:  # pragma: no cover
        return f"Rules(mesh={self.mesh!r})"


_state = threading.local()


def current_rules() -> Rules | None:
    """The innermost active Rules, or None outside any ``use_rules``."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_rules(rules: Rules):
    """Install ``rules`` for the dynamic extent of the block (nestable;
    exiting restores the outer rules)."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(rules)
    try:
        yield rules
    finally:
        stack.pop()


def require_mesh(mesh):
    """``mesh`` itself, or TypeError unless it is a
    ``torch.distributed.device_mesh.DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or any object with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def active_model_mesh(axis: str = "model"):
    """The mesh of the active Rules when its ``axis`` is larger than 1 —
    the signal that the sharded CSB path should run; None otherwise, so
    single-device paths stay on the local kernel."""
    mesh = getattr(current_rules(), "mesh", None)
    if mesh is None:
        return None
    return mesh if axis_sizes(mesh).get(axis, 1) > 1 else None

"""ADMM-based training-with-pruning (paper §2.2.2, Eqns. 2-6) — the port
of ``repro.core.admm``.

The training objective is split: SGD minimizes
``f(W) + sum_i rho/2 ||W_i - Z_i + U_i||^2``  (Eqn. 4)
while ``Z_i = proj_S(W_i + U_i)``             (Eqn. 5/6, the CSB projection)
and the dual update is ``U_i += W_i - Z_i``.

The API is functional: an ``ADMMState`` rides next to the params (nested
dicts, lists and tuples of tensors). Only parameters with an entry in the
spec tree participate; everything else (biases, norms, embeddings) is
untouched — the paper prunes weight matrices only.

``Z`` and ``U`` are constants of the penalty, as they are for
``jax.grad`` of the JAX package's loss: they are computed under
``torch.no_grad()`` from detached weights, so autograd differentiates
the penalty in ``W`` alone. Each step keeps the JAX package's dtypes:
``admm_init`` projects ``W`` in its own dtype, the penalty, the update
and the residual work on ``W`` in fp32, and ``admm_finalize`` casts back
to ``W``'s dtype. On a mesh (DTensor weights) each projection takes
the whole matrix (``full_tensor()``) and its result is placed as ``W``
is; the penalty and the dual update run on each rank's shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .pruning import CSBSpec, csb_project

PyTree = Any


@dataclasses.dataclass
class ADMMState:
    z: PyTree     # auxiliary (projected) variables, same tree as pruned params
    u: PyTree     # scaled dual variables
    rho: float


def _is_spec(x) -> bool:
    return isinstance(x, CSBSpec)


def spec_tree_map(fn: Callable, specs: PyTree, *trees: PyTree) -> PyTree:
    """Map ``fn(spec, leaf, ...)`` over ``specs`` and the trees that
    mirror it, treating ``CSBSpec`` and ``None`` as leaves of ``specs``
    (the other trees' entries there are passed whole)."""
    if specs is None or _is_spec(specs):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: spec_tree_map(fn, s, *(t[k] for t in trees))
                for k, s in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(spec_tree_map(fn, s, *(t[i] for t in trees))
                           for i, s in enumerate(specs))
    raise TypeError(f"spec tree node {type(specs).__name__}: expected a "
                    f"dict, list, tuple, CSBSpec or None")


def _leaves(tree: PyTree):
    """The leaves of a tree of terms, dicts in sorted key order (the
    order in which JAX flattens, and so sums, a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _total(terms: PyTree):
    total = 0.0
    for t in _leaves(terms):
        total = total + t
    return torch.as_tensor(total)


def _project(w, spec: CSBSpec):
    """The CSB projection of the whole matrix ``w``, placed as ``w`` is
    (a DTensor's shards alone are not the matrix the pattern is chosen
    on)."""
    from repro_torch.dist.api import like, whole
    return like(csb_project(whole(w), spec), w)


def admm_init(params: PyTree, specs: PyTree, rho: float = 1e-3) -> ADMMState:
    """specs mirrors ``params`` with CSBSpec leaves (None = not pruned)."""
    with torch.no_grad():
        z = spec_tree_map(
            lambda s, w: _project(w.detach(), s) if _is_spec(s) else None,
            specs, params)
        u = spec_tree_map(
            lambda s, w: torch.zeros_like(w) if _is_spec(s) else None,
            specs, params)
    return ADMMState(z=z, u=u, rho=rho)


def admm_penalty(params: PyTree, state: ADMMState,
                 specs: PyTree) -> torch.Tensor:
    """rho/2 * sum ||W - Z + U||_F^2 — add to the task loss (Eqn. 4)."""

    def term(s, w, z, u):
        if not _is_spec(s):
            return 0.0
        d = w.to(torch.float32) - z + u
        return 0.5 * state.rho * torch.sum(d * d)

    return _total(spec_tree_map(term, specs, params, state.z, state.u))


def admm_update(params: PyTree, state: ADMMState,
                specs: PyTree) -> ADMMState:
    """Solve the 2nd subproblem (projection) + dual ascent. Call once per
    epoch (or every k steps)."""

    def proj(s, w, u):
        if not _is_spec(s):
            return None
        return _project(w.detach().to(torch.float32) + u, s)

    def dual(s, w, z_, u):
        if not _is_spec(s):
            return None
        return u + w.detach().to(torch.float32) - z_

    with torch.no_grad():
        z = spec_tree_map(proj, specs, params, state.u)
        u = spec_tree_map(dual, specs, params, z, state.u)
    return ADMMState(z=z, u=u, rho=state.rho)


def admm_finalize(params: PyTree, specs: PyTree) -> PyTree:
    """Hard-project the trained weights onto the CSB pattern (the shipped
    model); unpruned leaves are returned as they are. Retraining with the
    mask fixed can follow."""

    def fin(s, w):
        if not _is_spec(s):
            return w
        return _project(w.detach(), s).to(w.dtype)

    with torch.no_grad():
        return spec_tree_map(fin, specs, params)


def residual_norm(params: PyTree, state: ADMMState,
                  specs: PyTree) -> torch.Tensor:
    """||W - Z|| convergence diagnostic."""

    def term(s, w, z):
        if not _is_spec(s):
            return 0.0
        d = w.detach().to(torch.float32) - z
        return torch.sum(d * d)

    from repro_torch.dist.api import whole
    with torch.no_grad():
        return torch.sqrt(whole(_total(spec_tree_map(term, specs, params,
                                                     state.z))))

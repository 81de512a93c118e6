"""Optimizers as (init, update) pairs of functions, the port of
``repro.optim.optimizers``.

``update(grads, state, params, lr, weight_decay=0.0) -> (params,
state)``, as in JAX, with two differences of form. The update writes the
new values into ``params`` and ``state`` in place, under
``torch.no_grad()``, and returns them: a functional update would hold
two copies of the weights and the moments at once (at gemma-2b's 3.03 B
parameters, AdamW's fp32 moments alone are 24.2 GB). And the trees are
the port's: ``params["layers"]`` is a list of per-layer dicts, where JAX
stacks each weight on a leading L axis (``repro_torch._tree``).

The arithmetic is the reference's, not ``torch.optim``'s: each step
computes in fp32 and rounds once to the parameter's dtype; AdamW keeps
fp32 moments, b2 = 0.95, the bias corrections ``1 - b ** t`` in fp32,
and adds the decay to the step direction (``mh / (sqrt(vh) + eps) + wd *
p``); SGD adds the decay to the gradient. The element-wise optimizers
(SGD, AdamW) act on each layer's tensor as they would on the stack.
Adafactor does not: it judges ``_factored`` by the leaf's *stacked*
shape, so a layer's (d,) RMSNorm weight is an (L, d) leaf with factored
statistics whose column statistic runs over the layers, and its update
clipping takes the RMS over the whole stack. So Adafactor stacks each
leaf's layers, and keeps its state stacked, in JAX's tree.

On a mesh the params, their gradients and the state are DTensors
(``dist.api``): the element-wise updates run on each rank's shard, the
state of SGD and AdamW takes its param's placements, Adafactor's
factored statistics take ``launch.shardspec.opt_state_specs``'
placements (:func:`adafactor_state_specs`), and ``global_norm`` sums
whole leaves (each shard's sum of squares reduced over the mesh), not a
shard's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import _tree
from repro_torch.dist.api import (
    P, is_dtensor, spec_of, to_placements, whole,
)

PyTree = Any
F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]
    name: str = "opt"


@dataclasses.dataclass
class OptState:
    """``inner`` (the optimizer's tree) and ``step`` (0-d int32); JAX
    flattens it as (inner, step)."""

    inner: PyTree
    step: torch.Tensor


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over JAX's leaves, in JAX's order, of each leaf's
    fp32 sum of squares (a stacked leaf summed over its layers)."""
    total = 0.0
    for parts in _tree.leaves(tree):
        s = 0.0
        for x in parts:
            s = s + whole(torch.sum(torch.square(x.to(F32))))
        total = total + s
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return _tree.map_leaves(
        lambda ps: [(g.to(F32) * scale).to(g.dtype) for g in ps], grads)


def _zeros(params: PyTree, dtype) -> PyTree:
    """Zeros shaped (and, on a mesh, placed) as each param."""
    return _tree.map_leaves(
        lambda ps: [torch.zeros_like(p, dtype=dtype) for p in ps], params)


def _step0(params: PyTree) -> torch.Tensor:
    dev = next(_tree.leaves(params))[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _write(p: torch.Tensor, new: torch.Tensor) -> None:
    """p <- new (fp32), rounded to p's dtype (on a mesh, ``new`` moved to
    p's placements first)."""
    if is_dtensor(p) and tuple(new.placements) != tuple(p.placements):
        new = new.redistribute(p.device_mesh, p.placements)
    if p.dtype == F32:
        p.copy_(new)
    else:
        p.copy_(new.to(p.dtype))


def _t(state) -> torch.Tensor:
    """The step count t = step + 1 as a 0-d fp32 CPU tensor."""
    return (whole(state.step) + 1).to(F32).cpu()


def _pairs(*trees):
    """(tensor of each tree) for every part of every JAX leaf."""
    for groups in zip(*(_tree.leaves(t) for t in trees)):
        yield from zip(*groups)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------

def sgd(momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return OptState(inner=_zeros(params, F32), step=_step0(params))

    @torch.no_grad()
    def update(grads, state, params, lr, weight_decay=0.0):
        for g, m, p in _pairs(grads, state.inner, params):
            g = g.to(F32)
            if weight_decay:
                g = g + weight_decay * p.to(F32)
            m.mul_(momentum).add_(g)
            step_dir = g + momentum * m if nesterov else m
            _write(p, p.to(F32) - lr * step_dir)
        state.step = state.step + 1
        return params, state

    return Optimizer(init, update, "sgd")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          moment_dtype=F32) -> Optimizer:
    def init(params):
        return OptState(inner={"m": _zeros(params, moment_dtype),
                               "v": _zeros(params, moment_dtype)},
                        step=_step0(params))

    @torch.no_grad()
    def update(grads, state, params, lr, weight_decay=0.0):
        t = _t(state)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32), t)
        for g, m, v, p in _pairs(grads, state.inner["m"], state.inner["v"],
                                 params):
            # each op is JAX's, rounded where JAX rounds; fp32 buffers are
            # reused in place (at most two a leaf besides the moments)
            g = g.to(F32)
            mf, vf = m.to(F32), v.to(F32)      # the moments themselves in fp32
            mf.mul_(b1).add_((1 - b1) * g)     # m = b1 m + (1 - b1) g
            vf.mul_(b2).add_(((1 - b2) * g).mul_(g))
            del g
            # step_dir = mh / (sqrt(vh) + eps) [+ wd * p]
            step_dir = torch.div(vf, c2).sqrt_().add_(eps)
            step_dir = torch.div(mf, c1).div_(step_dir)
            if weight_decay:
                step_dir.add_(weight_decay * p.to(F32))
            if mf is not m:
                m.copy_(mf)
                v.copy_(vf)
            del mf, vf
            _write(p, p.to(F32).sub_(step_dir.mul_(lr)))
        state.step = state.step + 1
        return params, state

    return Optimizer(init, update, "adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------

def adafactor_state_specs(spec) -> dict:
    """The specs of Adafactor's state for a (JAX, stacked) leaf of
    ``spec``: a factored leaf's row statistic ``r`` drops the last entry,
    its column statistic ``c`` the one before; any other keeps ``v``
    (the JAX package's ``launch/shardspec.opt_state_specs``)."""
    parts = tuple(spec)
    if len(parts) >= 2:
        return {"r": P(*parts[:-1]), "c": P(*(parts[:-2] + parts[-1:]))}
    return {"v": P(*parts)}


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(parts, stacked):
            shape = ((len(parts),) if stacked else ()) + tuple(parts[0].shape)
            dev = parts[0].device
            if _factored(shape):
                shapes = {"r": shape[:-1], "c": shape[:-2] + shape[-1:]}
            else:
                shapes = {"v": shape}
            ref = parts[0]
            if not is_dtensor(ref):
                return {k: torch.zeros(sh, dtype=F32, device=dev)
                        for k, sh in shapes.items()}
            from torch.distributed.tensor import zeros as dzeros
            mesh = ref.device_mesh
            spec = spec_of(ref.placements, ref.ndim, mesh)
            specs = adafactor_state_specs(
                P(None, *spec) if stacked else spec)
            return {k: dzeros(sh, dtype=F32, device_mesh=mesh,
                              placements=to_placements(specs[k], mesh))
                    for k, sh in shapes.items()}

        return OptState(inner=_tree.jax_structure(params, one),
                        step=_step0(params))

    def _jax(parts, stacked):
        return torch.stack(parts) if stacked else parts[0]

    @torch.no_grad()
    def update(grads, state, params, lr, weight_decay=0.0):
        t = _t(state)
        beta = 1.0 - torch.pow(t + 1.0, -decay)
        for g_parts, s, (p_parts, stacked) in zip(
                _tree.leaves(grads), _state_leaves(state.inner),
                _tree.walk(params)):
            g = _jax(g_parts, stacked).to(F32)
            g2 = g * g + eps
            if _factored(g.shape):
                r = beta * s["r"] + (1 - beta) * g2.mean(-1)
                c = beta * s["c"] + (1 - beta) * g2.mean(-2)
                rc = r / torch.clamp(r.mean(-1, keepdim=True), min=1e-30)
                vhat = rc[..., None] * c[..., None, :]
                _write(s["r"], r)
                _write(s["c"], c)
            else:
                vhat = beta * s["v"] + (1 - beta) * g2
                _write(s["v"], vhat)
            u = g * torch.rsqrt(vhat + eps)
            # update clipping (RMS), over the whole stacked leaf
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p = _jax(p_parts, stacked)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            new = p.to(F32) - lr * u
            for dst, src in zip(p_parts, new if stacked else [new]):
                _write(dst, src)
        state.step = state.step + 1
        return params, state

    return Optimizer(init, update, "adafactor")


def _state_leaves(inner: PyTree):
    """Adafactor's per-leaf state dicts ({r, c} or {v}) in JAX's order."""
    if isinstance(inner, dict) and set(inner) <= {"r", "c", "v"} \
            and all(isinstance(v, torch.Tensor) for v in inner.values()):
        yield inner
        return
    for k in sorted(inner):
        yield from _state_leaves(inner[k])


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}[name](**kw)

"""int8 error-feedback gradient compression, the port of
``repro.dist.compress``.

Data parallelism all-reduces full-precision gradients every step; the
classic fix (1-bit SGD / EF-SGD lineage) quantizes the gradient and
*carries the quantization error forward*: what round-off drops this step
is added back into the next step's gradient, so the sum of transmitted
gradients tracks the sum of true gradients and SGD still converges.

Per JAX leaf: ``scale = max|g + residual| / 127``, values round to int8
on that grid (half to even, as ``jnp.round``), and ``residual`` keeps the
difference. A JAX leaf of a decoder's layers is the stack of every
layer's tensor (``repro_torch._tree``), so one scale spans all the
layers of a weight, as in JAX: each layer's ``Compressed`` holds its own
int8 codes and that shared scale. On a mesh the gradients, residuals and
codes are DTensors on the params' placements, and a leaf's max is taken
over the whole leaf (each shard's max reduced over the mesh).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import _tree
from repro_torch.dist.api import whole

PyTree = Any
F32 = torch.float32


class Compressed(NamedTuple):
    """One quantized tensor: int8 codes + the fp32 grid scale of its JAX
    leaf."""

    q: torch.Tensor       # int8, same shape as the source tensor
    scale: torch.Tensor   # fp32 scalar


def compress_init(tree: PyTree) -> PyTree:
    """Zero error-feedback residuals shaped like the gradient tree."""
    return _tree.map_leaves(
        lambda ps: [torch.zeros_like(g, dtype=F32) for g in ps], tree)


def _compress_leaf(gs: list, rs: list):
    es = [g.to(F32) + r for g, r in zip(gs, rs)]
    amax = whole(es[0].abs().max())
    for e in es[1:]:
        amax = torch.maximum(amax, whole(e.abs().max()))
    scale = amax / 127.0
    div = torch.clamp(scale, min=1e-30)
    comp, res = [], []
    for e in es:
        q = torch.clamp(torch.round(e / div), -127, 127).to(torch.int8)
        comp.append(Compressed(q, scale))
        res.append(e - q.to(F32) * scale)
    return comp, res


def _structure(tree: PyTree) -> list:
    return [(len(ps), tuple(tuple(p.shape) for p in ps))
            for ps in _tree.leaves(tree)]


def compress(grads: PyTree, residual: PyTree):
    """Returns (compressed_tree, new_residual_tree)."""
    if _structure(residual) != _structure(grads):
        raise ValueError(
            "residual tree does not match gradient tree (was compress_init "
            "run on these params?)")
    out = _tree.map_leaves(lambda gs, rs: list(zip(*_compress_leaf(gs, rs))),
                           grads, residual)
    comp = _tree.map_leaves(lambda ps: [c for c, _ in ps], out)
    res = _tree.map_leaves(lambda ps: [r for _, r in ps], out)
    return comp, res


def decompress(comp: PyTree) -> PyTree:
    """Dequantize back to fp32 (the receiver side of the all-reduce)."""
    return _tree.map_leaves(
        lambda cs: [c.q.to(F32) * c.scale for c in cs], comp)


def compression_ratio(tree: PyTree) -> float:
    """Wire-bytes ratio: original tree vs int8 codes + one fp32 scale
    per JAX leaf (~4x for fp32 gradients)."""
    orig = comp = 0
    for ps in _tree.leaves(tree):
        n = sum(p.numel() for p in ps)
        orig += n * ps[0].element_size()
        comp += n + 4
    return orig / max(comp, 1)

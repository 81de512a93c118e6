"""The JAX package's view of the port's parameter trees.

The JAX package stacks a decoder's layers on a leading L axis, so each
weight of a layer is one leaf ``(L, ...)``, and it flattens a tree with
its dict keys sorted. The port keeps ``params["layers"]`` as a list of
per-layer dicts (``convert.lm_params_from_numpy``). Whatever the JAX
package computes per leaf (Adafactor's statistics, the int8 grid of
gradient compression, the sum order of a global norm, a checkpoint's
leaf order) must see JAX's leaves. Here every list in a tree is such a
stacked axis: its elements share one structure, and the tensors at one
place in them are the layers of one JAX leaf.

``leaves(tree)`` yields each JAX leaf, in JAX's flatten order, as the
list of its parts: ``[tensor]`` for a plain leaf, one tensor per layer
for a stacked one (``walk`` also says which are stacked, and ``rebuild``
makes a tree of a given structure from such lists). ``map_leaves`` maps
a function over the JAX leaves of trees of one structure and rebuilds
the result in that structure; ``stacked(tree)`` gives JAX's arrays
themselves and ``unstack(like, arrays)`` the reverse; ``jax_structure``
builds a tree in JAX's own structure (``"layers"`` a dict of stacked
leaves). Dicts (keys sorted), lists (stacked) and ``OptState``
(``inner``, then ``step``, as JAX flattens it) are nodes; ``None`` has
no leaves; every other object, a tuple too, is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

PyTree = Any


def is_state(t) -> bool:
    # optim.OptState, without the import (optim imports this module)
    return type(t).__name__ == "OptState" and hasattr(t, "inner")


def walk(tree: PyTree, stack: bool = False) -> Iterator[tuple[list, bool]]:
    """(parts, is_stacked) of each JAX leaf, in JAX's order (``tree`` is
    a list of layers' subtrees where ``stack``)."""
    if stack:
        first = tree[0]
        if isinstance(first, dict):
            for k in sorted(first):
                yield from walk([t[k] for t in tree], True)
        elif first is not None:
            yield list(tree), True
    elif tree is None:
        return
    elif is_state(tree):
        yield from walk(tree.inner)
        yield [tree.step], False
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k])
    elif isinstance(tree, list):
        yield from walk(tree, True)
    else:
        yield [tree], False


def leaves(tree: PyTree) -> Iterator[list]:
    """Each JAX leaf of ``tree`` in JAX's flatten order, as the list of
    its parts (one per layer where the leaf is stacked)."""
    for parts, _ in walk(tree):
        yield parts


def rebuild(like: PyTree, it, stack: bool = False) -> PyTree:
    """``like``'s structure, each JAX leaf's parts taken in turn from the
    iterator ``it``."""
    if stack:
        first = like[0]
        if isinstance(first, dict):
            per_key = {k: rebuild([t[k] for t in like], it, True)
                       for k in sorted(first)}
            return [{k: per_key[k][i] for k in first}
                    for i in range(len(like))]
        return list(like) if first is None else list(next(it))
    if like is None:
        return None
    if is_state(like):
        inner = rebuild(like.inner, it)
        return type(like)(inner=inner, step=next(it)[0])
    if isinstance(like, dict):
        built = {k: rebuild(like[k], it) for k in sorted(like)}
        return {k: built[k] for k in like}
    if isinstance(like, list):
        return rebuild(like, it, True)
    return next(it)[0]


def map_leaves(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn(parts, *rest_parts)`` on each JAX leaf of ``tree`` and of the
    trees in ``rest`` (the same structure); ``fn`` returns the new leaf's
    parts, and the results are rebuilt in ``tree``'s structure."""
    groups = [list(leaves(t)) for t in (tree, *rest)]
    return rebuild(tree, iter([fn(*ps) for ps in zip(*groups)]))


def stacked(tree: PyTree) -> list:
    """JAX's arrays of ``tree``, in JAX's order: a stacked leaf's parts
    stacked on a new leading axis (a one-layer stack is (1, ...))."""
    return [torch.stack(ps) if st else ps[0] for ps, st in walk(tree)]


def unstack(like: PyTree, arrays) -> PyTree:
    """A tree of ``like``'s structure from JAX's arrays (tensors) in JAX's
    order: a stacked leaf is cut along its leading axis into its layers,
    each a tensor of its own (not a view of the stack)."""
    arrays = list(arrays)
    flags = [st for _, st in walk(like)]
    if len(arrays) != len(flags):
        raise ValueError(f"{len(arrays)} arrays for a tree of "
                         f"{len(flags)} leaves")
    return rebuild(like, iter([[p.clone() for p in a.unbind(0)] if st
                               else [a] for a, st in zip(arrays, flags)]))


def jax_structure(tree: PyTree, fn: Callable) -> PyTree:
    """A tree in JAX's structure, each list of layers replaced by a dict
    of its stacked leaves, holding ``fn(parts, is_stacked)`` for each JAX
    leaf of ``tree``."""
    def build(t, stack=False):
        if stack:
            if isinstance(t[0], dict):
                return {k: build([x[k] for x in t], True) for k in t[0]}
            return fn(list(t), True)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return build(t, True)
        return fn([t], False)

    return build(tree)

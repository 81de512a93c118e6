"""Fault-tolerant checkpointing, the port of ``repro.train.checkpoint``.

Layout, the JAX package's: ``<dir>/step_<N>/`` holding one ``arrays.npz``
of flattened leaves plus ``manifest.json`` (tree structure, dtypes,
shapes, content hashes, sha256[:16]). Commit is atomic: everything is
written into ``step_<N>.tmp`` and renamed; a crash mid-save never
corrupts the latest checkpoint. bf16 leaves are stored as their lossless
fp32 upcast (npz has no bf16); the tree that restores them says their
dtype.

The leaves are JAX's, in JAX's order (``repro_torch._tree``): dict keys
sorted (so ``"opt"`` comes before ``"params"``), ``OptState`` as (inner,
step), and a decoder's layers stacked on a leading L axis, as the JAX
package holds them. So a checkpoint written by ``repro.train.checkpoint``
restores here and the reverse: ``restore`` checks the leaf count, the
shapes and the hashes, not the treedef string (which differs).

Arrays are saved unsharded: a tree of DTensors (a mesh run) is gathered
whole on every rank (a collective: every rank calls ``save``), rank 0
alone writes, and the ranks meet at a barrier before any goes on. So a
run restores onto any mesh: ``restore`` places each leaf on its
``shardings`` entry (a ``dist.api.NamedSharding``, as
``launch.shardspec.to_named`` gives), or, without ``shardings``, as
``like``'s leaf is placed (a plain leaf on its device).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.dist.api import NamedSharding, is_dtensor, place, whole

PyTree = Any


def _numpy(x) -> np.ndarray:
    """A leaf as numpy for npz: bf16 (and any other dtype numpy lacks)
    as its fp32 upcast."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


def _treedef(tree: PyTree) -> str:
    def walk(t):
        if t is None:
            return "None"
        if _tree.is_state(t):
            return f"OptState({walk(t.inner)}, *)"
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return f"layers[{len(t)}]{walk(t[0])}"
        return "*"

    return walk(tree)


def _whole_leaves(tree: PyTree) -> tuple[list, bool]:
    """JAX's arrays of ``tree`` (each whole), and whether any was a
    DTensor (gathered from the ranks)."""
    arrays, gathered = [], False
    for parts, st in _tree.walk(tree):
        gathered = gathered or any(is_dtensor(p) for p in parts)
        full = [whole(p) for p in parts]
        arrays.append(torch.stack(full) if st else full[0])
    return arrays, gathered


def save(ckpt_dir: str, step: int, tree: PyTree,
         extra: dict | None = None) -> str:
    leaves, gathered = _whole_leaves(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not gathered:
        return _write(ckpt_dir, final, step, tree, leaves, extra)
    import torch.distributed as dist
    if dist.get_rank() == 0:
        _write(ckpt_dir, final, step, tree, leaves, extra)
    del leaves
    dist.barrier()
    return final


def _write(ckpt_dir, final, step, tree, leaves, extra) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)

    hashes = {k: hashlib.sha256(v.tobytes()).hexdigest()[:16]
              for k, v in arrays.items()}
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "treedef": _treedef(tree),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "hashes": hashes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _sharding(ref, sh):
    """Where a restored tensor goes: ``sh`` when given, else ``ref``'s
    placements when it is a DTensor, else None (``ref``'s device)."""
    if sh is not None:
        return sh
    if is_dtensor(ref):
        return NamedSharding(ref.device_mesh, tuple(ref.placements))
    return None


def _device_of(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore(ckpt_dir: str, step: int, like: PyTree,
            shardings: PyTree | None = None,
            verify: bool = True) -> tuple[PyTree, dict]:
    """``like`` supplies the tree structure, each leaf's dtype and device
    (a tensor, or anything with ``shape``, ``dtype`` and ``device``).
    ``shardings``, a tree of ``like``'s structure holding a
    ``NamedSharding`` for each tensor, places each on its mesh (every
    rank reads the whole file and keeps its part). A restored layer is a
    tensor of its own, not a view of the stack."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    refs = list(_tree.walk(like))
    shards = ([p for p, _ in _tree.walk(shardings)] if shardings is not None
              else [[None] * len(parts) for parts, _ in refs])
    if manifest["n_leaves"] != len(refs):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"model expects {len(refs)} — incompatible trees")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (parts, stack) in enumerate(refs):
            arr = data[f"leaf_{i}"]
            if verify:
                h = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
                if h != manifest["hashes"][f"leaf_{i}"]:
                    raise IOError(f"checkpoint leaf_{i} hash mismatch "
                                  f"(corrupt checkpoint)")
            ref = parts[0]
            shape = ((len(parts),) if stack else ()) + tuple(ref.shape)
            if tuple(arr.shape) != shape:
                raise ValueError(f"leaf_{i} shape {arr.shape} != {shape}")
            full = torch.from_numpy(np.array(arr))
            layers = full.unbind(0) if stack else [full]
            got = []
            for layer, p, sh in zip(layers, parts, shards[i]):
                sh = _sharding(p, sh)
                if sh is None:
                    got.append(layer.to(p.device, p.dtype, copy=True))
                else:
                    got.append(place(layer.to(_device_of(sh.mesh), p.dtype),
                                     sh))
            out.append(got)
    return _tree.rebuild(like, iter(out)), manifest["extra"]


def restore_latest(ckpt_dir: str, like: PyTree,
                   shardings: PyTree | None = None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, extra = restore(ckpt_dir, step, like, shardings)
    return step, tree, extra


def keep_last(ckpt_dir: str, n: int = 3) -> None:
    """Garbage-collect all but the newest n checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-n]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)

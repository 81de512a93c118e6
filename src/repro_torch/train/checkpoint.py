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
shapes and the hashes, not the treedef string (which differs). Arrays
are saved unsharded and restored onto the device of ``like``'s leaves.
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


def save(ckpt_dir: str, step: int, tree: PyTree,
         extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {f"leaf_{i}": _numpy(x)
              for i, x in enumerate(_tree.stacked(tree))}
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


def restore(ckpt_dir: str, step: int, like: PyTree,
            verify: bool = True) -> tuple[PyTree, dict]:
    """``like`` supplies the tree structure, each leaf's dtype and device
    (a tensor, or anything with ``shape``, ``dtype`` and ``device``). A
    restored layer is a tensor of its own, not a view of the stack."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    refs = list(_tree.walk(like))
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
            out.append(torch.from_numpy(np.array(arr)).to(ref.device,
                                                           ref.dtype))
    return _tree.unstack(like, out), manifest["extra"]


def restore_latest(ckpt_dir: str, like: PyTree):
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, extra = restore(ckpt_dir, step, like)
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

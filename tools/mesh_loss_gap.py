#!/usr/bin/env python
"""How far a mesh run sits from one device's, sound and with a planted
fault: the readings behind the bounds of ``chip_smoke.py``'s
``[phase mesh-train]`` (a).

Losses: trains ``--arch`` through ``repro_torch.launch.train`` from the
same seed and batches on one device, on ``--mesh`` (sound), and on
``--mesh`` twice with one gradient's reduction skipped (the first
vector, then the first matrix, whose gradient comes back partial keeps
each rank's own partial sum, as if ``train.loop._reduced`` had missed
it; patched in the ranks, the code on disk untouched), and prints each
mesh run's largest per-step relative gap from the one-device run.

State: ``chip_smoke.train_state`` (gemma-2b at full width and a cut
depth, AdamW's moments and the params' change per tensor) on one card,
on ``--mesh`` and on ``--mesh`` with each of the two faults, and each
mesh run's ``chip_smoke.state_gap`` from the card's. The card only.

Then a JSON line. Usage:
  PYTHONPATH=src python tools/mesh_loss_gap.py --arch gemma-2b --mesh 1x2
  PYTHONPATH=src python tools/mesh_loss_gap.py --part losses \\
      --arch gemma-2b --reduced --mesh 1x2 --device cpu --seq 16
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]   # chip_smoke at the root

import torch  # noqa: E402

from repro_torch.dist.launch import spawn_ranks  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.train import make_mesh  # noqa: E402


def _skip_one_reduction(ndim: int) -> list:
    """Patch ``train.loop._reduced`` in this process: the first partial
    gradient of an ``ndim``-dim parameter keeps each rank's own partial
    sum. Returns the list that will hold that parameter."""
    from torch.distributed.tensor import DTensor, Replicate

    import repro_torch.train.loop as loop

    sound, target = loop._reduced, []

    def reduced(g, p):
        partial = isinstance(g, DTensor) and any(
            pl.is_partial() for pl in g.placements)
        if partial and p.ndim == ndim and (not target or target[0] is p):
            target[:] = [p]
            # each rank's partial sum taken for the whole one
            pls = [Replicate() if pl.is_partial() else pl
                   for pl in g.placements]
            g = DTensor.from_local(g.to_local(), p.device_mesh, pls,
                                   run_check=False)
        return sound(g, p)

    loop._reduced = reduced
    return target


def _faulty_rank(mesh, argv: list[str], ndim: int) -> dict:
    """``launch.train._rank`` with one reduction skipped; the summary
    also names the parameter's shape."""
    target = _skip_one_reduction(ndim)
    out = launch._rank(mesh, argv)
    out["skipped"] = tuple(target[0].shape) if target else None
    return out


def _faulty_state(mesh, ndim: int) -> dict:
    """``chip_smoke.train_state`` with one reduction skipped."""
    import chip_smoke
    target = _skip_one_reduction(ndim)
    out = chip_smoke.train_state(mesh)
    out["skipped"] = tuple(target[0].shape) if target else None
    return out


def _losses(args, dims, out: dict) -> None:
    argv = ["--arch", args.arch, "--steps", str(args.steps), "--seq",
            str(args.seq)] + (["--reduced"] if args.reduced else []) + (
        ["--device", args.device] if args.device else [])
    _, one = launch.main(argv)
    one = [h["loss"] for h in one]
    gc.collect()                    # the ranks need the card's memory
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    _, sound = launch.main(argv + ["--mesh", args.mesh])
    sound = [h["loss"] for h in sound]
    gaps = lambda ls: [abs(a - b) / abs(b) for a, b in zip(ls, one)]
    out.update(one_device=one, sound=sound, sound_gaps=gaps(sound),
               faults=[])
    print(f"one device: {one}\nsound mesh: {sound}, largest relative gap "
          f"{max(gaps(sound)):.3e}")
    for ndim in (1, 2):
        ranks = spawn_ranks(_faulty_rank, dims, argv + ["--mesh", args.mesh],
                            ndim, device=args.device,
                            timeout_s=600.0 + 120.0 * args.steps)
        fault = [h["loss"] for h in ranks[0]["history"]]
        out["faults"].append({"skipped_shape": ranks[0]["skipped"],
                              "losses": fault, "gaps": gaps(fault)})
        print(f"one reduction skipped (a parameter of shape "
              f"{ranks[0]['skipped']}): {fault}, largest relative gap "
              f"{max(gaps(fault)):.3e}")


def _state(dims, out: dict) -> None:
    import chip_smoke
    one = chip_smoke.train_state()
    gc.collect()
    torch.cuda.empty_cache()
    sound = spawn_ranks(chip_smoke.train_state, dims, timeout_s=600.0)[0]
    out["state"] = {"sound": chip_smoke.state_gap(sound, one), "faults": []}
    print(f"state, sound mesh: {out['state']['sound']}")
    for ndim in (1, 2):
        got = spawn_ranks(_faulty_state, dims, ndim, timeout_s=600.0)[0]
        gap = chip_smoke.state_gap(got, one)
        out["state"]["faults"].append({"skipped_shape": got["skipped"],
                                       "gap": gap})
        print(f"state, one reduction skipped (a parameter of shape "
              f"{got['skipped']}): {gap}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x2")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None)
    ap.add_argument("--part", choices=("losses", "state", "both"),
                    default="both")
    args = ap.parse_args()
    dims, _ = make_mesh(args.mesh)
    out = {"arch": args.arch, "reduced": args.reduced, "mesh": args.mesh}
    if args.part in ("losses", "both"):
        _losses(args, dims, out)
    if args.part in ("state", "both"):
        _state(dims, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training entry point, the port of ``repro.launch.train``.

Runs the fault-tolerant training loop on synthetic char-LM data, with
the JAX launcher's flags and defaults (batch 8, seq 128, lr 1e-3,
``linear_warmup_cosine`` with warmup 10, ``CharLMTask(vocab=min(vocab,
256))``, checkpoints every 50 steps).

  python -m repro_torch.launch.train --arch gemma-2b --reduced --steps 50 \\
      --device cpu
  python -m repro_torch.launch.train --arch gemma-2b --steps 8   # the card
  python -m repro_torch.launch.train --arch gemma-2b --mesh 1x2 --steps 4

Without ``--mesh`` (or on a mesh of one device) the run is one process on
one device. ``--mesh DxM`` (axes "data", "model") or ``PxDxM`` ("pod",
"data", "model") starts one process a rank (``dist.launch.spawn_ranks``;
on the card rank r takes card ``r % device_count``, so ranks share a card
when there are fewer) and trains SPMD, as JAX's launcher does on its
mesh: ``ShardingPolicy(fsdp=params > 3e10)``, the activation rules of
``dist.rules.activation_rules`` installed with ``use_rules``, every
rank's params drawn from the same seed and placed on ``param_specs``'
placements, the batches on ``batch_specs``'. Rank 0 prints the JAX
launcher's ``arch=... mesh={...}`` line and the log.

``--reduced`` uses the smoke-scale config (fp32); otherwise the full
assigned config is built on the device (gemma-2b: 3.03 B parameters in
bf16, ~45 GB with AdamW's fp32 moments on one card).
"""
from __future__ import annotations

import argparse
import math
import sys

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import CharLMTask, lm_batch_iterator, sharded_batches
from repro_torch.dist.api import place_tree, use_rules
from repro_torch.dist.launch import AXES, spawn_ranks
from repro_torch.dist.rules import (
    ShardingPolicy, activation_rules, batch_specs, param_specs,
)
from repro_torch.launch.shardspec import to_named
from repro_torch.models import forward_loss, init_params
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import TrainConfig, train


def make_mesh(spec: str | None) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The mesh ``--mesh`` asks for ("16x16", "2x16x16"; one device
    without it): its dims and axis names, as JAX's ``make_mesh`` names
    them."""
    dims = tuple(int(x) for x in spec.split("x")) if spec else (1, 1)
    if len(dims) not in AXES:
        raise SystemExit(f"mesh {dims}: give DxM or PxDxM")
    return dims, AXES[len(dims)]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 16x16 or 2x16x16")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless 'cpu' is asked for")
    return ap


def _config(args):
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced and cfg.n_img_tokens:
        args.seq = max(args.seq, cfg.n_img_tokens + 32)
    return cfg


def _counted(it, counts: dict):
    """``it``, with the collectives of the step that takes its first
    batch counted into ``counts`` ({op: count}). The mode is entered and
    left in the training thread, in the loop's order: on while step 0
    runs."""
    from torch.distributed.tensor.debug import CommDebugMode

    mode = CommDebugMode()
    for i, item in enumerate(it):
        if i == 0:
            mode.__enter__()
        yield item
        if i == 0:
            mode.__exit__(None, None, None)
            counts.update({str(k): v
                           for k, v in mode.get_comm_counts().items()})


def run(args, mesh=None, counts: dict | None = None):
    """Train as ``args`` (parsed flags) say, on one device or, given a
    ``DeviceMesh``, as this rank of it; returns (params, history). Given
    ``counts`` (a mesh run), the collectives of step 0 are counted into
    it."""
    cfg = _config(args)
    rank0 = mesh is None or mesh.get_rank() == 0
    dev = resolve_device(args.device if mesh is None else mesh.device_type)
    dims, axes = make_mesh(args.mesh)
    log = print if rank0 else (lambda *_: None)
    log(f"arch={cfg.name} params={cfg.param_count():,} "
        f"mesh={dict(zip(axes, dims))} device={dev}")

    rules = policy = None
    if mesh is not None:
        policy = ShardingPolicy(fsdp=cfg.param_count() > 3e10)
        rules = activation_rules(cfg, mesh, policy, global_batch=args.batch)
    with use_rules(rules):
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        bspecs = None
        if mesh is not None:
            params = place_tree(params, to_named(
                mesh, param_specs(cfg, params, mesh, policy)))
            bspecs = batch_specs(cfg, "train", mesh, global_batch=args.batch)
        task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
        batches = sharded_batches(
            lm_batch_iterator(task, args.batch, args.seq), mesh, bspecs,
            device=dev)
        if counts is not None:
            batches = _counted(batches, counts)
        tcfg = TrainConfig(lr=args.lr, steps=args.steps, log_every=10,
                           ckpt_dir=args.ckpt, ckpt_every=50)
        sched = linear_warmup_cosine(args.lr, warmup=10, steps=args.steps)
        dt = getattr(torch, cfg.dtype)

        def loss_fn(p, b):
            b = dict(b)
            if cfg.n_img_tokens:
                b["img_embeds"] = torch.zeros(
                    (b["tokens"].shape[0], cfg.n_img_tokens, 1024),
                    dtype=dt, device=dev)
            if cfg.n_codebooks:
                b["tokens"] = b["tokens"][..., None].repeat_interleave(
                    cfg.n_codebooks, -1)
                b["labels"] = b["labels"][..., None].repeat_interleave(
                    cfg.n_codebooks, -1)
            return forward_loss(p, b, cfg)

        params, history = train(loss_fn, params, batches, tcfg,
                                lr_schedule=sched, log=log)
    if history:
        log(f"final loss {history[-1]['loss']:.4f} ({len(history)} steps)")
    return params, history


def _rank(mesh, argv: list[str]) -> dict:
    """One run of ``argv``: on one device when ``mesh`` is None, else as
    this rank of ``mesh``. Its summary: the history, the peak device
    memory, the collectives of its first step by op ({op: count}; none
    on one device) and, on one device, the trained params."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device if mesh is None else mesh.device_type)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    counts: dict = {}
    params, history = run(args, mesh, None if mesh is None else counts)
    out = {"history": history, "collectives_step0": counts,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda
           else None}
    if mesh is None:
        out["params"] = params
    return out


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line when None) and train. Returns
    (ranks, history): ``ranks`` a summary per rank, one on one device
    ({history, peak_bytes (None on the CPU), collectives_step0, and on
    one device the trained ``params``; on a mesh they stay on the
    ranks}), ``history`` rank 0's."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    dims, _ = make_mesh(args.mesh)
    if math.prod(dims) == 1:
        ranks = [_rank(None, argv)]
    else:
        # the ranks unpickle ``_rank`` from this module by its import name
        from repro_torch.launch import train as launcher
        ranks = spawn_ranks(launcher._rank, dims, argv, device=args.device,
                            timeout_s=600.0 + 120.0 * args.steps)
    return ranks, ranks[0]["history"]


if __name__ == "__main__":
    main()

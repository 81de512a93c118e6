"""Training entry point, the port of ``repro.launch.train``: one card.

Runs the fault-tolerant training loop on synthetic char-LM data, with
the JAX launcher's flags and defaults (batch 8, seq 128, lr 1e-3,
``linear_warmup_cosine`` with warmup 10, ``CharLMTask(vocab=min(vocab,
256))``, checkpoints every 50 steps).

  python -m repro_torch.launch.train --arch gemma-2b --reduced --steps 50 \\
      --device cpu
  python -m repro_torch.launch.train --arch gemma-2b --steps 8   # the card

On one device JAX's ``make_mesh`` gives a 1x1 mesh, on which its
parameter, batch and activation placements replicate everything: that
is the case this runs. A mesh of more than one device raises (ROADMAP
item 20: the dense placements; item 23: the torchrun launcher).
``--reduced`` uses the smoke-scale config (fp32); otherwise the full
assigned config is built on the device (gemma-2b: 3.03 B parameters in
bf16, ~45 GB with AdamW's fp32 moments).
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import CharLMTask, lm_batch_iterator, sharded_batches
from repro_torch.models import forward_loss, init_params
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import TrainConfig, train


def mesh_dims(spec: str | None) -> tuple[int, ...]:
    """The mesh the run asks for: ``--mesh`` ("16x16", "2x16x16") or one
    device, (1, 1). Only a mesh of one device runs."""
    dims = tuple(int(x) for x in spec.split("x")) if spec else (1, 1)
    if math.prod(dims) > 1:
        raise NotImplementedError(
            f"mesh {dims}: training over more than one device waits for "
            f"ROADMAP item 20 (param_specs, batch_specs, activation_rules) "
            f"and item 23 (the torchrun launcher); this launcher runs one "
            f"card")
    return dims


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line when None), train, and return
    (params, history)."""
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
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced and cfg.n_img_tokens:
        args.seq = max(args.seq, cfg.n_img_tokens + 32)
    dims = mesh_dims(args.mesh)
    dev = resolve_device(args.device)
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"mesh={dict(zip(axes, dims))} device={dev}")

    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
    batches = sharded_batches(lm_batch_iterator(task, args.batch, args.seq),
                              device=dev)
    tcfg = TrainConfig(lr=args.lr, steps=args.steps, log_every=10,
                       ckpt_dir=args.ckpt, ckpt_every=50)
    sched = linear_warmup_cosine(args.lr, warmup=10, steps=args.steps)
    dt = getattr(torch, cfg.dtype)

    def loss_fn(p, b):
        b = dict(b)
        if cfg.n_img_tokens:
            b["img_embeds"] = torch.zeros(
                (b["tokens"].shape[0], cfg.n_img_tokens, 1024), dtype=dt,
                device=dev)
        if cfg.n_codebooks:
            b["tokens"] = b["tokens"][..., None].repeat_interleave(
                cfg.n_codebooks, -1)
            b["labels"] = b["labels"][..., None].repeat_interleave(
                cfg.n_codebooks, -1)
        return forward_loss(p, b, cfg)

    params, history = train(loss_fn, params, batches, tcfg,
                            lr_schedule=sched)
    if history:
        print(f"final loss {history[-1]['loss']:.4f} "
              f"({len(history)} steps)")
    return params, history


if __name__ == "__main__":
    main()

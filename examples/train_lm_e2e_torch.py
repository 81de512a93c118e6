"""End-to-end training on the PyTorch port: char-LM with ADMM-CSB
pruning, periodic checkpointing + auto-resume, straggler telemetry. The
counterpart of ``examples/train_lm_e2e.py``.

The default config (~2M params, 200 steps) runs on the CPU in a few
minutes with ``--device cpu``; ``--big`` selects a ~100M-param decoder
for the card. ``--prune`` runs ADMM-CSB on the FFN weights at 4x
(32x32 blocks), finalized at the end.

Run:  PYTHONPATH=src python examples/train_lm_e2e_torch.py --device cpu
      [--big] [--steps N] [--prune] [--ckpt DIR]
"""
import argparse

import torch

from repro_torch.core import CSBSpec, density
from repro_torch.data import CharLMTask, lm_batch_iterator
from repro_torch.models import ModelConfig, forward_loss, init_params
from repro_torch.optim import linear_warmup_cosine
from repro_torch.train import TrainConfig, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true", help="~100M params")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--prune", action="store_true", help="ADMM-CSB on FFN")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    if args.big:
        cfg = ModelConfig(name="charlm-100m", mixer="attn", ffn="swiglu",
                          n_layers=12, d_model=768, n_heads=12, n_kv=4,
                          head_dim=64, d_ff=3072, vocab=256, dtype="float32")
    else:
        cfg = ModelConfig(name="charlm-2m", mixer="attn", ffn="swiglu",
                          n_layers=4, d_model=128, n_heads=4, n_kv=2,
                          head_dim=32, d_ff=512, vocab=64, dtype="float32",
                          remat=False)

    print(f"model: {cfg.name}, {cfg.param_count():,} params")
    dev = torch.device(args.device or "cuda")
    task = CharLMTask(vocab=cfg.vocab, seed=0)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)

    specs = None
    if args.prune:
        spec = CSBSpec(bm=32, bn=32, prune_rate=0.75)
        specs = {k: None for k in params if k != "layers"}
        specs["layers"] = [
            {"norm1": None, "norm2": None,
             "mixer": {k: None for k in lp["mixer"]},
             "ffn": {k: spec for k in ("w_gate", "w_up", "w_down")}}
            for lp in params["layers"]]
        print("ADMM-CSB pruning enabled on FFN weights (4x)")

    tcfg = TrainConfig(
        lr=3e-3 if not args.big else 6e-4,
        steps=args.steps,
        log_every=10,
        ckpt_dir=args.ckpt,
        ckpt_every=50,
        admm_every=25 if args.prune else 0,
        optimizer="adamw",
    )
    sched = linear_warmup_cosine(tcfg.lr, warmup=20, steps=args.steps)
    params, history = train(
        lambda p, b: forward_loss(p, b, cfg),
        params,
        lm_batch_iterator(task, args.batch, args.seq),
        tcfg,
        lr_schedule=sched,
        csb_specs=specs,
    )
    first = sum(h["loss"] for h in history[:10]) / max(len(history[:10]), 1)
    last = sum(h["loss"] for h in history[-10:]) / max(len(history[-10:]), 1)
    print(f"\nloss: {first:.3f} -> {last:.3f} over {len(history)} steps")
    out = {"first": first, "last": last, "steps": len(history)}
    if args.prune:
        out["density"] = max(float(density(lp["ffn"][k]))
                             for lp in params["layers"]
                             for k in ("w_gate", "w_up", "w_down"))
        print(f"final FFN density (largest of the layers' w_gate, w_up, "
              f"w_down): {out['density']:.3f} (target 0.25)")
    return out


if __name__ == "__main__":
    main()

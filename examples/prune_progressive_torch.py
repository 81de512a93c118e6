"""Paper Algorithm 1 end-to-end on the PyTorch port: auto lossless CSB
pruning. The counterpart of ``examples/prune_progressive.py``.

Trains a small GRU classifier on the synthetic sentiment task, then runs
the progressive ADMM-CSB flow (``core.ProgressivePruner``) to find the
maximum lossless pruning rate: each round trains from the same start,
ADMM-pruned at the round's rate (8x8 blocks on the cell's matrices), and
a round is lossless when its accuracy is within 0.02 of the dense one.

Run:  PYTHONPATH=src python examples/prune_progressive_torch.py [--fast]
      [--cpu]     (the card unless --cpu)
"""
import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import CSBSpec, ProgressivePruner
from repro_torch.train.classifier import train_rnn_classifier

SEED = 0


def pruned_specs(dense_params: dict, rate: float) -> dict:
    """A ``CSBSpec(8, 8, rate)`` for every matrix of the cell (not the
    embedding or the readout), None elsewhere."""
    spec = CSBSpec(bm=8, bn=8, prune_rate=rate)
    return {k: (spec if w.ndim == 2 and k not in ("emb", "out") else None)
            for k, w in dense_params.items()}


def main(argv=None, start: dict | None = None) -> dict:
    """Run the flow; ``start`` (the classifier's flat params) is every
    run's start, drawn from a seeded generator when None. Returns the
    dense accuracy, the lossless bar, each round's (rate, accuracy,
    lossless) and the controller."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    fast = args.fast

    def run(steps, specs=None):
        return train_rnn_classifier(
            "gru", steps=steps, specs=specs, seed=SEED,
            generator=torch.Generator().manual_seed(SEED), device=dev,
            params=start)

    print("=== baseline (dense) training ===")
    cell, dense_params, acc_fn = run(40 if fast else 80)
    baseline = acc_fn()
    lossless = baseline - 0.02
    print(f"dense accuracy: {baseline:.3f}  (lossless bar: {lossless:.3f})\n")

    ctl = ProgressivePruner(init_pr=0.25, init_step=0.25)
    history = []
    models = []
    while not ctl.done and len(history) < (3 if fast else 8):
        rate = ctl.prune_rate
        _, pruned, acc2 = run(30 if fast else 60,
                              pruned_specs(dense_params, rate))
        acc = acc2()
        ok = acc >= lossless
        history.append((rate, acc, ok))
        models.append(pruned)
        print(f"rate {rate:.3f} ({1/(1-rate):.1f}x): acc {acc:.3f} "
              f"{'LOSSLESS' if ok else 'over-pruned'}")
        ctl.update(ok)

    print(f"\nbest lossless rate: {ctl.best_lossless_rate:.3f} "
          f"=> {ctl.best_compression:.1f}x compression")
    return {"cell": cell, "baseline": baseline, "lossless": lossless,
            "history": history, "models": models, "controller": ctl,
            "device": dev}


if __name__ == "__main__":
    main()

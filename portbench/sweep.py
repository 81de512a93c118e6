"""The throughput knee of a configuration under a closed-loop mix: one run
at each slot count, each line printed as it ends (and kept in
``chiprun_out/sweep_<config>.jsonl``).

    python portbench/sweep.py --config sr1 --traffic offline --seed 11 \\
        --seconds 10 --slots 1024 2048 4096 8192 16384 32768
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, this directory heads sys.path; its modules are
# imported as the package ``portbench`` from the root instead
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--slots", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import spec
    cfg = spec.config(args.config)
    driver = spec.module("drivers", cfg["driver"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(2)
    out = ROOT / "chiprun_out" / f"sweep_{args.config}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for i, slots in enumerate(args.slots):
        mix = {**spec.traffic(args.traffic), "slots": slots}
        torch.cuda.reset_peak_memory_stats(device)
        r = driver.run(cfg, mix, args.seed + i, args.seconds, False, device,
                       time.perf_counter())
        line = {"config": args.config, "slots": slots, "seed": args.seed + i,
                **r["e2e"], "chunks": r["attempted"],
                "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                **r["checks"]}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del r
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

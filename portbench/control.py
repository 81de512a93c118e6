"""The two readings each limit of ``configs/<config>.json`` is set from:
the compared numbers of sound runs of the program over many seeds, and
of the control, the reference put in the program's place with its
products in TF32 (the precision below the configuration's fp32); and,
as a witness of the reference's own rounding, of the reference in fp64
in the program's place. One process, one line per run (also kept in
``chiprun_out/control_<cell>.jsonl``), then the largest program reading
and the smallest control reading of each number. The control and the
witness are faster than the program: give them a window that runs about
as many chunks as the program's does (``--control-seconds``).

    python portbench/control.py --workload sr1.offline --seconds 30 \\
        --control-seconds 3 --program-seeds 1 2 3 4 5 6 7 8 9 10 11 12 \\
        --control-seeds 21 22 23 --witness-seeds 31 32 33
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# run as a script, this directory heads sys.path; its modules are
# imported as the package ``portbench`` from the root instead
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import spec
    cell = spec.workload(spec.benchmark(ROOT), args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    driver = spec.module("drivers", cfg["driver"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(2)
    out = ROOT / "chiprun_out" / f"control_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    worst: dict = {}
    runs = ([("program", s) for s in args.program_seeds]
            + [("tf32", s) for s in args.control_seeds]
            + [("fp64", s) for s in args.witness_seeds])
    short = args.control_seconds or args.seconds
    for system, seed in runs:
        seconds = args.seconds if system == "program" else short
        r = driver.run(cfg, mix, seed, seconds, False, device,
                       time.perf_counter(), system=system)
        line = {"workload": args.workload, "system": system, "seed": seed,
                **r["checks"], "chunks": r["attempted"], **r["e2e"]}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        pick = min if system == "tf32" else max
        for k in cfg["limits"]:
            key = (system, k)
            worst[key] = pick(worst.get(key, r["checks"][k]), r["checks"][k])
        del r
        torch.cuda.empty_cache()
    print(json.dumps({f"{s}.{k}": v for (s, k), v in worst.items()}),
          flush=True)


if __name__ == "__main__":
    main()

"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It makes the cell's weights and traffic
from the seed, warms up every shape the cell uses (the set-up), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics (from a
short profiled slice of the window) with ``--trace 1``. The numbers
compared, each beside its limit, close standard error and the line.
It exits nonzero and prints no result without enough CUDA devices, when
the program is missing, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, this directory heads sys.path; its modules are
# imported as the package ``portbench`` from the root instead
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def checks_of(cfg: dict, checks: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit, and whether all hold."""
    out, ok = {}, True
    for name, limit in cfg["limits"].items():
        value = checks[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit   # a NaN fails
    return ok, out


def result_line(bench: dict, cell: str, cfg: dict, r: dict, trace: bool,
                card: str, base: Path | None = None) -> dict:
    """The result's JSON line; metric readers are found under ``base``
    (this directory by default)."""
    from portbench import spec
    base = spec.HERE if base is None else base
    correct, compared = checks_of(cfg, r["checks"])
    correct = correct and r["checks"]["compared"] > 0
    metrics = {}
    if trace:
        for m in spec.per_layer_metrics(bench, cell):
            v = spec.module("metrics", m["name"], base).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.end_to_end_metrics(bench, cell):
            metrics[m["name"]] = {"value": r["e2e"][m["name"]],
                                  "unit": m["unit"]}
    device = dict(r["device"])
    line = {"correct": bool(correct), "attempted": r["attempted"],
            "failed": r["failed"], "metrics": metrics, "device": device,
            "card": card}
    sl = r["window"].slice
    if trace and sl is not None:
        device["busy_s"] = sl.busy_us / 1e6
        device["window_s"] = sl.window_us / 1e6
        line["breakdown"] = {"device_ops": sl.top_ops(),
                             "idle_gaps": sl.top_idle()}
    line["compared"] = compared
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the program (src/repro_torch) is not in {ROOT}")
    # the port's nvcc build, and any kernel cache, stay in the checkout
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    from portbench import spec
    bench = spec.benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available", 3)
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['name']} needs {cell['chips']} CUDA devices, "
             f"{torch.cuda.device_count()} visible", 3)
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    serve(bench, cell, cfg, mix, args.seed, args.seconds, bool(args.trace),
          device)


def serve(bench: dict, cell: dict, cfg: dict, mix: dict, seed: int,
          seconds: float, trace: bool, device, base: Path | None = None
          ) -> None:
    """Everything of a run after the look for the card: the driver's run,
    the result's line, the compared numbers last on standard error, and
    the line last on standard output, unless JAX or the JAX package was
    loaded by then (by the program or by any part of the benchmark,
    metric readers too): then it exits nonzero and prints no result."""
    from portbench import spec
    base = spec.HERE if base is None else base
    driver = spec.module("drivers", cfg["driver"], base)
    r = driver.run(cfg, mix, seed, seconds, trace, device, T_START)
    line = result_line(bench, cell["name"], cfg, r, trace, card_line(),
                       base)
    model = r["model"]
    dense = sum(e["dense"].numel() for layer in model.weights
                for e in layer.values() if "row_mask" in e)
    live = model.work.flops_per_row // 2
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   r["setup_phases"].items()),
          file=sys.stderr)
    print(f"live weights {live} of {dense} ({dense / live:.3f}x)",
          file=sys.stderr)
    print(f"compared {r['checks']['compared']} outputs of "
          f"{cell['name']}: correct {line['correct']}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    bad = spec.forbidden_modules()
    if bad:
        fail(f"JAX or the JAX package was loaded: {bad}", 4)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Where the device idles inside the port's frame path, and how long the
host takes to enqueue a frame-step: a cell of ``BENCHMARK.json`` run
through the benchmark's own driver with ``repro_torch.obs`` enabled, so
that ``rnn_serve_frames``' ``serve/frames/*`` spans are ranges of a
profiler's trace, on the device trace's clock.

    python tools/frame_spans.py --workload sr1.offline --seed 7 --seconds 10

Needs a CUDA device. In one process it runs:

- untraced windows with ``repro_torch.obs`` disabled and enabled in turn
  (off, on, on, off): the cost of tracing on, in ``frames_per_s``; with
  it on, ``host_ms_per_step`` on the tracer's own clock, the enqueue of
  a frame-step with no profiler recording;
- one traced window each way: the harness's own slice, whose
  ``idle_gaps`` (``Slice.top_idle``) name the device's idle by the
  innermost host event, the program's spans among them when on;
- ``CHUNKS`` untraced chunks of the driver's window under a profiler,
  with ``obs`` on, read by ``read_spans``:

  - ``call_idle_ms_per_chunk``: the device's idle time inside
    ``serve/frames/call`` spans, over the chunks;
  - ``host_ms_per_step``: the summed ``serve/frames/step`` spans (the
    host's enqueue of one layer-frame each), over the frame-steps (one
    step of the batch through every layer).

Prints one JSON line; with ``--out``, writes it there too.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import devtrace, spec  # noqa: E402

PREFIX = "serve/frames/"
CALL = PREFIX + "call"
STEP = PREFIX + "step"
# untraced windows, tracing off (False) and on (True) in turn
ORDER = (False, True, True, False)
# chunks profiled for ``read_spans``, after the driver's warm-up
CHUNKS = 3
READERS = ("b1_ms_per_step", "nonmvm_ms_per_step", "kernels_per_step",
           "device_idle_pct")


def _busy_us(ops: list, a: float, b: float) -> float:
    """The time in [a, b] in which some device operation of ``ops`` ran."""
    busy, end = 0.0, a
    for o in sorted(ops, key=lambda o: o.ts):
        lo, hi = max(o.ts, end), min(o.ts + o.dur, b)
        if hi > lo:
            busy += hi - lo
            end = hi
    return busy


def read_spans(events: list[dict], chunks: int, steps: int) -> dict:
    """The two numbers of the module docstring, and the spans counted by
    name, from the trace of ``chunks`` chunks and ``steps`` frame-steps."""
    ops = devtrace.read(events).ops
    spans = [(str(e["name"]), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X" and "dur" in e
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    calls = [(a, b) for name, a, b in spans if name == CALL]
    return {
        "call_idle_ms_per_chunk": sum(b - a - _busy_us(ops, a, b)
                                      for a, b in calls) / 1e3 / chunks,
        "host_ms_per_step": sum(b - a for name, a, b in spans
                                if name == STEP) / 1e3 / steps,
        "call_ms_per_chunk": sum(b - a for a, b in calls) / 1e3 / chunks,
        "spans": dict(Counter(name for name, _, _ in spans)),
    }


def profiled(cfg: dict, mix: dict, seed: int, device) -> dict:
    """``read_spans`` of ``CHUNKS`` chunks of the driver's untraced window,
    after its warm-up, with ``repro_torch.obs`` on and a profiler
    recording."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers import rnn_frames
    from portbench.generator import Traffic
    from repro_torch import obs
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.inference_mode():
        model = rnn_frames.make_model(cfg, mix, seed, device)
        prog = rnn_frames.Program(cfg, model, device)
        rnn_frames.run_window(prog, model, Traffic(mix, seed), 0.0, False,
                              device, chunks=rnn_frames.WARMUP_CHUNKS)
        obs.trace.enable()
        try:
            with profile(activities=acts) as prof:
                rnn_frames.run_window(prog, model, Traffic(mix, seed), 0.0,
                                      False, device, chunks=CHUNKS)
        finally:
            obs.trace.disable()
    return read_spans(devtrace.chrome_events(prof), CHUNKS,
                      CHUNKS * int(mix["chunk_frames"]))


def _run(cfg, mix, seed, seconds, trace, device, on: bool):
    """The driver's run with ``repro_torch.obs`` enabled if ``on``, and
    the tracer that recorded it (None if off)."""
    from portbench.drivers import rnn_frames
    from repro_torch import obs
    if on:
        obs.trace.enable()
    try:
        r = rnn_frames.run(cfg, mix, seed, seconds, trace, device,
                           time.perf_counter())
    finally:
        tracer = obs.trace.disable()
    return r, tracer


def step_ms(tracer) -> float:
    """The mean ``serve/frames/step`` span, ms, on the tracer's own clock
    (no profiler recording)."""
    durs = [e[3] for e in tracer.events() if e[1] == STEP]
    return sum(durs) / len(durs) / 1e6


def _correct(cfg, r) -> bool:
    return r["checks"]["compared"] > 0 and all(
        r["checks"][k] <= limit for k, limit in cfg["limits"].items())


def measure(cfg: dict, mix: dict, seed: int, seconds: float,
            device) -> dict:
    """The untraced windows of ``ORDER``, the two traced ones and the
    profiled chunks."""
    out = {"untraced": [], "traced": []}
    for on in ORDER:
        r, tracer = _run(cfg, mix, seed, seconds, False, device, on)
        row = {"obs": on, **r["e2e"], "correct": _correct(cfg, r)}
        if on:
            row["host_ms_per_step"] = step_ms(tracer) * len(cfg["layers"])
        out["untraced"].append(row)
    for on in (False, True):
        r, _ = _run(cfg, mix, seed, seconds, True, device, on)
        sl = r["window"].slice
        row = {"obs": on, **r["e2e"], "correct": _correct(cfg, r),
               "window_ms": sl.window_us / 1e3,
               "busy_ms": sl.busy_us / 1e3, "steps": sl.steps,
               "idle_gaps": sl.top_idle(16)}
        for name in READERS:
            row[name] = spec.module("metrics", name).read(r)
        out["traced"].append(row)
    out["profiled"] = profiled(cfg, mix, seed, device)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("frame_spans: needs a CUDA device")
    from portbench.run import card_line
    cell = spec.workload(spec.benchmark(ROOT), args.workload)
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = {"workload": cell["name"], "seed": args.seed,
           "seconds": args.seconds, "card": card_line(),
           "device": torch.cuda.get_device_name(device),
           **measure(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                     args.seed, args.seconds, device)}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()

"""Reading a profiled slice of the window from torch.profiler's Chrome
trace: the device operations, which of them the program's calls
launched, the device's busy time, and its idle gaps by what the host was
doing at the time."""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the range the harness opens around the program's calls
SERVE = "portbench/serve"
# the device name of the program's kernel B1 (``csrc/csb_mvm.cu``)
B1_KERNEL = "csb_mvm_kernel"
NAME_CHARS = 160


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    ts: float      # us, the trace's clock
    dur: float     # us
    serve: bool    # launched inside a SERVE range


@dataclasses.dataclass
class Slice:
    """What one profiled slice of chunks holds. ``steps`` frame-steps
    (chunks x frames a chunk) carried ``true_rows`` stream-frames."""

    window_us: float
    busy_us: float
    ops: list[DeviceOp]
    idle_by_host: dict[str, float]
    steps: int = 0
    true_rows: int = 0

    def serve_kernels(self) -> list[DeviceOp]:
        return [o for o in self.ops if o.serve and o.cat == "kernel"]

    def b1_kernels(self) -> list[DeviceOp]:
        return [o for o in self.serve_kernels() if B1_KERNEL in o.name]

    def top_ops(self, n: int = 10) -> list[list]:
        by = defaultdict(float)
        for o in self.ops:
            by[o.name[:NAME_CHARS]] += o.dur
        return [[k, v / 1e6] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> list[list]:
        return [[k, v / 1e6] for k, v in sorted(
            self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]]


def chrome_events(prof) -> list[dict]:
    """The events of a finished ``torch.profiler.profile``, through a
    Chrome trace written to (and removed from) the temporary directory."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            obj = json.load(f)
    finally:
        os.unlink(path)
    return obj["traceEvents"] if isinstance(obj, dict) else obj


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_labels(host: list[dict], points: list[float]) -> list[str]:
    """For each time in ``points`` (sorted), the name of the innermost
    host event that spans it."""
    evs = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    stack: list[dict] = []
    labels, j = [], 0
    for p in points:
        while j < len(evs) and evs[j]["ts"] <= p:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= evs[j]["ts"]:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < p:
            stack.pop()
        labels.append(stack[-1]["name"][:NAME_CHARS] if stack
                      else "(no host event)")
    return labels


def read(events: list[dict]) -> Slice:
    """The slice between the first and the last ``ProfilerStep`` range of
    the trace."""
    steps = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("ProfilerStep#")
             and e.get("cat") != "gpu_user_annotation"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if steps:
        w0 = min(float(e["ts"]) for e in steps)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    elif dev:
        w0 = min(float(e["ts"]) for e in dev)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    else:
        return Slice(0.0, 0.0, [], {})
    serve = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
             if e.get("name") == SERVE and e.get("cat") == "user_annotation"]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}

    def in_serve(e) -> bool:
        # launched inside a SERVE range; where the trace holds no launch
        # for the operation, started inside one (the harness synchronises
        # before each profiled SERVE range, so nothing launched earlier
        # still runs there)
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            t = float(e["ts"])
        return any(a <= t <= b for a, b in serve)

    ops = [DeviceOp(str(e["name"]), e["cat"], float(e["ts"]), float(e["dur"]),
                    in_serve(e)) for e in dev
           if float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy = _union([(max(o.ts, w0), min(o.ts + o.dur, w1)) for o in ops])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    threads = {(e.get("pid"), e.get("tid")) for e in xs
               if e.get("name") == SERVE}
    host = [e for e in xs if e.get("cat") in HOST_CATS
            and (e.get("pid"), e.get("tid")) in threads
            and not str(e.get("name", "")).startswith("ProfilerStep#")]
    idle: dict[str, float] = defaultdict(float)
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), label in zip(gaps, _host_labels(host, mids)):
        idle[label] += b - a
    return Slice(w1 - w0, sum(b - a for a, b in busy), ops, dict(idle))

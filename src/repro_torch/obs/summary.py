"""Trace post-processing: latency breakdowns from a Chrome-trace file.

Library half of ``tools/trace_summary.py`` (importable so the docs
snippets and tests run it in-process). Works on any file
:func:`repro_torch.obs.trace.Tracer.export_chrome` wrote — and on any
conforming ``trace_event`` JSON: only ``ph``/``name``/``ts``/``dur``
are read.

Two views:

* :func:`summarize` — one row per span *name*: count, total wall time
  and exact nearest-rank percentiles over the span durations. Sorted by
  total time, this is the "where do the microseconds go" table.
* :func:`request_table` — the serve request lifecycle: rows for the
  ``serve/req/*`` spans the engine emits (queue wait, prefill, TTFT,
  decode), i.e. per-request latency distributions rather than
  per-span-site ones.
"""
from __future__ import annotations

import json
import math


def load_trace(path: str) -> list[dict]:
    """Events from a Chrome-trace JSON file (object with
    ``traceEvents`` or a bare event array)."""
    with open(path) as f:
        obj = json.load(f)
    return obj["traceEvents"] if isinstance(obj, dict) else obj


def _pct(sorted_vals: list[float], q: float) -> float:
    rank = max(math.ceil(q / 100.0 * len(sorted_vals)), 1)
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def summarize(events: list[dict]) -> list[dict]:
    """Per-name duration stats over the X (complete) events, sorted by
    total time descending. Durations are Chrome-trace microseconds."""
    by_name: dict[str, list[float]] = {}
    for ev in events:
        if ev.get("ph") == "X" and "dur" in ev:
            by_name.setdefault(ev["name"], []).append(float(ev["dur"]))
    rows = []
    for name, durs in by_name.items():
        durs.sort()
        total = sum(durs)
        rows.append({
            "name": name,
            "count": len(durs),
            "total_us": total,
            "mean_us": total / len(durs),
            "p50_us": _pct(durs, 50),
            "p95_us": _pct(durs, 95),
            "p99_us": _pct(durs, 99),
            "max_us": durs[-1],
        })
    rows.sort(key=lambda r: -r["total_us"])
    return rows


# the engine's per-request lifecycle spans, in pipeline order
REQUEST_SPANS = ("serve/req/queue_wait", "serve/req/prefill",
                 "serve/req/ttft", "serve/req/decode")


def request_table(events: list[dict]) -> list[dict]:
    """The :func:`summarize` rows restricted to the request-lifecycle
    spans, in lifecycle order (queue wait -> prefill -> TTFT ->
    decode). Empty when the trace has no serve run in it."""
    rows = {r["name"]: r for r in summarize(events)}
    return [rows[n] for n in REQUEST_SPANS if n in rows]


def format_table(rows: list[dict], title: str = "span") -> str:
    """Fixed-width text table for terminal output."""
    if not rows:
        return "(no complete events)"
    w = max(len(title), max(len(r["name"]) for r in rows))
    hdr = (f"{title:<{w}}  {'count':>6}  {'total_ms':>9}  {'mean_us':>9}"
           f"  {'p50_us':>9}  {'p95_us':>9}  {'p99_us':>9}  {'max_us':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['name']:<{w}}  {r['count']:>6}"
            f"  {r['total_us'] / 1e3:>9.2f}  {r['mean_us']:>9.1f}"
            f"  {r['p50_us']:>9.1f}  {r['p95_us']:>9.1f}"
            f"  {r['p99_us']:>9.1f}  {r['max_us']:>9.1f}")
    return "\n".join(lines)


def report(path: str) -> str:
    """The full trace_summary CLI output for one trace file."""
    events = load_trace(path)
    parts = [f"trace: {path} ({len(events)} events)", "",
             format_table(summarize(events))]
    req = request_table(events)
    if req:
        parts += ["", "request lifecycle (per-request distributions):",
                  format_table(req, title="stage")]
    return "\n".join(parts)


__all__ = ["load_trace", "summarize", "request_table", "format_table",
           "report", "REQUEST_SPANS"]

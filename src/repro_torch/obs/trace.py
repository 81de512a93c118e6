"""Low-overhead span tracer (a copy of ``repro.obs.trace``, which has no
JAX code; the event format is identical) with a Chrome ``trace_event`` exporter.

The serve/train stacks are instrumented with *spans* (begin/end pairs),
*instants* (point events) and externally-timed *complete* events, all
written into a **preallocated ring buffer** — recording is an index
bump plus a tuple store, never a list growth, so a multi-minute serve
run traces at a bounded memory footprint (the oldest events fall off;
``dropped`` counts them).

Tracing is **off by default** and the disabled path is a no-op fast
path: module-level helpers read one global, compare against ``None``
and return a shared singleton — no dict, no tuple, no timestamps.
Instrumented code therefore stays on the timed serve paths without
moving them.

Export targets the Chrome ``trace_event`` JSON format (the
``traceEvents`` array of ``ph``/``ts``/``pid``/``tid``/``name``
objects), so a trace written by :func:`export_chrome` loads directly in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``. Spans from
different logical *tracks* (the engine loop, each request's lifecycle)
render as separate named rows via ``thread_name`` metadata events.

Usage::

    from repro_torch.obs import trace
    trace.enable()                       # returns the live Tracer
    with trace.span("serve/decode_step"):
        ...
    trace.instant("sched/page_stall", args={"rid": 3})
    trace.export_chrome("trace.json")    # -> Perfetto
    trace.disable()

``tools/trace_summary.py`` prints latency breakdowns (exact
percentiles per span name, request-lifecycle table) from the exported
file.
"""
from __future__ import annotations

import json
import os
import threading
import time


class _NullSpan:
    """Shared do-nothing context manager the disabled paths hand out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context-manager handle pairing one ``begin`` with its ``end``."""

    __slots__ = ("_tracer", "_name", "_track", "_args", "_t0")

    def __init__(self, tracer, name, track, args):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._record("X", self._name, self._t0, t1 - self._t0,
                             self._track, self._args)
        return False


class Tracer:
    """Ring-buffered event store (see module docstring).

    ``capacity`` bounds the live event count; recording past it
    overwrites the oldest events and bumps :attr:`dropped`.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        # preallocated ring: slot i % capacity holds event i
        self._ring: list = [None] * capacity
        self._n = 0                     # events ever recorded
        self._lock = threading.Lock()
        self._stacks = threading.local()
        self._t0 = time.perf_counter_ns()

    # -- recording -----------------------------------------------------------
    def _record(self, ph, name, ts_ns, dur_ns, track, args) -> None:
        tid = (track if track is not None
               else f"thread-{threading.get_ident() & 0xffff}")
        with self._lock:
            self._ring[self._n % self.capacity] = (
                ph, name, ts_ns, dur_ns, tid, args)
            self._n += 1

    def span(self, name: str, track: str | None = None,
             args: dict | None = None) -> _Span:
        """Context manager timing its ``with`` body as one X event."""
        return _Span(self, name, track, args)

    def begin(self, name: str, track: str | None = None,
              args: dict | None = None) -> None:
        """Open a nested span on this thread (pair with :meth:`end`)."""
        stack = getattr(self._stacks, "open", None)
        if stack is None:
            stack = self._stacks.open = []
        stack.append((name, track, args, time.perf_counter_ns()))

    def end(self, args: dict | None = None) -> None:
        """Close the innermost :meth:`begin` span; ``args`` merge over
        the ones passed to ``begin``."""
        t1 = time.perf_counter_ns()
        name, track, a0, t0 = self._stacks.open.pop()
        if args:
            a0 = {**(a0 or {}), **args}
        self._record("X", name, t0, t1 - t0, track, a0)

    def instant(self, name: str, track: str | None = None,
                args: dict | None = None) -> None:
        self._record("i", name, time.perf_counter_ns(), 0, track, args)

    def complete(self, name: str, t0_ns: int, dur_ns: int,
                 track: str | None = None, args: dict | None = None) -> None:
        """Record an externally-timed span (timestamps from
        :meth:`now_ns`) — zero timing overhead at the measured site."""
        self._record("X", name, t0_ns, dur_ns, track, args)

    def now_ns(self) -> int:
        """Clock for :meth:`complete` (``time.perf_counter_ns``)."""
        return time.perf_counter_ns()

    # -- introspection / export ----------------------------------------------
    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        return max(self._n - self.capacity, 0)

    def events(self) -> list[tuple]:
        """Live events, oldest first (raw internal tuples)."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return [e for e in self._ring[:n]]
            head = n % cap
            return self._ring[head:] + self._ring[:head]

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON object (``traceEvents`` array).

        Timestamps are microseconds relative to tracer start; every
        event carries the required ``ph``/``ts``/``pid``/``tid``/
        ``name`` fields, and each distinct track gets a ``thread_name``
        metadata event so Perfetto labels the rows.
        """
        pid = os.getpid()
        tids: dict[str, int] = {}
        out = []
        for ph, name, ts_ns, dur_ns, track, args in self.events():
            tid = tids.setdefault(track, len(tids) + 1)
            ev = {
                "ph": ph,
                "name": name,
                "ts": (ts_ns - self._t0) / 1e3,
                "pid": pid,
                "tid": tid,
                "cat": "repro",
            }
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            if ph == "i":
                ev["s"] = "t"           # instant scope: thread
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        meta = [
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "ts": 0, "args": {"name": track}}
            for track, tid in tids.items()
        ]
        return {"traceEvents": meta + out,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome(self, path: str) -> str:
        """Write :meth:`to_chrome` as JSON; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# ---------------------------------------------------------------------------
# process-global tracer: module functions are the instrumentation API
# ---------------------------------------------------------------------------

_tracer: Tracer | None = None           # None <=> tracing disabled


def enable(capacity: int = 65536) -> Tracer:
    """Install a fresh process-global tracer and return it."""
    global _tracer
    _tracer = Tracer(capacity)
    return _tracer


def disable() -> Tracer | None:
    """Stop tracing; returns the tracer that was live (export still
    works on it) or None."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def enabled() -> bool:
    return _tracer is not None


def get() -> Tracer | None:
    """The live tracer, or None when disabled. Hot loops fetch this
    once and branch on ``is not None`` — the cheapest gate."""
    return _tracer


def span(name, track=None, args=None):
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, track, args)


def instant(name, track=None, args=None):
    t = _tracer
    if t is None:
        return
    t.instant(name, track, args)


def export_chrome(path: str) -> str | None:
    """Export the live tracer's events; None when tracing is off."""
    t = _tracer
    if t is None:
        return None
    return t.export_chrome(path)


__all__ = ["Tracer", "enable", "disable", "enabled", "get", "span",
           "instant", "export_chrome"]

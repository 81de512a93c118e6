"""repro_torch.obs — tracing + metrics for the port's serve path.

A copy of ``repro.obs`` (which has no JAX code): the same off-by-default
span tracer with a Chrome ``trace_event`` exporter, so
``tools/trace_summary.py`` reads a trace of the port unchanged, and the
same metrics registry. ``rnn_serve_frames`` records ``serve/frame``
spans and the ``serve/frames/wall_us`` histogram when they are enabled.

    from repro_torch.obs import enable_all, disable_all, trace, metrics
    enable_all()
    ... serve ...
    trace.export_chrome("trace.json")
    disable_all()
"""
from . import metrics, summary, trace


def enable_all(trace_capacity: int = 65536):
    """Enable tracing AND metrics; returns (tracer, registry)."""
    return trace.enable(trace_capacity), metrics.enable()


def disable_all():
    """Disable both; returns (tracer, registry) that were live."""
    return trace.disable(), metrics.disable()


__all__ = ["trace", "metrics", "summary", "enable_all", "disable_all"]

"""Frame-by-frame RNN serving — the paper's own serving shape, ported
from ``repro.serve.engine.rnn_serve_frames``.

Each frame is one cell step, bound by the cell's MVMs, with
CSB-compressed weights; the engine returns per-frame outputs and the
wall-clock time per frame, so the faster-than-realtime criterion
(<500 us/frame for speech) can be checked on the card. The mesh-sharded
variant waits for the port of the multi-device layer.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.cells import CellGraph, cell_apply, init_state
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace

from .config import EngineConfig, resolve_config


def rnn_serve_frames(graph: CellGraph, params: dict, frames,
                     state: dict | None = None,
                     warmup: int | None = None,
                     *, config: EngineConfig | None = None, mesh=None,
                     collect_frame_times: bool | None = None,
                     device=None):
    """frames: (T, B, in_dim) tensor or array. Weights may be dense
    tensors or ``PaddedCSB``; they, the frames and ``state`` are moved to
    ``device`` (``None`` means the card).

    ``config.frame_warmup`` / ``config.collect_frame_times`` are the
    :class:`EngineConfig` homes of the two knobs; the positional
    ``warmup`` and ``collect_frame_times`` arguments override them when
    given explicitly.

    Returns (outputs (T,B,H), final state, us_per_frame). ``us_per_frame``
    comes from an unblocked pass over all frames that synchronises the
    device once, at its end: the throughput number.

    ``collect_frame_times=True`` appends a 4th element: a ``(T,)`` numpy
    array of per-frame wall microseconds from a second pass that waits
    for each frame before the next starts — the tail-latency (p99)
    number realtime audio cares about. That pass also records the
    ``serve/frame`` spans and the ``serve/frames/wall_us`` histogram when
    ``repro_torch.obs`` is enabled, after each frame's timing."""
    if mesh is not None:
        raise NotImplementedError(
            "rnn_serve_frames(mesh=...) waits for the multi-device slice "
            "of the port (slice 5: sharded CSB)")
    fcfg = resolve_config(config, caller="rnn_serve_frames")
    if warmup is None:
        warmup = fcfg.frame_warmup
    if collect_frame_times is None:
        collect_frame_times = fcfg.collect_frame_times
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, device=dev)
    if frames.dtype == torch.float64:
        # the JAX package computes in fp32 (x64 is off there)
        frames = frames.to(torch.float32)
    params = {k: w.to(dev) for k, w in params.items()}
    if state is None:
        state = init_state(graph, tuple(frames.shape[1:-1]), torch.float32,
                           device=dev)
    else:
        state = {k: v.to(dev) for k, v in state.items()}
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))

    def step(st, x):
        return cell_apply(graph, params, x, st)

    n = frames.shape[0]
    with torch.no_grad():
        for _ in range(warmup):
            step(state, frames[0])
        sync()

        outs = []
        t0 = time.perf_counter()
        st = state
        for t in range(n):
            y, st = step(st, frames[t])
            outs.append(y)
        sync()
        dt = time.perf_counter() - t0

        frame_us = None
        if collect_frame_times:
            # a separate pass, so the throughput number above is untouched
            # by the per-frame waits; spans and histogram are recorded
            # after each frame's timing
            tr = obs_trace.get()
            reg = obs_metrics.get()
            frame_us = np.empty(n)
            st2 = state
            for t in range(n):
                f0 = time.perf_counter_ns()
                _, st2 = step(st2, frames[t])
                sync()
                dur = time.perf_counter_ns() - f0
                frame_us[t] = dur / 1e3
                if tr is not None:
                    tr.complete("serve/frame", f0, dur, track="frames",
                                args={"frame": t})
                if reg is not None:
                    reg.histogram("serve/frames/wall_us").observe(dur / 1e3)
    us_per_frame = dt / n * 1e6
    if collect_frame_times:
        return torch.stack(outs), st, us_per_frame, frame_us
    return torch.stack(outs), st, us_per_frame

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each of which raises (and the script exits nonzero) on failure:

1. The card's name and power limit (``nvidia-smi``) and the CUDA version.
2. Build every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all started together) and print the build time.
3. Kernel phase: ``csb_matvec`` on CUDA tensors (the hand-written kernel)
   against its plain PyTorch version ``csb_mvm_ref`` on the same tensors,
   over the CPU test sweep, one, 33 and 128 block-columns and a
   block-row of empty (m = 0) blocks at batches 1, 7, 8 and 17, plus the
   SR1 matrices at batches 1, 8 and 13: within 1e-5 in fp32 (summation
   order only) and 5e-2 in bf16.
4. Slice phase: the paper's SR1 model (two LSTMP layers, 153/512 -> 1024,
   projection 512, Table 1) at full width, CSB-pruned 13x with 32x32
   blocks, weights and frames from a numpy seed, served for 200 frames at
   batch 1 through ``rnn_serve_frames``, layer 1's outputs feeding layer
   2. The kernel's launch count must grow by exactly 9 per cell step (4 W.x,
   4 U.h and the projection), and outputs and final states must agree
   within 1e-4 with the same cells run on the densified weights through
   the dense branch (fp32 summation order, compounded over 200 recurrent
   steps). Then it times the kernel, its plain version and one PyTorch
   matmul on the dense matrix for the 18 CSB MVMs of one SR1 frame: by
   CUDA events around each call, by the profiler's device time, and by
   replaying 20 calls captured in a CUDA graph (no host in the time).
5. B2 kernel phase: ``paged_attn_decode`` on CUDA tensors (the
   hand-written paged-attention kernel) against its plain version
   ``paged_attn_ref`` on the same tensors: the edge cases of the JAX
   package's paged-attention tests (vector pos at page boundaries,
   ``max_pages=1``, scratch-page inactive slots, sliding windows, the MLA
   rope term with Dv != D, a position before every key), long caches
   (8,000 and 64,000 keys), the boundaries of the key splits at gemma-2b's
   head shape (pos on a split edge and one past it, live keys in one
   split, a window that leaves one split live, an all-masked slot, a
   capacity that is not a multiple of the split, 1 and 16 slots), MLA's
   128 heads with the rope term, head dims that are not multiples of 8
   (one element per load), and gemma-2b's decode shape (H=8, KV=1,
   D=256, P=16, 4 slots, pos up to 1031); fp32 and bf16 pools, within the
   bounds of ``PAGED_TOL``. With fp32 pools, MLA's and gemma-2b's cases
   also hold the kernel, at the same bound, against the function computed
   in fp64 throughout, and print how far the plain version and the same
   formulation summed in fp32 stand from it.
6. LM slice phase: gemma-2b at full width (18 layers, d_model 2048,
   vocab 256000), random weights from a seeded generator, serving 8
   greedy requests (prompts 40..1000 tokens, 32 new tokens each,
   arrivals at steps 0..16) through ``serve_continuous(paged=True,
   page_size=16, n_slots=4)``, in fp32 and in bf16, each with the kernel
   and with the gather path. The kernels' launch count must grow by
   exactly ``2 x n_layers x decode steps`` on the kernel runs (a call
   launches the scores kernel and the PV kernel) and by 0 on the
   gather runs; the fp32 tokens of the two paths must be equal, and the
   first decode step's logits of the two paths must agree (1e-4 in fp32,
   the bf16 bound printed with its reason). Then engine metrics, peak
   memory, a torch.profiler breakdown of one bf16 decode step, and the
   kernel (its two launches) timed against its plain version,
   ``scaled_dot_product_attention`` (with and without the gather of the
   pages) and its bound at the run's busiest decode step, in the same
   three ways; the kernels one call launches and their grids are read
   from the profiler's trace.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cells import make_cell, rnn_scan  # noqa: E402
from repro_torch.configs import PAPER_MODELS, get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CSBSpec, csb_masks, csb_project, padded_csb_from_dense,
)
from repro_torch.kernels import (  # noqa: E402
    _build, csb_matvec, csb_mvm, csb_mvm_ref, densify, pad_to_grid,
    paged_attn, paged_attn_decode, paged_attn_ref,
)
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    EngineConfig, PagePool, Request, bucket_len, rnn_serve_frames,
    serve_continuous,
)
from repro_torch.serve.scheduler import (  # noqa: E402
    fit_cache_len, insert_paged_cache,
)

SEED = 0
RATE = 1 - 1 / 13          # the paper's 13x (benchmarks/bench_latency.py)
BLOCK = 32
FRAMES = 200
WARMUP = 2
FRAME_BUDGET_US = 500.0    # realtime budget per speech frame
MVMS_PER_STEP = 9          # LSTMP: 4 W.x + 4 U.h + W_proj
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12        # dense, tensor cores
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
SWEEP = [((32, 32), 16, 16), ((64, 48), 16, 16), ((48, 64), 16, 32),
         ((128, 96), 32, 32), ((40, 24), 8, 8)]
KERNEL = {
    "name": "csb_mvm",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/csb_mvm.cu",
    "replaces": "src/repro/kernels/csb_mvm.py:77",
}
PAGED_KERNEL = {
    "name": "paged_attn",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
    "replaces": "src/repro/kernels/paged_attn.py:49",
}
# the LM slice: gemma-2b served through the paged pool
ARCH = "gemma-2b"
PROMPT_LENS = (40, 97, 150, 256, 333, 512, 700, 1000)
ARRIVALS = (0, 0, 0, 0, 4, 8, 12, 16)
MAX_NEW = 32
LM_ENGINE = EngineConfig(paged=True, page_size=16, n_slots=4)
# B2 against its plain version. fp32 pools: summation order only, over
# up to 64,000 keys of |v| < 5 (the largest error seen on the H100 is
# 3.6e-7). bf16 pools: the kernel rounds q and the probabilities where the
# plain version does, so the two differ only where a probability p lands
# on the other side of a bf16 rounding boundary, which moves the output by
# 2^-8 * p * |v|; 1e-3 admits such a flip wherever p * |v| < 0.25 (none
# seen: 3.1e-7). Both are tighter than the 1e-5 / 1e-2 first stated.
PAGED_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-3}
# first decode step, kernel vs gather path: fp32 differs by summation
# order only; in bf16 every layer rounds its activations to 8 bits, so an
# attention output that lands the other side of a rounding boundary moves
# by one bf16 ulp (2^-8 relative) and carries through the later layers
LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.25}
BF16_BYTES = 2
# kernels in one bf16 decode step of gemma-2b under the first B2 design,
# one launch per layer (decode-step profile on an H100, PERF.md)
FIRST_DESIGN_KERNELS_PER_STEP = 1633
B2_NAMES = ("paged_attn_scores_kernel", "paged_attn_pv_kernel")


def card_info() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    return line


def build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.2f} s, compiled {sorted(logs) or 'nothing (cached)'}"
          f" into {_build.build_dir()}")
    for stem, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")


def pruned(rng, shape, bm, bn, rate, dev, scale=1.0):
    """A CSB-pruned matrix from ``rng``: (dense pruned z, PaddedCSB)."""
    w = torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)
    spec = CSBSpec(bm=bm, bn=bn, prune_rate=rate)
    z = csb_project(w, spec)
    rm, cm = csb_masks(w, spec)
    p = padded_csb_from_dense(z, bm, bn, row_mask=rm, col_mask=cm,
                              device=dev)
    return z, p


def with_dtype(p, dtype):
    return dataclasses.replace(p, vals=p.vals.to(dtype))


def plain(p, x, batch_tile=8):
    """The kernel's plain version on the same padded inputs, cut back."""
    x2 = x.reshape(-1, x.shape[-1])
    xp = pad_to_grid(x2, batch_tile, p.grid[1] * p.block[1]).contiguous()
    y = csb_mvm_ref(p.vals, p.row_idx, p.col_idx, p.m, p.n, xp,
                    grid=p.grid, block=p.block)
    return y[: x2.shape[0], : p.shape[0]].reshape(*x.shape[:-1], p.shape[0])


def compare(label, p, x, **kw) -> float:
    y = csb_matvec(p, x, **kw)
    ref = plain(p, x, kw.get("batch_tile", 8))
    torch.cuda.synchronize()
    tol = TOL[x.dtype]
    if y.shape != ref.shape or y.dtype != torch.float32:
        raise AssertionError(f"{label}: got {tuple(y.shape)} {y.dtype}, "
                             f"want {tuple(ref.shape)} float32")
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    if not torch.allclose(y, ref, rtol=tol, atol=tol):
        raise AssertionError(f"{label}: kernel and plain version differ, "
                             f"max abs err {err:.3e} > tol {tol}")
    return err


def kernel_phase(dev, sr1_shapes) -> float:
    """Kernel vs plain version; returns the max abs error at SR1's shapes
    in fp32."""
    rng = np.random.default_rng(SEED + 1)
    n = 0

    def x(*shape, dtype=torch.float32):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    for shape, bm, bn in SWEEP:
        for rate in (0.3, 0.75):
            _, p = pruned(rng, shape, bm, bn, rate, dev)
            for b in (1, 8, 13):
                compare(f"{shape} bm{bm} bn{bn} rate{rate} B{b}", p,
                        x(b, shape[1]))
                n += 1
    _, p = pruned(rng, (64, 64), 16, 16, 0.5, dev)
    pb = with_dtype(p, torch.bfloat16)
    for b in (1, 8, 13):
        compare(f"bf16 B{b}", pb, x(b, 64, dtype=torch.bfloat16))
        compare(f"bf16 x fp32 vals B{b}", p, x(b, 64, dtype=torch.bfloat16))
        n += 2
    for group in (1, 2, 4):
        compare(f"group {group}", p, x(4, 64), group=group)
        n += 1
    _, p = pruned(rng, (48, 32), 16, 16, 0.5, dev)
    for bs in ((), (1,), (3,), (2, 5)):
        compare(f"batch shape {bs}", p, x(*bs, 32))
        n += 1
    _, p = pruned(rng, (32, 32), 16, 16, 0.5, dev)
    for bt in (8, 16):
        compare(f"batch_tile {bt}", p, x(13, 32), batch_tile=bt)
        n += 1
    z = torch.zeros(32, 32, device=dev)
    z[:16, :16] = x(16, 16)
    p = padded_csb_from_dense(z, 16, 16, device=dev)
    if not torch.equal(densify(p), z):
        raise AssertionError("densify is not exact on empty blocks")
    compare("empty blocks", p, x(3, 32))
    n += 1
    # the parallel layout: one block-column, 33 and 128 (a 4096-wide
    # input), a block-row of m = 0 blocks only, batches around the tile
    for label, shape in (("Bc 1", (64, 32)), ("Bc 33", (64, 33 * BLOCK)),
                         ("Bc 128", (64, 128 * BLOCK))):
        _, p = pruned(rng, shape, BLOCK, BLOCK, RATE, dev)
        for b in (1, 7, 8, 17):
            compare(f"{label} B{b}", p, x(b, shape[1]))
            n += 1
    z, _ = pruned(rng, (96, 256), BLOCK, BLOCK, RATE, dev)
    z[BLOCK:2 * BLOCK] = 0
    p = padded_csb_from_dense(z, BLOCK, BLOCK, device=dev)
    if int(p.m.reshape(p.grid)[1].abs().sum()) != 0:
        raise AssertionError("block-row 1 should hold only m = 0 blocks")
    for b in (1, 7, 8, 17):
        compare(f"m = 0 block-row B{b}", p, x(b, 256))
        n += 1
    sr1_err = 0.0
    for shape in sr1_shapes:
        _, p = pruned(rng, shape, BLOCK, BLOCK, RATE, dev)
        for dtype in (torch.float32, torch.bfloat16):
            for b in (1, 8, 13):
                err = compare(f"SR1 {shape} {dtype} B{b}",
                              with_dtype(p, dtype), x(b, shape[1], dtype=dtype))
                n += 1
                if dtype == torch.float32:
                    sr1_err = max(sr1_err, err)
    print(f"kernel phase: {n} comparisons passed; max abs err at SR1 shapes "
          f"(fp32) {sr1_err:.3e}")
    return sr1_err


def build_sr1(dev):
    """SR1 at full width: per layer the cell, CSB params and the dense
    (densified) params with the same values."""
    rng = np.random.default_rng(SEED)
    layers = []
    for cfg in PAPER_MODELS["SR1"].layers:
        cell = make_cell(cfg.cell, cfg.n_input, cfg.n_hidden, cfg.proj)
        csb, dense = {}, {}
        for name, shape in cell.weight_shapes().items():
            if len(shape) == 1:
                b = torch.from_numpy(
                    (0.1 * rng.standard_normal(shape)).astype(np.float32))
                csb[name] = dense[name] = b.to(dev)
                continue
            z, p = pruned(rng, shape, BLOCK, BLOCK, RATE, dev,
                          scale=1 / math.sqrt(shape[1]))
            dense[name] = densify(p)
            if not torch.equal(dense[name], z):
                raise AssertionError(f"densify({name}) != pruned weight")
            csb[name] = p
        layers.append((cell, csb, dense))
    frames = torch.from_numpy(rng.standard_normal(
        (FRAMES, 1, PAPER_MODELS["SR1"].layers[0].n_input)).astype(
            np.float32)).to(dev)
    return layers, frames


def slice_phase(layers, frames) -> dict:
    cfg = EngineConfig(frame_warmup=WARMUP, collect_frame_times=True)
    csb_mvm.LAUNCHES = 0
    x, results = frames, []
    for cell, csb, _ in layers:
        y, st, us, frame_us = rnn_serve_frames(cell, csb, x, config=cfg)
        results.append((y, st, us, frame_us))
        x = y
    launches = csb_mvm.LAUNCHES
    want = len(layers) * MVMS_PER_STEP * (WARMUP + 2 * FRAMES)
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times on the main "
                             f"path, expected {want}")
    with torch.no_grad():
        x = frames
        for (cell, _, dense), (y, st, _, _) in zip(layers, results):
            ry, rst = rnn_scan(cell, dense, x)
            if y.shape != (FRAMES, 1, cell.op("W_proj").shape[0]) \
                    or not torch.isfinite(y).all():
                raise AssertionError(f"{cell.name}: bad outputs {y.shape}")
            for a, b, what in [(y, ry, "outputs")] + [
                    (st[k], rst[k], f"state {k}") for k in rst]:
                err = float((a - b).abs().max())
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                    raise AssertionError(
                        f"{what} differ from the densified run: {err:.3e}")
            x = ry
    us_per_frame = sum(r[2] for r in results)
    frame_us = sum(r[3] for r in results)
    p50, p99 = (float(np.percentile(frame_us, q)) for q in (50, 99))
    for i, r in enumerate(results):
        print(f"layer {i + 1}: {r[2]:.1f} us/frame unblocked, p99 "
              f"{np.percentile(r[3], 99):.1f} us blocked")
    print(f"SR1 slice: {FRAMES} frames at batch 1, {launches} kernel "
          f"launches ({MVMS_PER_STEP} per cell step), outputs within 1e-4 "
          f"of the densified run; us_per_frame {us_per_frame:.1f}, "
          f"frame p50 {p50:.1f} us, p99 {p99:.1f} us, budget "
          f"{FRAME_BUDGET_US:.0f} us: "
          f"{'met' if p99 <= FRAME_BUDGET_US else 'NOT met'}")
    return {"launches": launches, "us_per_frame": us_per_frame,
            "p50_us": p50, "p99_us": p99}


def median_ms(fn, reps=50, warm=5) -> float:
    """Median over ``reps`` of CUDA-event time around one call of fn."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def graph_ms(fn, calls=20, reps=20) -> float:
    """Device time per call of fn without the host: ``calls`` calls
    captured in one CUDA graph, the graph replayed ``reps`` times between
    CUDA events; the median replay over ``calls``. Gaps between the
    kernels of one call count, the host's enqueue does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay, reps=reps, warm=2) / calls


def device_kernel_ms(fn, names=("csb_mvm_kernel",), reps=20):
    """Device time per call of fn of every kernel whose name contains one
    of ``names`` (every kernel if ``names`` is None), from torch.profiler:
    (total ms, {kernel: ms}), or (None, {}) where the profiler shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    each = {ev.key: ev.self_device_time_total / 1e3 / reps
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and (names is None or any(nm in ev.key for nm in names))}
    total = sum(each.values())
    return (total if total > 0 else None), each


def traced_kernels(fn, names, calls=3) -> list:
    """(name, grid) of every kernel whose name contains one of ``names``
    that ``calls`` calls of fn launch, read from torch.profiler's trace
    after two calls of warm-up (a trace of one call alone can miss its
    first kernel); the grid is None where the trace does not record it."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=2, active=calls),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for _ in range(2 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = []
    for ev in events:
        if (str(ev.get("cat", "")).lower() == "kernel"
                and any(nm in ev.get("name", "") for nm in names)):
            grid = ev.get("args", {}).get("grid")
            out.append((ev["name"], None if grid is None else tuple(grid)))
    return out


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def frame_profile(layers, frames, n=20) -> None:
    """Where one SR1 frame's time goes: torch.profiler over ``n`` frames of
    both layers (as rnn_serve_frames steps them, unblocked), device time
    by kernel and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cells import cell_apply, init_state

    def run():
        for cell, csb, _ in layers:
            st = init_state(cell, (1,))
            for t in range(n):
                _, st = cell_apply(cell, csb, frames[t], st)
        torch.cuda.synchronize()

    with torch.no_grad():
        run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_us = (time.perf_counter() - t0) * 1e6 / n
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in kernels) / n
    print(f"frame profile ({n} frames, torch.profiler): wall {wall_us:.1f} "
          f"us/frame, device busy {busy_us:.1f} us/frame "
          f"({100 * busy_us / wall_us:.1f}%), "
          f"{sum(ev.count for ev in kernels) / n:.0f} kernels/frame")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {ev.self_device_time_total / n:8.1f} us/frame "
              f"{ev.count // n:4d}x  {ev.key[:90]}")


def timing_phase(layers, dev) -> dict:
    """The 18 CSB MVMs of one SR1 frame at batch 1: kernel, plain version,
    one dense matmul each (library yardstick), and the bound."""
    rng = np.random.default_rng(SEED + 2)
    mats = [p for _, csb, _ in layers for p in csb.values()
            if not isinstance(p, torch.Tensor)]
    items = []
    live_bytes = padded_bytes = flops = 0
    for p in mats:
        x = torch.from_numpy(rng.standard_normal((1, p.shape[1])).astype(
            np.float32)).to(dev)
        xp = pad_to_grid(x, 8, p.grid[1] * p.block[1]).contiguous()
        items.append((p, x, xp, densify(p).float()))
        nnz = int((p.m.long() * p.n.long()).sum())
        idx = int(p.m.sum() + p.n.sum()) + 2 * p.m.numel()
        live_bytes += 4 * (nnz + idx + p.shape[1] + p.shape[0])
        padded_bytes += 4 * (p.vals.numel() + p.row_idx.numel()
                             + p.col_idx.numel() + 2 * p.m.numel())
        flops += 2 * nnz

    def kernel():
        for p, _, xp, _ in items:
            csb_mvm.csb_mvm_cuda(p.vals, p.row_idx, p.col_idx, p.m, p.n, xp,
                                 grid=p.grid, block=p.block, batch_tile=8,
                                 group=1, rows=1)

    def plain_version():
        for p, _, xp, _ in items:
            csb_mvm_ref(p.vals, p.row_idx, p.col_idx, p.m, p.n, xp,
                        grid=p.grid, block=p.block)

    def library():
        for _, x, _, w in items:
            torch.matmul(x, w.T)

    ms = median_ms(kernel)
    plain_ms = median_ms(plain_version)
    library_ms = median_ms(library)
    dev_ms, _ = device_kernel_ms(kernel)
    library_dev_ms, _ = device_kernel_ms(library, None)
    kernel_graph_ms, library_graph_ms = graph_ms(kernel), graph_ms(library)
    bytes_s = live_bytes / HBM_BYTES_PER_S
    ops_s = flops / FP32_FLOPS
    bound_ms = max(bytes_s, ops_s) * 1e3
    print(f"timing, one SR1 frame's {len(items)} CSB MVMs at batch 1 "
          f"(median of 50, CUDA events): kernel {ms:.4f} ms "
          f"(device time {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}"
          f" from torch.profiler), plain {plain_ms:.4f} ms, library "
          f"matmul {library_ms:.4f} ms (device time "
          f"{_ms(library_dev_ms)}); replayed from a CUDA graph (no host): "
          f"kernel {kernel_graph_ms:.4f} ms, library {library_graph_ms:.4f}"
          f" ms; bound {bound_ms:.5f} ms "
          f"({live_bytes} live bytes; padded vals+indices "
          f"{padded_bytes} bytes = {padded_bytes / HBM_BYTES_PER_S * 1e3:.5f}"
          f" ms; {flops} flops)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "device_ms": dev_ms, "library_device_ms": library_dev_ms,
            "graph_ms": kernel_graph_ms, "library_graph_ms": library_graph_ms,
            "live_bytes": live_bytes,
            "padded_bytes": padded_bytes}



# ---------------------------------------------------------------------------
# B2: the paged-attention decode kernel and the LM slice (gemma-2b)
# ---------------------------------------------------------------------------

def _rand(rng, shape, dev):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)


def paged_case(rng, dev, *, b, h, kv, d, psz, n_pages, table, pos,
               dv=None, d2=0, window=None):
    """Random fp32 inputs of one paged-attention call."""
    dv = dv or d
    case = dict(q=_rand(rng, (b, h, d), dev),
                k_pool=_rand(rng, (n_pages, psz, kv, d), dev),
                v_pool=_rand(rng, (n_pages, psz, kv, dv), dev),
                page_table=torch.tensor(table, dtype=torch.int32,
                                        device=dev),
                pos=pos, window=window, scale=1.0 / math.sqrt(d))
    if d2:
        case.update(q2=_rand(rng, (b, h, d2), dev),
                    k2_pool=_rand(rng, (n_pages, psz, kv, d2), dev))
    return case


def _cast(case, pool_dtype, q_dtype):
    out = dict(case)
    for k in ("q", "q2"):
        if k in out:
            out[k] = out[k].to(q_dtype)
    for k in ("k_pool", "v_pool", "k2_pool"):
        if k in out:
            out[k] = out[k].to(pool_dtype)
    return out


def paged_in(case, dtype):
    """The plain version's function on a case of fp32 pools and q,
    computed in ``dtype`` throughout: float64 gives the exact answer to
    hold the kernel and the plain version against, float32 the same
    formulation with every sum in fp32 (score dot products included)."""
    q, table = case["q"], case["page_table"]
    b, h, d = q.shape
    mp = table.shape[1]

    def gather(pool):
        g = pool[table.long()]
        return g.reshape((b, mp * pool.shape[1]) + tuple(pool.shape[2:])
                         ).to(dtype)

    kg, vg = gather(case["k_pool"]), gather(case["v_pool"])
    t, kv = kg.shape[1], kg.shape[2]
    sc = torch.einsum("bgrd,bkgd->bgrk",
                      q.reshape(b, kv, h // kv, d).to(dtype), kg)
    if "q2" in case:
        sc = sc + torch.einsum(
            "bgrd,bkgd->bgrk",
            case["q2"].reshape(b, kv, h // kv, -1).to(dtype),
            gather(case["k2_pool"]))
    row = torch.as_tensor(case["pos"], device=q.device).reshape(-1)
    row = row.long().expand(b)
    kpos = torch.arange(t, device=q.device)
    mask = kpos[None, :] <= row[:, None]
    if case["window"] is not None:
        mask &= kpos[None, :] > row[:, None] - case["window"]
    sc = torch.where(mask[:, None, None, :], sc * case["scale"],
                     torch.tensor(-1e30, dtype=dtype, device=q.device))
    e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    return torch.einsum("bgrk,bkgd->bgrd", p, vg).reshape(b, h, -1)


def exact_check(label, case, out, ref) -> None:
    """The kernel's output against the function in fp64, at the fp32
    bound; prints its distance beside the plain version's and the
    fp32-summed formulation's, which show how far the plain version
    itself stands from the exact answer."""
    exact = paged_in(case, torch.float64)
    fp32_sums = paged_in(case, torch.float32)
    torch.cuda.synchronize()
    tol = PAGED_TOL[torch.float32]
    errs = [float((x.double() - exact).abs().max())
            for x in (out, ref, fp32_sums)]
    print(f"  {label}, fp32: max abs err vs fp64: kernel {errs[0]:.3e}, "
          f"plain version {errs[1]:.3e}, fp32-summed formulation "
          f"{errs[2]:.3e}")
    if not torch.allclose(out.double(), exact, rtol=tol, atol=tol):
        raise AssertionError(f"{label}: the kernel is more than {tol} from "
                             f"the fp64 answer, max abs err {errs[0]:.3e}")


# cases of fp32 pools also held against the answer in fp64
EXACT_CASES = ("MLA 128 heads, rope, D 512 + 64", "gemma-2b decode shape")


def compare_paged(label, case, exact=False) -> float:
    """Kernel against its plain version on the same CUDA tensors (and
    against fp64 where ``exact``)."""
    out = paged_attn_decode(**case)
    ref = paged_attn_ref(**case)
    torch.cuda.synchronize()
    if exact:
        exact_check(label, case, out, ref)
    tol = PAGED_TOL[case["k_pool"].dtype]
    b, h, _ = case["q"].shape
    want = (b, h, case["v_pool"].shape[-1])
    if tuple(out.shape) != want or out.dtype != torch.float32:
        raise AssertionError(f"{label}: got {tuple(out.shape)} {out.dtype},"
                             f" want {want} float32")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: non-finite output")
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, rtol=tol, atol=tol):
        raise AssertionError(f"{label}: kernel and plain version differ, "
                             f"max abs err {err:.3e} > tol {tol}")
    return err


def _slot_table(rng, pos_list, psz, max_pages):
    """A page table whose slots own distinct random pages covering their
    positions; unmapped entries name the scratch page (the last)."""
    n_pages = len(pos_list) * max_pages
    perm = rng.permutation(n_pages)
    table = np.full((len(pos_list), max_pages), n_pages, np.int32)
    k = 0
    for i, p in enumerate(pos_list):
        need = -(-(p + 1) // psz)
        table[i, :need] = perm[k:k + need]
        k += need
    return table, n_pages + 1


def paged_kernel_phase(dev) -> float:
    """B2 kernel vs plain version; returns the max abs error at
    gemma-2b's decode shape."""
    rng = np.random.default_rng(SEED + 3)
    t3 = [[0, 1, 2], [3, 4, 9], [5, 6, 7]]
    cases = {
        "vector pos at page boundaries": dict(
            b=3, h=4, kv=2, d=8, psz=4, n_pages=9,
            table=[[0, 1], [2, 3], [5, 6]], pos=[3, 4, 7]),
        "max_pages=1, scalar pos": dict(
            b=3, h=2, kv=1, d=16, psz=8, n_pages=4,
            table=[[2], [0], [3]], pos=0),
        "max_pages=1, vector pos": dict(
            b=3, h=2, kv=1, d=16, psz=8, n_pages=4,
            table=[[2], [0], [3]], pos=[3, 0, 7]),
        "scratch-page inactive slot": dict(
            b=2, h=4, kv=2, d=8, psz=4, n_pages=5,
            table=[[0, 1], [4, 4]], pos=[6, 0]),
        "window 6": dict(b=3, h=4, kv=2, d=16, psz=4, n_pages=10,
                         table=t3, pos=[7, 2, 10], window=6),
        "window 3, scalar pos": dict(b=3, h=4, kv=2, d=16, psz=4,
                                     n_pages=10, table=t3, pos=9,
                                     window=3),
        "MLA rope term, Dv != D": dict(b=3, h=2, kv=1, d=32, dv=16, d2=8,
                                       psz=4, n_pages=10, table=t3,
                                       pos=[7, 2, 10]),
        "rope, 16 heads per group, window": dict(
            b=3, h=16, kv=1, d=16, dv=8, d2=8, psz=4, n_pages=10,
            table=t3, pos=[7, 2, 10], window=5),
        "GQA rep 3": dict(b=3, h=6, kv=2, d=16, psz=4, n_pages=10,
                          table=t3, pos=[11, 0, 5]),
        "position before every key": dict(b=3, h=4, kv=2, d=8, psz=4,
                                          n_pages=10, table=t3,
                                          pos=[-1, 3, 0]),
    }
    tab, n = _slot_table(rng, [7999, 4000], 16, 500)
    cases["long cache (8000 keys)"] = dict(
        b=2, h=8, kv=1, d=64, psz=16, n_pages=n, table=tab,
        pos=[7999, 4000])
    tab, n = _slot_table(rng, [63999], 16, 4000)
    cases["long cache (64000 keys)"] = dict(
        b=1, h=1, kv=1, d=32, psz=16, n_pages=n, table=tab, pos=[63999])
    cases["long cache (64000 keys), window 60000"] = dict(
        b=1, h=1, kv=1, d=32, psz=16, n_pages=n, table=tab, pos=[63999],
        window=60000)
    # the split boundaries, at gemma-2b's head shape (H 8, KV 1, D 256,
    # P 16, 65 pages: 33 splits of 2 pages, the last of one)
    gem = dict(h=8, kv=1, d=256, psz=16)
    split_cases = {
        "pos on a split edge and one key past it": [31, 32, 63, 64],
        "live keys in one split (pos 5)": [5, 700, 1039, 0],
        "all-masked slot (pos -1)": [-1, 500, 1039, 16],
    }
    for label, pl in split_cases.items():
        tab, n = _slot_table(rng, pl, 16, 65)
        cases[label] = dict(b=4, n_pages=n, table=tab, pos=pl, **gem)
    tab, n = _slot_table(rng, [39, 103, 1031, 7], 16, 65)
    cases["window 8 leaving one split live"] = dict(
        b=4, n_pages=n, table=tab, pos=[39, 103, 1031, 7], window=8, **gem)
    pl = [1599, 1590, 800, 1]   # 100 pages: splits of 3, the last of 1
    tab, n = _slot_table(rng, pl, 16, 100)
    cases["capacity not a multiple of the split (100 pages)"] = dict(
        b=4, n_pages=n, table=tab, pos=pl, **gem)
    for b in (1, 16):
        pl = rng.integers(0, 1040, size=b).tolist()
        tab, n = _slot_table(rng, pl, 16, 65)
        cases[f"B = {b}"] = dict(b=b, n_pages=n, table=tab, pos=pl, **gem)
    # rows of 12, 20 and 4 elements: the kernel loads one element at a time
    cases["head dims 12 / 20 / rope 4, one element per load"] = dict(
        b=3, h=4, kv=2, d=12, dv=20, d2=4, psz=4, n_pages=10, table=t3,
        pos=[7, 2, 10], window=9)
    tab, n = _slot_table(rng, [255, 100], 16, 16)
    cases["MLA 128 heads, rope, D 512 + 64"] = dict(
        b=2, h=128, kv=1, d=512, dv=512, d2=64, psz=16, n_pages=n,
        table=tab, pos=[255, 100])
    gemma = [1031, 700, 333, 16]
    tab, n = _slot_table(rng, gemma, 16, 65)
    cases["gemma-2b decode shape"] = dict(b=4, h=8, kv=1, d=256, psz=16,
                                          n_pages=n, table=tab, pos=gemma)
    f32, bf16 = torch.float32, torch.bfloat16
    n_cmp, gemma_err, worst = 0, 0.0, {f32: (0.0, ""), bf16: (0.0, "")}
    for label, kw in cases.items():
        case = paged_case(rng, dev, **kw)
        for pool_dt, q_dt in ((f32, f32), (bf16, bf16), (bf16, f32)):
            err = compare_paged(
                f"{label} [pools {pool_dt}, q {q_dt}]",
                _cast(case, pool_dt, q_dt),
                exact=label in EXACT_CASES and pool_dt == q_dt == f32)
            n_cmp += 1
            worst[pool_dt] = max(worst[pool_dt], (err, label))
            if label.startswith("gemma"):
                gemma_err = max(gemma_err, err)
                print(f"  gemma-2b shape, pools {pool_dt}, q {q_dt}: max "
                      f"abs err {err:.3e}")
    print(f"paged kernel phase: {n_cmp} comparisons passed (tol "
          f"{PAGED_TOL[f32]:g} fp32 pools, {PAGED_TOL[bf16]:g} bf16 pools); "
          f"max abs err at gemma-2b's shape {gemma_err:.3e}; over all "
          f"cases {worst[f32][0]:.3e} with fp32 pools ({worst[f32][1]}), "
          f"{worst[bf16][0]:.3e} with bf16 pools ({worst[bf16][1]})")
    return gemma_err


def lm_requests(vocab: int) -> list:
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, tokens=rng.integers(0, vocab, size=n),
                    max_new_tokens=MAX_NEW, arrival=a)
            for i, (n, a) in enumerate(zip(PROMPT_LENS, ARRIVALS))]


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v, fn) for v in t]
    return fn(t)


def build_lm(dev):
    """gemma-2b at full width: fp32 weights from a seeded generator and
    their bf16 copy (the config's own dtype)."""
    cfg = get_config(ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p32 = LM.init_params(cfg32, gen, device=dev)
    p16 = _tree(p32, lambda t: t.to(torch.bfloat16))
    n = sum(t.numel() for t in _leaves(p32))
    if n != cfg.param_count():
        raise AssertionError(f"{n} parameters, the config counts "
                             f"{cfg.param_count()}")
    print(f"{ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, n_kv {cfg.n_kv}, head_dim {cfg.hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n} parameters "
          f"({4 * n / 1e9:.2f} GB fp32 + {2 * n / 1e9:.2f} GB bf16)")
    return (cfg32, p32), (cfg, p16)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


def serve_lm(cfg, params, use_kernel: bool, observe: bool = False):
    """One run of the slice's trace; checks the kernel's launch count."""
    reqs = lm_requests(cfg.vocab)
    if observe:
        obs_trace.enable()
        obs_metrics.enable()
    torch.cuda.reset_peak_memory_stats()
    paged_attn.LAUNCHES = 0
    res = serve_continuous(params, cfg, reqs,
                           LM_ENGINE.replace(use_kernel=use_kernel))
    launches = paged_attn.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    tr = obs_trace.disable() if observe else None
    reg = obs_metrics.disable() if observe else None
    steps = res.stats["decode_steps"]
    per_call = paged_attn.KERNELS_PER_CALL
    want = per_call * cfg.n_layers * steps if use_kernel else 0
    if launches != want:
        raise AssertionError(
            f"{cfg.dtype} use_kernel={use_kernel}: paged_attn launched "
            f"{launches} kernels, expected {want} ({per_call} kernels x "
            f"{cfg.n_layers} layers x {steps} decode steps)")
    for r in reqs:
        toks = res.tokens.get(r.rid)
        if toks is None or len(toks) != MAX_NEW \
                or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"request {r.rid}: bad tokens {toks}")
    print(f"  {cfg.dtype} {'kernel' if use_kernel else 'gather'}: "
          f"{steps} decode steps, {launches} kernel launches, "
          f"steady {res.stats['steady_tokens_per_sec']} tok/s, "
          f"{res.stats['tokens_per_sec']} tok/s over {res.wall_s:.2f} s "
          f"wall (first calls {res.stats['compile_time_s']} s), "
          f"occupancy {res.stats['occupancy']}, peak memory "
          f"{peak / 1e9:.2f} GB")
    return res, launches, peak, tr, reg


def first_step(cfg, params, dev):
    """The run's first decode step rebuilt by hand: the four requests
    that arrive at step 0 prefilled (bucketed, as the engine does) into a
    fresh pool; returns (cache, tokens, pos, table, head)."""
    reqs = lm_requests(cfg.vocab)[:LM_ENGINE.n_slots]
    psz = LM_ENGINE.page_size
    cache_len = max(n + MAX_NEW for n in PROMPT_LENS)
    max_pages = -(-cache_len // psz)
    pool = PagePool(psz, LM_ENGINE.n_slots * max_pages, LM_ENGINE.n_slots,
                    max_pages, device=dev)
    cache = LM.init_paged_cache(cfg, pool.n_pages, psz, LM_ENGINE.n_slots,
                                getattr(torch, cfg.dtype), dev)
    head = LM.head_f32(params, cfg)
    cur = torch.zeros((LM_ENGINE.n_slots, 1), dtype=torch.int32,
                      device=dev)
    with torch.no_grad():
        for slot, r in enumerate(reqs):
            plen = r.prompt_len
            pool.reserve(slot, plen + MAX_NEW)
            pool.ensure(slot, plen + 1)
            toks = np.pad(r.tokens, (0, bucket_len(plen) - plen))
            lg, c = LM.prefill(params, {"tokens": torch.as_tensor(
                toks, device=dev)[None]}, cfg, last_pos=plen - 1,
                head=head)
            cur[slot, 0] = int(torch.argmax(lg[0]))
            phys = list(pool.slot_pages(slot))
            n_pad = 1 << max(len(phys) - 1, 0).bit_length()
            phys += [pool.scratch_page] * (n_pad - len(phys))
            insert_paged_cache(cache, fit_cache_len(c, len(phys) * psz),
                               phys, slot)
    pos = torch.tensor([r.prompt_len for r in reqs], dtype=torch.int32,
                       device=dev)
    return cache, cur, pos, pool.device_table(), head


def first_step_logits(cfg, params, dev):
    """First decode step's logits through the kernel and the gather path
    on the same cache; returns (kernel, gather, step state)."""
    cache, cur, pos, table, head = first_step(cfg, params, dev)
    out = []
    with torch.no_grad():
        for use_kernel in (True, False):
            c = {k: v.clone() for k, v in cache.items()}
            lg, _ = LM.decode_step_paged(params, c, cur, pos, table, cfg,
                                         use_kernel=use_kernel, head=head)
            out.append(lg[:, 0])
    return out[0], out[1], (cache, cur, pos, table, head)


def replay_positions(vocab: int) -> list:
    """Per decode step of the slice's trace, the (pos, active) arrays the
    engine feeds the step: the scheduler and pool replayed on the host."""
    from repro_torch.serve import SlotScheduler
    reqs = lm_requests(vocab)
    psz, n_slots = LM_ENGINE.page_size, LM_ENGINE.n_slots
    max_pages = -(-max(n + MAX_NEW for n in PROMPT_LENS) // psz)
    pool = PagePool(psz, n_slots * max_pages, n_slots, max_pages,
                    device="cpu")
    sched = SlotScheduler(n_slots, pool=pool)
    for r in reqs:
        sched.submit(r)
    steps = []
    while sched.has_work():
        for slot, r in sched.admit():
            pool.ensure(slot, r.prompt_len)
            sched.started(slot, 0)
        active = sched.active_mask()
        if not active.any():
            sched.idle_tick()
            continue
        steps.append((sched.positions(), active))
        sched.advance(np.zeros(n_slots, np.int64))
    return steps


def lm_slice_phase(dev) -> dict:
    (cfg32, p32), (cfg16, p16) = build_lm(dev)
    out = {}
    print(f"LM slice: {len(PROMPT_LENS)} greedy requests, prompts "
          f"{PROMPT_LENS}, {MAX_NEW} new tokens each, arrivals at steps "
          f"{ARRIVALS}, {LM_ENGINE.n_slots} slots, page size "
          f"{LM_ENGINE.page_size}")
    g32 = serve_lm(cfg32, p32, False)
    k32 = serve_lm(cfg32, p32, True)
    if k32[0].tokens != g32[0].tokens:
        bad = [i for i in g32[0].tokens
               if k32[0].tokens[i] != g32[0].tokens[i]]
        raise AssertionError(f"fp32 tokens of the kernel path differ from "
                             f"the gather path in requests {bad}")
    print("  fp32: kernel tokens equal the gather path's, token for token")
    k16 = serve_lm(cfg16, p16, True, observe=True)
    g16 = serve_lm(cfg16, p16, False)
    same = total = 0
    for rid, toks in g16[0].tokens.items():
        same += sum(a == b for a, b in zip(toks, k16[0].tokens[rid]))
        total += len(toks)
    print(f"  bf16: kernel and gather tokens agree at {same}/{total} "
          f"positions")
    steps = replay_positions(cfg16.vocab)
    if len(steps) != k16[0].stats["decode_steps"]:
        raise AssertionError(f"replayed {len(steps)} decode steps, the "
                             f"run took {k16[0].stats['decode_steps']}")
    for cfg, params in ((cfg32, p32), (cfg16, p16)):
        lk, lg, state = first_step_logits(cfg, params, dev)
        if not (torch.isfinite(lk).all() and torch.isfinite(lg).all()):
            raise AssertionError(f"{cfg.dtype}: non-finite logits")
        err = float((lk - lg).abs().max())
        tol = LOGIT_TOL[getattr(torch, cfg.dtype)]
        print(f"  first decode step, {cfg.dtype}: logits {tuple(lk.shape)}"
              f", kernel vs gather max abs diff {err:.3e} (tol {tol}); "
              f"max |logit| {float(lg.abs().max()):.3f}")
        if err > tol:
            raise AssertionError(f"{cfg.dtype} first-step logits differ by "
                                 f"{err:.3e} > {tol}")
        out[f"first_step_err_{cfg.dtype}"] = err
        if cfg is cfg16:
            out["step_state"] = state
        else:
            lg32 = lg
    lg16 = first_step_logits(cfg16, p16, dev)[1]
    print(f"  first decode step, bf16 vs fp32 gather logits: max abs diff "
          f"{float((lg16 - lg32).abs().max()):.3e}")
    res, launches, peak, tr, reg = k16
    hist = reg.to_dict(series=False)["histograms"]
    step = hist["serve/step/wall_us"]
    ttft = hist["serve/req/ttft_us"]
    buckets: dict = {}
    for ph, name, _, dur, _, args in tr.events():
        if ph == "X" and name == "serve/req/prefill":
            buckets.setdefault((bucket_len(args["tokens"]), args["cold"]),
                               []).append(dur / 1e3)
    print(f"  bf16 kernel run: steady_tokens_per_sec "
          f"{res.stats['steady_tokens_per_sec']}, decode step wall p50 "
          f"{step['p50']:.1f} us, p99 {step['p99']:.1f} us over "
          f"{step['count']} steps; TTFT p50 {ttft['p50']:.1f} us, p99 "
          f"{ttft['p99']:.1f} us; peak memory {peak / 1e9:.2f} GB")
    for (bk, cold), durs in sorted(buckets.items()):
        print(f"    prefill bucket {bk:5d}{' (first call)' if cold else ''}"
              f": {', '.join(f'{d:.1f}' for d in durs)} us")
    out.update(
        cfg=cfg16, params=p16, steps=steps,
        launches=k32[1] + k16[1], steady_tokens_per_sec=res.stats[
            "steady_tokens_per_sec"],
        step_p50_us=step["p50"], step_p99_us=step["p99"],
        ttft_p50_us=ttft["p50"], ttft_p99_us=ttft["p99"],
        peak_gb=peak / 1e9, bf16_token_agreement=same / total)
    return out


def decode_profile(lm, n=5) -> None:
    """Where one bf16 decode step's time goes: torch.profiler over ``n``
    steps of the first decode step's state, device time by kernel and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = lm["cfg"], lm["params"]
    cache, cur, pos, table, head = lm["step_state"]

    def run():
        for _ in range(n):
            LM.decode_step_paged(params, cache, cur, pos, table, cfg,
                                 use_kernel=True, head=head)
        torch.cuda.synchronize()

    with torch.no_grad():
        run()
        t0 = time.perf_counter()
        run()
        plain_us = (time.perf_counter() - t0) * 1e6 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_us = (time.perf_counter() - t0) * 1e6 / n
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in kernels) / n
    b2 = sum(ev.count for ev in kernels
             if any(nm in ev.key for nm in B2_NAMES)) / n
    print(f"decode-step profile (bf16, kernel path, {n} steps at the first "
          f"step's positions, torch.profiler): wall {wall_us:.1f} us/step "
          f"profiled, {plain_us:.1f} us/step unprofiled; device busy "
          f"{busy_us:.1f} us/step ({100 * busy_us / wall_us:.1f}% of the "
          f"profiled wall, {100 * busy_us / plain_us:.1f}% of the "
          f"unprofiled), {sum(ev.count for ev in kernels) / n:.0f} "
          f"kernels/step ({FIRST_DESIGN_KERNELS_PER_STEP} with the one-launch "
          f"paged-attention kernel of the first design), {b2:.0f} of them "
          f"paged-attention kernels")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {ev.self_device_time_total / n:8.1f} us/step "
              f"{ev.count // n:4d}x  {ev.key[:90]}")


def paged_timing_phase(lm, dev) -> dict:
    """B2 at the busiest decode step of the slice's trace (bf16, one
    layer's pools): kernel, plain version, SDPA on the gathered K/V (the
    library yardstick; the gather timed apart) and the bound."""
    cfg = lm["cfg"]
    pos_h, active = max(lm["steps"],
                        key=lambda s: int((s[0] + 1)[s[1]].sum()))
    rng = np.random.default_rng(SEED + 4)
    psz = LM_ENGINE.page_size
    max_pages = -(-max(n + MAX_NEW for n in PROMPT_LENS) // psz)
    tab, n_pages = _slot_table(rng, pos_h.tolist(), psz, max_pages)
    b, h, kv, d = len(pos_h), cfg.n_heads, cfg.n_kv, cfg.hd
    bf16 = torch.bfloat16
    q = _rand(rng, (b, h, d), dev).to(bf16)
    kp = _rand(rng, (n_pages, psz, kv, d), dev).to(bf16)
    vp = _rand(rng, (n_pages, psz, kv, d), dev).to(bf16)
    table = torch.from_numpy(tab).to(dev)
    pos = torch.from_numpy(pos_h.astype(np.int32)).to(dev)
    scale = 1.0 / math.sqrt(d)
    t = max_pages * psz
    kpos = torch.arange(t, device=dev)
    mask = (kpos[None, :] <= pos[:, None].long())[:, None, None, :]

    def gather():
        return (kp[table.long()].reshape(b, t, kv, d).transpose(1, 2),
                vp[table.long()].reshape(b, t, kv, d).transpose(1, 2))

    kg, vg = gather()
    qs = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True)

    def kernel():
        return paged_attn.paged_attn_cuda(q, kp, vp, table, pos,
                                          scale=scale)

    def plain_version():
        return paged_attn_ref(q, kp, vp, table, pos, scale=scale)

    lib_err = float((library()[:, :, 0].float() - kernel()).abs().max())
    ms = median_ms(kernel)
    plain_ms = median_ms(plain_version)
    library_ms = median_ms(library)
    gather_ms = median_ms(gather)
    dev_ms, each = device_kernel_ms(kernel, B2_NAMES)
    library_dev_ms, _ = device_kernel_ms(library, None)
    kernel_graph_ms, library_graph_ms = graph_ms(kernel), graph_ms(library)
    gather_sdpa_graph_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, *gather(), attn_mask=mask, scale=scale, enable_gqa=True))
    hpc, ps, splits = paged_attn.plan(b, h // kv, kv, d, 0, psz, max_pages,
                                      paged_attn.sm_count(dev.index))
    planned = (splits, kv * (h // kv // hpc), b)
    traced = traced_kernels(kernel, B2_NAMES, calls=3)
    per_call = len(traced) / 3
    if per_call != paged_attn.KERNELS_PER_CALL:
        raise AssertionError(f"a call launched {per_call} kernels, the "
                             f"launch count adds "
                             f"{paged_attn.KERNELS_PER_CALL}: {traced}")
    grids = sorted({g for _, g in traced}, key=str)
    ctas = None
    if None not in grids:
        if grids != [planned]:
            raise AssertionError(f"traced grids {grids}, planned {planned}")
        ctas = math.prod(planned)
    live = int((pos_h + 1).sum())
    kv_bytes = live * kv * 2 * d * BF16_BYTES
    io_bytes = (q.numel() * BF16_BYTES + b * h * d * 4 + table.numel() * 4
                + pos.numel() * 4)
    flops = 2 * live * h * 2 * d
    bytes_s = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    ops_s = flops / BF16_FLOPS
    bound_ms = max(bytes_s, ops_s) * 1e3
    print(f"paged timing, one layer at the busiest decode step (bf16, "
          f"pos {pos_h.tolist()}, active {active.tolist()}, {live} live "
          f"keys; median of 50, CUDA events): kernel {ms:.4f} ms (device "
          f"time {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}"
          f" from torch.profiler), plain {plain_ms:.4f} ms, library SDPA "
          f"{library_ms:.4f} ms (device time {_ms(library_dev_ms)}) on "
          f"pre-gathered K/V (the gather alone "
          f"{gather_ms:.4f} ms; SDPA vs kernel max abs diff "
          f"{lib_err:.3e}); replayed from a CUDA graph (no host): kernel "
          f"{kernel_graph_ms:.4f} ms, SDPA {library_graph_ms:.4f} ms, gather "
          f"+ SDPA {gather_sdpa_graph_ms:.4f} ms; bound {bound_ms:.5f} ms "
          f"({kv_bytes} live K/V "
          f"bytes + {io_bytes} q/out/table/pos bytes; {flops} flops); "
          f"planned grid {splits} splits of {ps} pages x {planned[1]} "
          f"(group, head chunk) x {b} slots; traced: {per_call:g} kernels per "
          f"call, grids {grids} = "
          f"{'not in the trace' if ctas is None else f'{ctas} CTAs'}; "
          f"{cfg.n_layers} calls = {per_call * cfg.n_layers:g} kernels per "
          f"decode step")
    for key, t_ms in each.items():
        print(f"  device time {t_ms:.4f} ms  {key[:90]}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "device_ms": dev_ms, "library_device_ms": library_dev_ms,
            "graph_ms": kernel_graph_ms, "library_graph_ms": library_graph_ms,
            "gather_sdpa_graph_ms": gather_sdpa_graph_ms,
            "gather_ms": gather_ms, "live_kv_bytes": kv_bytes, "ctas": ctas,
            "kernels_per_call": per_call}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase {name}: {time.perf_counter() - t0:.1f} s]")
        return out

    card_info()
    phase("build", build)
    layers, frames = build_sr1(dev)
    sr1_shapes = sorted({p.shape for _, csb, _ in layers
                         for p in csb.values()
                         if not isinstance(p, torch.Tensor)})
    max_err = phase("B1 kernel", kernel_phase, dev, sr1_shapes)
    sl = phase("SR1 slice", slice_phase, layers, frames)
    tm = phase("B1 timing", timing_phase, layers, dev)
    phase("SR1 frame profile", frame_profile, layers, frames)
    paged_err = phase("B2 kernel", paged_kernel_phase, dev)
    lm = phase("LM slice", lm_slice_phase, dev)
    phase("LM decode profile", decode_profile, lm)
    pt = phase("B2 timing", paged_timing_phase, lm, dev)
    print(f"[total {time.perf_counter() - t_start:.1f} s]")
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": sl["launches"], "max_abs_err": max_err,
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"], "device_ms": tm["device_ms"],
        "library_device_ms": tm["library_device_ms"],
        "graph_ms": tm["graph_ms"], "library_graph_ms": tm["library_graph_ms"],
        "us_per_frame": sl["us_per_frame"], "frame_p99_us": sl["p99_us"],
    }, {
        **PAGED_KERNEL, "launches": lm["launches"],
        "max_abs_err": paged_err, "ms": pt["ms"],
        "plain_ms": pt["plain_ms"], "bound_ms": pt["bound_ms"],
        "bound_by": pt["bound_by"], "library_ms": pt["library_ms"],
        "device_ms": pt["device_ms"], "gather_ms": pt["gather_ms"],
        "library_device_ms": pt["library_device_ms"],
        "graph_ms": pt["graph_ms"], "library_graph_ms": pt["library_graph_ms"],
        "gather_sdpa_graph_ms": pt["gather_sdpa_graph_ms"],
        "kernels_per_call": pt["kernels_per_call"], "ctas": pt["ctas"],
        "steady_tokens_per_sec": lm["steady_tokens_per_sec"],
        "step_p99_us": lm["step_p99_us"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

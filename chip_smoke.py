#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each of which raises (and the script exits nonzero) on failure:

1. The card's name and power limit (``nvidia-smi``) and the CUDA version.
2. Build every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all started together) and print the build time.
3. Kernel phase: ``csb_matvec`` on CUDA tensors (the hand-written kernel)
   against its plain PyTorch version ``csb_mvm_ref`` on the same tensors,
   over the CPU test sweep plus the SR1 matrices, at batches 1, 8 and 13:
   within 1e-5 in fp32 (summation order only) and 5e-2 in bf16.
4. Slice phase: the paper's SR1 model (two LSTMP layers, 153/512 -> 1024,
   projection 512, Table 1) at full width, CSB-pruned 13x with 32x32
   blocks, weights and frames from a numpy seed, served for 200 frames at
   batch 1 through ``rnn_serve_frames``, layer 1's outputs feeding layer
   2. The kernel's launch count must grow by exactly 9 per cell step (4 W.x,
   4 U.h and the projection), and outputs and final states must agree
   within 1e-4 with the same cells run on the densified weights through
   the dense branch (fp32 summation order, compounded over 200 recurrent
   steps). Then it times the kernel, its plain version and one PyTorch
   matmul on the dense matrix for the 18 CSB MVMs of one SR1 frame.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cells import make_cell, rnn_scan  # noqa: E402
from repro_torch.configs import PAPER_MODELS  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CSBSpec, csb_masks, csb_project, padded_csb_from_dense,
)
from repro_torch.kernels import (  # noqa: E402
    _build, csb_matvec, csb_mvm, csb_mvm_ref, densify, pad_to_grid,
)
from repro_torch.serve import EngineConfig, rnn_serve_frames  # noqa: E402

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
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
SWEEP = [((32, 32), 16, 16), ((64, 48), 16, 16), ((48, 64), 16, 32),
         ((128, 96), 32, 32), ((40, 24), 8, 8)]
KERNEL = {
    "name": "csb_mvm",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/csb_mvm.cu",
    "replaces": "src/repro/kernels/csb_mvm.py:77",
}


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


def device_kernel_ms(fn, reps=20):
    """Device time of csb_mvm_kernel per call of fn, from torch.profiler,
    or None where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and "csb_mvm_kernel" in ev.key)
    return total / 1e3 / reps if total > 0 else None


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
                                 group=1)

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
    dev_ms = device_kernel_ms(kernel)
    bytes_s = live_bytes / HBM_BYTES_PER_S
    ops_s = flops / FP32_FLOPS
    bound_ms = max(bytes_s, ops_s) * 1e3
    print(f"timing, one SR1 frame's {len(items)} CSB MVMs at batch 1 "
          f"(median of 50, CUDA events): kernel {ms:.4f} ms "
          f"(device time {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}"
          f" from torch.profiler), plain {plain_ms:.4f} ms, library "
          f"matmul {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({live_bytes} live bytes; padded vals+indices "
          f"{padded_bytes} bytes = {padded_bytes / HBM_BYTES_PER_S * 1e3:.5f}"
          f" ms; {flops} flops)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "device_ms": dev_ms, "live_bytes": live_bytes,
            "padded_bytes": padded_bytes}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card_info()
    build()
    layers, frames = build_sr1(dev)
    sr1_shapes = sorted({p.shape for _, csb, _ in layers
                         for p in csb.values()
                         if not isinstance(p, torch.Tensor)})
    max_err = kernel_phase(dev, sr1_shapes)
    sl = slice_phase(layers, frames)
    tm = timing_phase(layers, dev)
    frame_profile(layers, frames)
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": sl["launches"], "max_abs_err": max_err,
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"], "device_ms": tm["device_ms"],
        "us_per_frame": sl["us_per_frame"], "frame_p99_us": sl["p99_us"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

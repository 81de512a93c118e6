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
   from the profiler's trace. The same timing phase takes B2 at
   deepseek-v2-236b's MLA shape and hymba-1.5b's attention shape, at the
   busiest steps of their traces replayed on the host (phases 8 and 9
   check the replays against their runs): late in a long run the
   profiler drops kernels from its traces.
7. The rest of the dense-attention serve path, on the same gemma-2b
   weights (B2's launch count is read around each path: 2 x n_layers x
   single-query paged decode steps, and 0 where a path runs none):
   ``generate`` on four 256-token prompts (numpy seed 1), 32 new tokens,
   in fp32 and bf16, its fp32 tokens equal to ``serve_continuous(paged=
   True, use_kernel=True)`` on the same four requests; contiguous
   ``serve_continuous(paged=False)`` on the LM trace, its fp32 tokens
   equal to the paged path's; the prefix cache — eight requests sharing
   one 512-token prefix with distinct suffixes of 16..333 tokens,
   ``prefix_cache=True`` and ``False`` through the kernel in fp32 and
   bf16 (fp32 tokens equal, at least 7 prefix hits, shared pages, the
   prefill tokens of both); ``derive_draft_params``' time at full width;
   and speculative serving of the LM trace (``spec_k=4``, draft prune
   rates 0 and 0.5, fp32), its tokens equal to plain paged serving's,
   with acceptance, tokens per round and wall time per token. Where fp32
   tokens differ, the first differing step and the top-2 logit margin
   there are printed before the script fails. B2's kernel phase also
   holds the kernel on page tables of the prefix trace (replayed on the
   host) in which several slots map the same physical pages.
8. The MLA + MoE slice, after the gemma-2b phases are freed (peak memory
   printed): deepseek-v2-236b at full width (d_model 5120, 128 heads,
   q_lora 1536, kv_lora 512, rope 64, 160 experts top-6 + 2 shared,
   vocab 102400), its depth cut to what one card holds: 2 layers in fp32
   (36.0 GB), then 4 in bf16 (33.9 GB), random weights from a seeded
   generator. Eight greedy requests (prompts 64..1024, powers of two so
   that bucketed and unbucketed prefill route the same MoE chunks) go
   through paged serving with B2 (MLA's absorbed query over the latent
   pool, the rope term as B2's second score product) and with the gather
   path: B2's launches must equal 2 x n_layers x decode steps; fp32
   tokens must be equal and the first step's logits within 1e-4 (bf16:
   agreement printed). B2 is held against its plain version on the
   inputs the MLA layers give it (fp32 pools also against fp64). In
   fp32, contiguous serving must give the paged tokens; the prefix cache
   (eight requests sharing 512 tokens) through B2 must give the gather
   path's tokens with at least 7 hits, and on/off agreement is printed
   (a suffix is its own MoE chunk); ``generate`` and speculative serving
   (rate 0) print their speed and agreement. Per dtype: metrics, a
   decode-step profile and peak memory (B2 at MLA's shape is timed in
   phase 6).
9. The SSD and hybrid slice (``[phase ssd]``), after deepseek is freed:
   hymba-1.5b (32 layers, d_model 1600, attention of 25 heads over 5 KV
   heads of 64 beside 25 SSD heads, SwiGLU) and mamba2-370m (48 layers,
   d_model 1024, SSD alone, no FFN) at full width and depth, random
   weights from a seeded generator, fp32 and a bf16 copy, each serving
   the LM trace with bucketing off (the engine turns it off for these
   mixers). hymba in fp32: paged through B2 and through the gather
   path, and contiguous, with equal tokens, B2's launches 2 x 32 x
   single-query paged steps, B2 held to its plain version (and fp64) on
   the layers' own inputs; mamba2 in fp32: paged (B2 launches 0) and
   contiguous, tokens equal. Both: a 1-token and a 2-token prompt (a
   1-row conv state written at the slot's start) through paged and
   contiguous serving with equal tokens; ``generate`` (4 x 256) and its
   agreement with paged serving (``generate`` carries an fp32 SSM state,
   serving a bf16 one, as in JAX); in bf16 paged serving's metrics, a
   decode-step profile and peak memory; hymba's B2 on the bf16 layers'
   inputs (timed at its shape in phase 6).
   B2's kernel phase also holds it at hymba's shape (5 heads per CTA).
10. Disaggregated serving (``[phase disagg]``), before gemma-2b is
   freed, on its weights: ``serve_disaggregated`` on the LM trace in
   fp32 through B2 and through the gather path, its tokens equal to
   paged serving's, B2's launches equal to the paged run's, 8 handoffs
   mapping pages; the prefix trace through both tiers, tokens equal with
   the cache on and off and to ``serve_continuous``'s, its hits equal and
   fewer prefill tokens; then in bf16 paged serving and the tiers on the
   LM trace through B2, twice each in turns (paged, disagg, disagg,
   paged), each step's wall and each request's TTFT (from its arrival on
   the scheduler's clock; arrival 0 is the engine's call) read by the
   same clocks for both, with handoffs and handoff pages. B2's kernel phase also holds
   it at internvl2-2b's shape (16 heads over 8 of 128).
11. The router (``[phase router]``): ``Router(2)`` over
   ``serve_continuous`` and over ``serve_disaggregated`` on the LM trace
   in fp32 through B2, tokens equal to one engine's, both replicas
   given requests, B2's launches 2 x 18 x the replicas' decode steps;
   printed apart, ``simulate_replicas``' host replay of both policies
   (TTFT and latency percentiles at the measured bf16 step p50).
12. The frontends (``[phase frontends]``), after the SSD phase:
   musicgen-medium (48 layers, d_model 1536, 4 codebooks of 2048) and
   internvl2-2b (24 layers, d_model 2048, 16 heads over 8 KV heads of
   128, 256 image tokens from stub embeddings drawn from a seeded
   generator) at full width and depth, random weights from a seeded
   generator, fp32 then bf16. musicgen through ``generate`` (4 x 256
   prompt tokens x 4 codebooks, 32 new tokens, output (4, 288, 4));
   internvl2 through ``prefill`` and 31 greedy contiguous
   ``decode_step`` calls. In fp32, at new tokens 0, 8 and 31, a prefill
   of the prompt and the tokens before picks, greedy, the token emitted,
   from logits within 1e-4 of the decode step's. In bf16: ms per token,
   a decode-step profile (kernels, the device's busy share; every
   decode-step profile of the script must record each kernel a whole
   number of times per step) and peak memory. No kernel runs on these contiguous paths (B2's launches 0).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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
    EngineConfig, PagePool, Request, Router, SlotScheduler, bucket_len,
    derive_draft_params, generate, rnn_serve_frames, serve_continuous,
    serve_disaggregated, simulate_replicas,
)
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serve.scheduler import (  # noqa: E402
    fit_cache_len, grow_cache, insert_paged_cache,
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
# the rest of the serve path (phase 7)
GEN_SHAPE = (4, 256)       # generate: four 256-token prompts, numpy seed 1
PREFIX_LEN = 512
SUFFIX_LENS = (16, 40, 97, 150, 200, 256, 300, 333)
PREFIX_ENGINE = LM_ENGINE.replace(use_kernel=True, prefix_cache=True)
MIN_PREFIX_HITS = 7
SPEC_K = 4
DRAFT_RATES = (0.0, 0.5)
# the MLA + MoE slice: deepseek-v2-236b at full width. 2 layers are 36.0 GB
# of fp32 weights, 4 are 33.9 GB in bf16 (+ the 2.1 GB fp32 head); the full
# 60 are 479 GB. Powers of two, so that bucketed (paged) and unbucketed
# (contiguous) prefill see the same tokens: MoE capacity is per chunk.
DS_ARCH = "deepseek-v2-236b"
DS_LAYERS = {"float32": 2, "bfloat16": 4}
DS_PROMPT_LENS = (64, 64, 128, 128, 256, 256, 512, 1024)
DS_MAX_NEW = 32
# the SSD and hybrid slice, at full width and depth
SSD_ARCHS = ("hymba-1.5b", "mamba2-370m")
SHORT_LENS = (1, 2)        # shorter than conv_k - 1: a 1-row conv state
# the frontends, at full width and depth: GEN_SHAPE prompts (x 4 codebooks
# for musicgen, after 256 stub image tokens for internvl2), MAX_NEW tokens
FRONTEND_ARCHS = ("musicgen-medium", "internvl2-2b")
# new tokens held against a prefill of the prompt and every token before
CHECK_AT = (0, 8, 31)


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


def device_kernel_ms(fn, names=("csb_mvm_kernel",), reps=20,
                     once_per_call=False):
    """Device time per call of fn of every kernel whose name contains one
    of ``names`` (every kernel if ``names`` is None), from torch.profiler:
    (total ms, {kernel: ms}), or (None, {}) where the profiler shows no
    device time. With ``once_per_call`` (each named kernel launched once
    a call) a kernel's time is its mean over the launches the profiler
    recorded, which late in a long run are not always all of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and (names is None or any(nm in ev.key for nm in names))]
    if once_per_call and any(ev.count < reps for ev in evs):
        print(f"  the profiler recorded {[ev.count for ev in evs]} of "
              f"{reps} launches a kernel; times are means over those")
    each = {ev.key: ev.self_device_time_total / 1e3
            / (ev.count if once_per_call else reps) for ev in evs}
    total = sum(each.values())
    if once_per_call and not all(any(nm in k for k in each) for nm in names):
        print(f"  the profiler recorded no launch of some of {names}")
        return None, each
    return (total if total > 0 else None), each


def traced_kernels(fn, names, calls=3) -> list:
    """(name, grid) of every kernel whose name contains one of ``names``
    that ``calls`` calls of fn launch, in launch order, read from
    torch.profiler's trace after two calls of warm-up (a trace of one
    call alone can miss its first kernel); the grid is None where the
    trace does not record it."""
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
    for ev in sorted(events, key=lambda e: e.get("ts", 0)):
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
EXACT_CASES = ("MLA 128 heads, rope, D 512 + 64", "gemma-2b decode shape",
               "hymba-1.5b decode shape", "internvl2-2b decode shape")


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


def paged_kernel_phase(dev) -> dict:
    """B2 kernel vs plain version; returns the max abs errors at
    gemma-2b's, hymba-1.5b's and internvl2-2b's decode shapes."""
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
    # hymba-1.5b's attention: 25 heads over 5 KV heads (5 heads per CTA)
    tab, n = _slot_table(rng, gemma, 16, 65)
    cases["hymba-1.5b decode shape"] = dict(b=4, h=25, kv=5, d=64, psz=16,
                                            n_pages=n, table=tab, pos=gemma)
    # internvl2-2b's attention: 16 heads over 8 KV heads of 128
    tab, n = _slot_table(rng, gemma, 16, 65)
    cases["internvl2-2b decode shape"] = dict(
        b=4, h=16, kv=8, d=128, psz=16, n_pages=n, table=tab, pos=gemma)
    table, pos, n, shared = shared_page_snapshot(get_config(ARCH).vocab)
    cases[f"prefix trace, {shared} pages mapped by several slots"] = dict(
        b=len(pos), n_pages=n, table=table, pos=pos.tolist(), **gem)
    f32, bf16 = torch.float32, torch.bfloat16
    n_cmp, worst = 0, {f32: (0.0, ""), bf16: (0.0, "")}
    err_at = {"gemma": 0.0, "hymba": 0.0, "internvl2": 0.0}
    for label, kw in cases.items():
        case = paged_case(rng, dev, **kw)
        for pool_dt, q_dt in ((f32, f32), (bf16, bf16), (bf16, f32)):
            err = compare_paged(
                f"{label} [pools {pool_dt}, q {q_dt}]",
                _cast(case, pool_dt, q_dt),
                exact=label in EXACT_CASES and pool_dt == q_dt == f32)
            n_cmp += 1
            worst[pool_dt] = max(worst[pool_dt], (err, label))
            model = ("gemma" if label.startswith(("gemma", "prefix trace"))
                     else label.split("-")[0] if label.startswith(
                         ("hymba", "internvl2")) else None)
            if model:
                err_at[model] = max(err_at[model], err)
                print(f"  {label}, pools {pool_dt}, q {q_dt}: max abs err "
                      f"{err:.3e}")
    print(f"paged kernel phase: {n_cmp} comparisons passed (tol "
          f"{PAGED_TOL[f32]:g} fp32 pools, {PAGED_TOL[bf16]:g} bf16 pools); "
          f"max abs err at gemma-2b's shape (own and shared-page tables) "
          f"{err_at['gemma']:.3e}, at hymba-1.5b's {err_at['hymba']:.3e}, "
          f"at internvl2-2b's {err_at['internvl2']:.3e}; "
          f"over all "
          f"cases {worst[f32][0]:.3e} with fp32 pools ({worst[f32][1]}), "
          f"{worst[bf16][0]:.3e} with bf16 pools ({worst[bf16][1]})")
    return err_at


def prefix_requests(vocab: int, max_new: int = MAX_NEW) -> list:
    """Eight requests sharing one 512-token prefix, distinct suffixes."""
    rng = np.random.default_rng(SEED + 5)
    prefix = rng.integers(0, vocab, size=PREFIX_LEN)
    return [Request(rid=i, tokens=np.concatenate(
                [prefix, rng.integers(0, vocab, size=n)]),
                    max_new_tokens=max_new, arrival=a)
            for i, (n, a) in enumerate(zip(SUFFIX_LENS, ARRIVALS))]


def replay_prefix(vocab: int):
    """The prefix phase's admission and decode protocol replayed on the
    host (the engine's: one admission at a time, copy-on-write, ensure,
    register; then ensure per step). Yields (pool, scheduler) before each
    decode step; the tables depend on the prompts alone, not on the
    tokens sampled."""
    psz, n_slots = PREFIX_ENGINE.page_size, PREFIX_ENGINE.n_slots
    reqs = prefix_requests(vocab)
    max_pages = -(-max(r.prompt_len + MAX_NEW for r in reqs) // psz)
    pool = PagePool(psz, n_slots * max_pages, n_slots, max_pages,
                    prefix_cache=True, device="cpu")
    sched = SlotScheduler(n_slots, pool=pool)
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        while batch := sched.admit(limit=1):
            [(slot, r)] = batch
            pool.cow_if_needed(slot)
            pool.ensure(slot, r.prompt_len)
            pool.register_prefix(slot, r.tokens)
            sched.started(slot, 0)
        active = sched.active_mask()
        if not active.any():
            sched.idle_tick()
            continue
        for i in np.flatnonzero(active):
            pool.ensure(int(i), int(sched.positions()[i]) + 1)
        yield pool, sched
        sched.advance(np.zeros(n_slots, np.int64))


def shared_page_snapshot(vocab: int):
    """The decode step of the prefix trace whose page table maps the most
    physical pages into more than one slot: (table, pos, pool pages with
    the scratch page, shared page count)."""
    best = None
    for pool, sched in replay_prefix(vocab):
        table = pool.device_table().numpy().copy()
        live = table[sched.active_mask()]
        pages, counts = np.unique(live[live != pool.scratch_page],
                                  return_counts=True)
        shared = int((counts > 1).sum())
        if best is None or shared > best[3]:
            best = (table, sched.positions().copy(), pool.n_pages + 1,
                    shared)
    if best is None or best[3] == 0:
        raise AssertionError("no decode step of the prefix trace maps a "
                             "page into two slots")
    return best


def lm_requests(vocab: int, lens=PROMPT_LENS, max_new: int = MAX_NEW
                ) -> list:
    rng = np.random.default_rng(SEED)
    return [Request(rid=i, tokens=rng.integers(0, vocab, size=n),
                    max_new_tokens=max_new, arrival=a)
            for i, (n, a) in enumerate(zip(lens, ARRIVALS))]


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


def first_step(cfg, params, dev, trace=None):
    """The run's first decode step rebuilt by hand: the four requests
    that arrive at step 0 (of ``trace``, default the LM trace) prefilled
    (bucketed where the engine buckets: not for SSD and hybrid) into a
    fresh pool; returns (cache, tokens, pos, table, head)."""
    trace = trace or lm_requests(cfg.vocab)
    reqs = trace[:LM_ENGINE.n_slots]
    psz = LM_ENGINE.page_size
    cache_len = max(r.prompt_len + r.max_new_tokens for r in trace)
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
            pool.reserve(slot, plen + r.max_new_tokens)
            pool.ensure(slot, plen + 1)
            toks = r.tokens
            if cfg.mixer in ("attn", "mla"):
                toks = np.pad(toks, (0, bucket_len(plen) - plen))
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


def first_step_logits(cfg, params, dev, trace=None):
    """First decode step's logits through the kernel and the gather path
    on the same cache; returns (kernel, gather, step state)."""
    cache, cur, pos, table, head = first_step(cfg, params, dev, trace)
    out = []
    with torch.no_grad():
        for use_kernel in (True, False):
            c = _tree(cache, torch.clone)
            lg, _ = LM.decode_step_paged(params, c, cur, pos, table, cfg,
                                         use_kernel=use_kernel, head=head)
            out.append(lg[:, 0])
    return out[0], out[1], (cache, cur, pos, table, head)


def replay_positions(vocab: int, reqs=None) -> list:
    """Per decode step of a trace (default the LM trace), the (pos,
    active) arrays the engine feeds the step: the scheduler and pool
    replayed on the host."""
    reqs = reqs or lm_requests(vocab)
    psz, n_slots = LM_ENGINE.page_size, LM_ENGINE.n_slots
    max_pages = -(-max(r.prompt_len + r.max_new_tokens for r in reqs)
                  // psz)
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
        cfg=cfg16, params=p16, steps=steps, cfg32=cfg32, params32=p32,
        tokens32=g32[0].tokens, launches32=k32[1],
        launches=k32[1] + k16[1], steady_tokens_per_sec=res.stats[
            "steady_tokens_per_sec"],
        step_p50_us=step["p50"], step_p99_us=step["p99"],
        ttft_p50_us=ttft["p50"], ttft_p99_us=ttft["p99"],
        peak_gb=peak / 1e9, bf16_token_agreement=same / total)
    return out


def _per_token_ms(res) -> float:
    return 1e3 * res.wall_s / max(res.stats["generated_tokens"], 1)


def token_mismatch(what, cfg, params, prompt, got, want):
    """Raise on the first step where ``got`` leaves ``want``, after
    printing the step and the top-2 margin of the logits there, from a
    prefill of the prompt and ``want``'s tokens before it."""
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = np.concatenate([np.asarray(prompt), np.asarray(want[:j])])
    with torch.no_grad():
        lg, _ = LM.prefill(params, {"tokens": torch.as_tensor(
            seq, device=params["embed"].device)[None]}, cfg)
    top = torch.topk(lg[0], 2)
    print(f"  {what}: first differing token at step {j}: got {got[j]}, "
          f"want {want[j]}; top-2 logits there {top.values.tolist()} "
          f"(ids {top.indices.tolist()}), margin "
          f"{float(top.values[0] - top.values[1]):.3e}")
    raise AssertionError(f"{what}: fp32 tokens differ from step {j}")


def same_tokens(what, cfg, params, reqs, got: dict, want: dict) -> None:
    for r in reqs:
        if got[r.rid] != want[r.rid]:
            token_mismatch(f"{what}, request {r.rid}", cfg, params,
                           r.tokens, got[r.rid], want[r.rid])


def b2_launches(what, cfg, res, use_kernel=True) -> int:
    """B2's launches over one run, held to 2 x layers x the run's
    single-query paged decode steps (0 off the kernel path)."""
    launches = paged_attn.LAUNCHES
    want = (paged_attn.KERNELS_PER_CALL * cfg.n_layers
            * res.stats["decode_steps"] if use_kernel else 0)
    if launches != want:
        raise AssertionError(f"{what}: paged_attn launched {launches} "
                             f"kernels, expected {want}")
    return launches


def generate_phase(lm, dev) -> int:
    """``generate`` at full width, fp32 tokens against paged serving."""
    prompts = np.random.default_rng(SEED + 1).integers(
        0, lm["cfg"].vocab, size=GEN_SHAPE)
    b, s = GEN_SHAPE
    launches = 0
    for cfg, params in ((lm["cfg32"], lm["params32"]),
                        (lm["cfg"], lm["params"])):
        torch.cuda.synchronize()
        paged_attn.LAUNCHES = 0
        t0 = time.perf_counter()
        out = generate(params, cfg, prompts,
                       EngineConfig(max_new_tokens=MAX_NEW))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if paged_attn.LAUNCHES:
            raise AssertionError("generate launched the paged kernel")
        gen = out[:, s:].cpu().numpy()
        if out.shape != (b, s + MAX_NEW) or not np.array_equal(
                out[:, :s].cpu().numpy(), prompts) \
                or gen.min() < 0 or gen.max() >= cfg.vocab:
            raise AssertionError(f"generate: bad output {tuple(out.shape)}")
        reqs = [Request(rid=i, tokens=prompts[i], max_new_tokens=MAX_NEW)
                for i in range(b)]
        paged_attn.LAUNCHES = 0
        res = serve_continuous(params, cfg, reqs,
                               LM_ENGINE.replace(use_kernel=True))
        launches += b2_launches("generate's paged twin", cfg, res)
        got = {i: gen[i].tolist() for i in range(b)}
        agree = sum(a == c for i in range(b)
                    for a, c in zip(got[i], res.tokens[i]))
        print(f"  generate {cfg.dtype}: {b} x {s}-token prompts, {MAX_NEW} "
              f"new tokens in {wall:.2f} s wall (prefill included): "
              f"{1e3 * wall / (b * MAX_NEW):.2f} ms per token, "
              f"{b * MAX_NEW / wall:.1f} tok/s; paged serving of the same "
              f"requests {_per_token_ms(res):.2f} ms per token; tokens "
              f"agree at {agree}/{b * MAX_NEW}")
        if cfg is lm["cfg32"]:
            same_tokens("generate vs paged serving", cfg, params, reqs,
                        got, res.tokens)
    return launches


def contiguous_phase(lm) -> None:
    """``serve_continuous(paged=False)`` on the LM trace, fp32 tokens
    against the paged path's."""
    cfg, params = lm["cfg32"], lm["params32"]
    reqs = lm_requests(cfg.vocab)
    paged_attn.LAUNCHES = 0
    res = serve_continuous(params, cfg, reqs,
                           EngineConfig(n_slots=LM_ENGINE.n_slots))
    b2_launches("contiguous serving", cfg, res, use_kernel=False)
    print(f"  contiguous fp32: {res.stats['decode_steps']} decode steps, "
          f"cache_len {res.stats['cache_len']}, prefill tokens "
          f"{res.stats['prefill_tokens']} (unbucketed), steady "
          f"{res.stats['steady_tokens_per_sec']} tok/s, "
          f"{_per_token_ms(res):.2f} ms per token over {res.wall_s:.2f} s")
    same_tokens("contiguous vs paged serving", cfg, params, reqs,
                res.tokens, lm["tokens32"])
    print("  contiguous fp32 tokens equal the paged path's")


def prefix_phase(lm) -> dict:
    """The prefix cache through B2: on/off in fp32 and bf16."""
    out = {"launches": 0}
    for cfg, params in ((lm["cfg32"], lm["params32"]),
                        (lm["cfg"], lm["params"])):
        reqs = prefix_requests(cfg.vocab)
        runs = {}
        for on in (True, False):
            paged_attn.LAUNCHES = 0
            res = serve_continuous(params, cfg, reqs,
                                   PREFIX_ENGINE.replace(prefix_cache=on))
            out["launches"] += b2_launches(
                f"prefix_cache={on} {cfg.dtype}", cfg, res)
            runs[on] = res
            st = res.stats
            print(f"  prefix_cache={on} {cfg.dtype}: "
                  f"{st['decode_steps']} decode steps, prefill tokens "
                  f"{st['prefill_tokens']}, prefix hits "
                  f"{st.get('prefix_hits', 0)}, shared pages "
                  f"{st.get('shared_pages', 0)}, copy-on-write copies "
                  f"{st['paging'].get('cow_copies', 0)}; steady "
                  f"{st['steady_tokens_per_sec']} tok/s, "
                  f"{_per_token_ms(res):.2f} ms per token over "
                  f"{res.wall_s:.2f} s (first calls {st['compile_time_s']}"
                  f" s)")
        on, off = runs[True], runs[False]
        steps = sum(1 for _ in replay_prefix(cfg.vocab))
        if steps != on.stats["decode_steps"]:
            raise AssertionError(f"the host replay took {steps} decode "
                                 f"steps, the run {on.stats['decode_steps']}")
        if on.stats["prefix_hits"] < MIN_PREFIX_HITS \
                or on.stats["shared_pages"] <= 0:
            raise AssertionError(f"prefix cache: {on.stats['prefix_hits']}"
                                 f" hits, {on.stats['shared_pages']} shared"
                                 f" pages")
        if cfg is lm["cfg32"]:
            same_tokens("prefix cache on vs off", cfg, params, reqs,
                        on.tokens, off.tokens)
            print("  fp32 tokens with the prefix cache equal those without")
            out.update(hits=on.stats["prefix_hits"], tokens_on=on.tokens,
                       shared_pages=on.stats["shared_pages"],
                       prefill_on=on.stats["prefill_tokens"],
                       prefill_off=off.stats["prefill_tokens"])
        else:
            agree = sum(a == b for r in reqs for a, b in
                        zip(on.tokens[r.rid], off.tokens[r.rid]))
            print(f"  bf16 tokens with and without the prefix cache agree "
                  f"at {agree}/{len(reqs) * MAX_NEW}")
    return out


def speculative_phase(lm) -> None:
    """Speculative serving of the LM trace, fp32, against plain paged
    serving's tokens; the draft's derivation timed at full width."""
    cfg, params = lm["cfg32"], lm["params32"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draft = derive_draft_params(params, DRAFT_RATES[-1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    w = draft["layers"][0]["ffn"]["w_up"]
    print(f"  derive_draft_params at rate {DRAFT_RATES[-1]}: {dt:.2f} s for "
          f"{7 * cfg.n_layers} weight matrices (layer 0 w_up density "
          f"{float((w != 0).float().mean()):.4f})")
    del draft, w
    reqs = lm_requests(cfg.vocab)
    for rate in DRAFT_RATES:
        engine = LM_ENGINE.replace(use_kernel=True, speculative=True,
                                   spec_k=SPEC_K, draft_prune_rate=rate)
        paged_attn.LAUNCHES = 0
        res = serve_continuous(params, cfg, reqs, engine)
        # every verify step carries k+1 queries: the gather path, no B2
        b2_launches(f"speculative rate {rate}", cfg, res, use_kernel=False)
        sp = res.stats["speculative"]
        decoded = res.stats["generated_tokens"] - len(reqs)
        print(f"  speculative fp32, spec_k {SPEC_K}, draft prune rate "
              f"{rate}: {sp['rounds']} rounds, acceptance "
              f"{sp['acceptance_rate']} ({sp['accepted']}/{sp['proposed']}"
              f"), {decoded / sp['rounds']:.2f} tokens per round over the "
              f"batch, {_per_token_ms(res):.2f} ms per token over "
              f"{res.wall_s:.2f} s (first calls "
              f"{res.stats['compile_time_s']} s)")
        same_tokens(f"speculative rate {rate} vs paged serving", cfg,
                    params, reqs, res.tokens, lm["tokens32"])
    print("  speculative fp32 tokens equal plain paged serving's")


# ---------------------------------------------------------------------------
# the MLA + MoE slice: deepseek-v2-236b at full width, its depth cut
# ---------------------------------------------------------------------------

def build_deepseek(dtype: str, dev):
    """deepseek-v2-236b at full width, cut to the depth one card holds,
    random weights from a seeded generator in ``dtype``."""
    full = get_config(DS_ARCH)
    cfg = dataclasses.replace(full, n_layers=DS_LAYERS[dtype], dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = LM.init_params(cfg, gen, device=dev)
    n = sum(t.numel() for t in _leaves(params))
    # param_count() leaves out MLA's two norm scales
    want = cfg.param_count() + cfg.n_layers * (cfg.q_lora + cfg.kv_lora)
    if n != want:
        raise AssertionError(f"{n} parameters, the config counts {want}")
    size = n * torch.finfo(getattr(torch, dtype)).bits // 8
    print(f"{DS_ARCH} {dtype}: full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, head_dim {cfg.hd}, q_lora {cfg.q_lora}, "
          f"kv_lora {cfg.kv_lora}, rope {cfg.rope_head_dim}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared} shared,"
          f" moe_dff {cfg.moe_dff}, vocab {cfg.vocab}); depth cut "
          f"{full.n_layers} -> {cfg.n_layers} layers to fit one card: {n} "
          f"parameters, {size / 1e9:.2f} GB of weights")
    return cfg, params


def serve_run(what, cfg, params, reqs, engine, observe=False,
              serve=serve_continuous):
    """One run of a trace through ``serve`` (``serve_continuous`` or
    ``serve_disaggregated``), B2's launches held to 2 x layers x
    single-query paged steps (0 off the kernel path, and for SSD, which
    has no attention)."""
    if observe:
        obs_trace.enable()
        obs_metrics.enable()
    paged_attn.LAUNCHES = 0
    res = serve(params, cfg, reqs, engine)
    single = (engine.paged and engine.use_kernel
              and not engine.speculative and cfg.mixer != "ssd")
    launches = b2_launches(what, cfg, res, use_kernel=single)
    if single and launches <= 0:
        raise AssertionError(f"{what}: B2 was never launched")
    tr = obs_trace.disable() if observe else None
    reg = obs_metrics.disable() if observe else None
    for r in reqs:
        toks = res.tokens.get(r.rid)
        if toks is None or len(toks) != r.max_new_tokens \
                or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{what}, request {r.rid}: bad tokens")
    st = res.stats
    print(f"  {what}: {st['decode_steps']} decode steps, {launches} B2 "
          f"launches, prefill tokens {st['prefill_tokens']}, steady "
          f"{st['steady_tokens_per_sec']} tok/s, {_per_token_ms(res):.2f} "
          f"ms per token over {res.wall_s:.2f} s (first calls "
          f"{st['compile_time_s']} s)")
    return res, launches, reg


def agreement(a: dict, b: dict) -> str:
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    return f"{same}/{sum(len(v) for v in a.values())}"


def b2_on_the_path(cfg, params, state, path="MLA") -> float:
    """B2 held against its plain version on the inputs the layers give it
    in one decode step (each layer's query and pools; MLA's q_c, q_rope
    and latent pools), at ``PAGED_TOL``; with fp32 pools also against the
    exact answer."""
    from repro_torch.kernels import ops
    cache, cur, pos, table, head = state
    calls = []
    run = ops.paged_attn_decode

    def spy(*args, **kw):
        calls.append((args, kw))
        return run(*args, **kw)

    ops.paged_attn_decode = spy
    try:
        with torch.no_grad():
            LM.decode_step_paged(params, _tree(cache, torch.clone), cur, pos,
                                 table, cfg, use_kernel=True, head=head)
    finally:
        ops.paged_attn_decode = run
    if len(calls) != cfg.n_layers:
        raise AssertionError(f"{len(calls)} B2 calls in a step of "
                             f"{cfg.n_layers} layers")
    worst = 0.0
    for li, ((q, kp, vp, tab, p), kw) in enumerate(calls):
        case = dict(q=q, k_pool=kp, v_pool=vp, page_table=tab, pos=p,
                    **{"window": None, **kw})
        worst = max(worst, compare_paged(
            f"{cfg.name} {cfg.dtype} layer {li} ({path} path)", case,
            exact=kp.dtype == torch.float32))
    print(f"  B2 on the {path} path ({cfg.dtype}, q {calls[0][0][0].dtype}, "
          f"pools {calls[0][0][1].dtype}, {len(calls)} layers): max abs err "
          f"vs plain {worst:.3e} (allclose, rtol = atol = "
          f"{PAGED_TOL[calls[0][0][1].dtype]:g})")
    return worst


def serve_metrics(what, res, reg) -> dict:
    hist = reg.to_dict(series=False)["histograms"]
    step, ttft = hist["serve/step/wall_us"], hist["serve/req/ttft_us"]
    out = {"ms_per_token": _per_token_ms(res),
           "steady_tokens_per_sec": res.stats["steady_tokens_per_sec"],
           "step_p50_us": step["p50"], "step_p99_us": step["p99"],
           "ttft_p99_us": ttft["p99"]}
    print(f"  {what} metrics: {out['ms_per_token']:.2f} ms per generated "
          f"token (wall, prefill included), steady "
          f"{out['steady_tokens_per_sec']} tok/s, decode step wall p50 "
          f"{step['p50']:.1f} us, p99 {step['p99']:.1f} us over "
          f"{step['count']} steps; TTFT p50 {ttft['p50']:.1f} us, p99 "
          f"{ttft['p99']:.1f} us")
    return out


def generate_vs_paged(cfg, params, max_new, how, why) -> int:
    """``generate`` on four 256-token prompts (numpy seed 1), then paged
    serving of the same requests through B2; prints the speed of both and
    their agreement (``how`` says how generate batches, ``why`` why the
    two may differ). Returns B2's launches."""
    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, size=GEN_SHAPE)
    b, s = GEN_SHAPE
    torch.cuda.synchronize()
    paged_attn.LAUNCHES = 0
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts,
                   EngineConfig(max_new_tokens=max_new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if paged_attn.LAUNCHES:
        raise AssertionError("generate launched the paged kernel")
    gen = out[:, s:].cpu().numpy()
    if out.shape != (b, s + max_new) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        raise AssertionError(f"generate: bad output {tuple(out.shape)}")
    greqs = [Request(rid=i, tokens=prompts[i], max_new_tokens=max_new)
             for i in range(b)]
    twin, n, _ = serve_run(f"generate's paged twin {cfg.dtype}", cfg,
                           params, greqs, LM_ENGINE.replace(use_kernel=True))
    print(f"  generate {cfg.dtype}: {b} x {s}-token prompts {how}, "
          f"{max_new} new tokens in {wall:.2f} s wall (prefill "
          f"included): {1e3 * wall / (b * max_new):.2f} ms per token, "
          f"{b * max_new / wall:.1f} tok/s; agrees with paged serving "
          f"({why}) at "
          f"{agreement({i: gen[i].tolist() for i in range(b)}, twin.tokens)}")
    return n


def deepseek_fp32_paths(cfg, params, paged_tokens) -> int:
    """Contiguous, prefix-cache, ``generate`` and speculative serving of
    the fp32 model; returns B2's launches over them."""
    launches = 0
    reqs = lm_requests(cfg.vocab, DS_PROMPT_LENS, DS_MAX_NEW)
    res, _, _ = serve_run("contiguous fp32", cfg, params, reqs,
                          EngineConfig(n_slots=LM_ENGINE.n_slots))
    same_tokens("contiguous vs paged serving", cfg, params, reqs,
                res.tokens, paged_tokens)
    print("  contiguous fp32 tokens equal the paged path's")
    preq = prefix_requests(cfg.vocab, DS_MAX_NEW)
    runs = {}
    for name, engine in (("prefix on, B2", PREFIX_ENGINE),
                         ("prefix on, gather",
                          PREFIX_ENGINE.replace(use_kernel=False)),
                         ("prefix off, B2",
                          PREFIX_ENGINE.replace(prefix_cache=False))):
        runs[name], n, _ = serve_run(f"{name} fp32", cfg, params, preq,
                                     engine)
        launches += n
    on = runs["prefix on, B2"]
    if on.stats["prefix_hits"] < MIN_PREFIX_HITS:
        raise AssertionError(f"prefix cache: {on.stats['prefix_hits']} hits")
    same_tokens("prefix on: B2 vs gather", cfg, params, preq, on.tokens,
                runs["prefix on, gather"].tokens)
    print(f"  prefix on fp32: {on.stats['prefix_hits']} hits, "
          f"{on.stats['shared_pages']} shared pages; B2 tokens equal the "
          f"gather path's; prefix on vs off agree at "
          f"{agreement(on.tokens, runs['prefix off, B2'].tokens)} (a suffix "
          f"is its own MoE chunk, in JAX too: not required equal)")
    launches += generate_vs_paged(
        cfg, params, DS_MAX_NEW, "in one MoE chunk",
        "each prompt its own chunk")
    engine = LM_ENGINE.replace(use_kernel=True, speculative=True,
                               spec_k=SPEC_K, draft_prune_rate=0.0)
    res, _, _ = serve_run("speculative fp32, rate 0", cfg, params, reqs,
                          engine)
    sp = res.stats["speculative"]
    print(f"  speculative fp32, spec_k {SPEC_K}, rate 0: {sp['rounds']} "
          f"rounds, acceptance {sp['acceptance_rate']} ({sp['accepted']}/"
          f"{sp['proposed']}), {res.stats['tokens_per_sec']} tok/s; agrees "
          f"with paged serving at {agreement(res.tokens, paged_tokens)} (the "
          f"verify step is one MoE chunk of {SPEC_K + 1} queries a slot)")
    return launches


def deepseek_phase(dev) -> dict:
    """deepseek-v2-236b at full width through MLA (B2's rope term) and
    MoE: fp32 at 2 layers, then bf16 at 4, one after the other."""
    out = {"launches": 0}
    for dtype in ("float32", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, params = build_deepseek(dtype, dev)
        reqs = lm_requests(cfg.vocab, DS_PROMPT_LENS, DS_MAX_NEW)
        print(f"  trace: {len(reqs)} greedy requests, prompts "
              f"{DS_PROMPT_LENS}, {DS_MAX_NEW} new tokens each, arrivals "
              f"{ARRIVALS}, {LM_ENGINE.n_slots} slots, page size "
              f"{LM_ENGINE.page_size}")
        k, nk, reg = serve_run(f"paged {dtype}, B2", cfg, params, reqs,
                               LM_ENGINE.replace(use_kernel=True),
                               observe=True)
        g, _, _ = serve_run(f"paged {dtype}, gather", cfg, params, reqs,
                            LM_ENGINE)
        out["launches"] += nk
        lk, lg, state = first_step_logits(cfg, params, dev, reqs)
        if not (torch.isfinite(lk).all() and torch.isfinite(lg).all()):
            raise AssertionError(f"{dtype}: non-finite logits")
        err = float((lk - lg).abs().max())
        print(f"  first decode step, {dtype}: logits {tuple(lk.shape)}, "
              f"B2 vs gather max abs diff {err:.3e}; max |logit| "
              f"{float(lg.abs().max()):.3f}")
        if dtype == "float32":
            same_tokens("deepseek paged: B2 vs gather", cfg, params, reqs,
                        k.tokens, g.tokens)
            print("  fp32: B2 tokens equal the gather path's, token for "
                  "token")
            if err > LOGIT_TOL[torch.float32]:
                raise AssertionError(f"fp32 first-step logits differ by "
                                     f"{err:.3e}")
        else:
            print(f"  bf16: B2 and gather tokens agree at "
                  f"{agreement(k.tokens, g.tokens)} (bf16: printed only)")
        out[f"b2_err_{dtype}"] = b2_on_the_path(cfg, params, state)
        out[dtype] = serve_metrics(f"paged {dtype}, B2", k, reg)
        out[dtype].update(decode_profile(f"{DS_ARCH} {dtype}", cfg, params,
                                         state))
        if dtype == "float32":
            out["launches"] += deepseek_fp32_paths(cfg, params, k.tokens)
        else:
            # B2 was timed at this trace's busiest step, replayed on the
            # host, in [phase B2 timing]
            replay_matches(cfg.vocab, reqs, k)
        print(f"  {DS_ARCH} {dtype}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del params, state, k, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the SSD and hybrid slice: hymba-1.5b and mamba2-370m, full width and depth
# ---------------------------------------------------------------------------

def build_ssd(arch: str, dtype: str, dev):
    """``arch`` at full width and depth in ``dtype``, random weights from
    a generator seeded ``SEED`` (the bf16 model is the fp32 one rounded:
    the same draws; SSD's a_log, d_skip and dt_bias stay fp32)."""
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    params = LM.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    n = sum(t.numel() for t in _leaves(params))
    # param_count() counts the unpadded vocab and two norms a layer, and
    # leaves out SSD's a_log, d_skip, dt_bias and out_norm and hybrid's
    # two output norms
    d = cfg.d_model
    extra = (3 * cfg.ssd_heads + cfg.d_inner
             + (2 * d if cfg.mixer == "hybrid" else 0)
             - (d if cfg.ffn == "none" else 0))
    want = (cfg.param_count() + cfg.n_layers * extra
            + (cfg.padded_vocab - cfg.vocab) * d
            * (1 if cfg.tie_embeddings else 2))
    if n != want:
        raise AssertionError(f"{n} parameters, the config counts {want}")
    size = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"{arch} {dtype}: full width and depth ({cfg.n_layers} layers, "
          f"d_model {d}, mixer {cfg.mixer}"
          + (f", {cfg.n_heads} heads over {cfg.n_kv} KV heads of "
             f"{cfg.hd}" if cfg.mixer == "hybrid" else "")
          + f", SSD {cfg.ssd_heads} heads of {cfg.ssd_headdim}, d_state "
          f"{cfg.d_state}, conv {cfg.conv_k}, chunk {cfg.ssd_chunk}, ffn "
          f"{cfg.ffn}, vocab {cfg.vocab}): {n} parameters "
          f"({cfg.param_count()} by param_count()), {size / 1e9:.2f} GB")
    return cfg, params


def ssd_phase(dev) -> dict:
    """hymba-1.5b (attention through B2 at 25 heads over 5, and SSD) and
    mamba2-370m (SSD alone: B2 never runs) at full width and depth, fp32
    and bf16, on the LM trace with bucketing off (as the engine sets it
    for these mixers)."""
    out = {"launches": 0}
    for arch in SSD_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, p32 = build_ssd(arch, "float32", dev)
        hybrid = cfg.mixer == "hybrid"
        reqs = lm_requests(cfg.vocab)
        k32, n, _ = serve_run(f"{arch} paged fp32, B2", cfg, p32, reqs,
                              LM_ENGINE.replace(use_kernel=True))
        out["launches"] += n
        if k32.stats["bucketed_prefill"]:
            raise AssertionError(f"{arch}: the engine bucketed prompts")
        paths = {"contiguous": EngineConfig(n_slots=LM_ENGINE.n_slots)}
        if hybrid:
            paths["paged, gather"] = LM_ENGINE
        for name, engine in paths.items():
            res, _, _ = serve_run(f"{arch} {name} fp32", cfg, p32, reqs,
                                  engine)
            same_tokens(f"{arch} {name} vs paged B2", cfg, p32, reqs,
                        res.tokens, k32.tokens)
        print(f"  {arch} fp32: tokens equal across paged "
              f"{'B2, gather' if hybrid else '(B2 on: 0 launches)'} and "
              f"contiguous serving")
        rng = np.random.default_rng(SEED + 6)
        short = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, size=s),
                         max_new_tokens=8) for i, s in enumerate(SHORT_LENS)]
        sp, n, _ = serve_run(f"{arch} prompts of {SHORT_LENS} tokens, paged",
                             cfg, p32, short,
                             LM_ENGINE.replace(use_kernel=True))
        out["launches"] += n
        sc, _, _ = serve_run(f"{arch} prompts of {SHORT_LENS} tokens, "
                             f"contiguous", cfg, p32, short,
                             EngineConfig(n_slots=LM_ENGINE.n_slots))
        same_tokens(f"{arch} short prompts, paged vs contiguous", cfg, p32,
                    short, sp.tokens, sc.tokens)
        print(f"  {arch} prompts of {SHORT_LENS} tokens (a 1-row conv "
              f"state written at the slot's start): paged and contiguous "
              f"tokens equal")
        out["launches"] += generate_vs_paged(
            cfg, p32, MAX_NEW, "prefilled together",
            "generate carries the prefill's fp32 SSM state, serving rounds "
            f"it to {cfg.ssd_state_dtype}, as in JAX")
        if hybrid:
            lk, lg, state = first_step_logits(cfg, p32, dev, reqs)
            print(f"  first decode step, fp32: B2 vs gather logits max abs "
                  f"diff {float((lk - lg).abs().max()):.3e}")
            out["b2_err_float32"] = b2_on_the_path(
                cfg, p32, state, "hybrid attention")
            del state
        del p32
        gc.collect()
        torch.cuda.empty_cache()
        cfg16, p16 = build_ssd(arch, "bfloat16", dev)
        k16, n, reg = serve_run(f"{arch} paged bf16, B2", cfg16, p16, reqs,
                                LM_ENGINE.replace(use_kernel=True),
                                observe=True)
        out["launches"] += n
        print(f"  {arch} bf16 and fp32 paged tokens agree at "
              f"{agreement(k16.tokens, k32.tokens)} (printed only)")
        met = serve_metrics(f"{arch} paged bf16, B2", k16, reg)
        state = first_step(cfg16, p16, dev, reqs)
        if hybrid:
            out["b2_err_bfloat16"] = b2_on_the_path(
                cfg16, p16, state, "hybrid attention")
        met.update(decode_profile(f"{arch} bfloat16", cfg16, p16, state))
        if hybrid:
            replay_matches(cfg16.vocab, reqs, k16)
        met["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"  {arch}: peak memory {met['peak_gb']:.2f} GB")
        out[arch] = met
        del p16, state, k16, k32
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# disaggregated serving and the router, on gemma-2b
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def serve_clocks(reqs):
    """Host clocks read the same way around either engine: each paged
    decode step's wall (the step synchronised) and each request's TTFT,
    from the moment the scheduler's step clock reached its arrival to its
    first token (``SlotScheduler.started``). The clock reaches step 0
    when the block is entered and step k when decode step k ends; a
    request started at a clock that is not the count of steps run (an
    idle tick) raises. Yields a dict filled when the block ends:
    ``step_us`` and ``ttft_us`` (lists)."""
    runner = serve_engine._Runner
    step_paged, started = runner.step_paged, SlotScheduler.started
    ends, first = [time.perf_counter_ns()], {}
    out = {"step_us": [], "ttft_us": []}

    def timed_step(self, *args, **kw):
        t0 = time.perf_counter_ns()
        res = step_paged(self, *args, **kw)
        torch.cuda.synchronize()
        ends.append(time.perf_counter_ns())
        out["step_us"].append((ends[-1] - t0) / 1e3)
        return res

    def timed_started(self, slot, token):
        if self.now != len(ends) - 1:
            raise AssertionError(f"scheduler clock {self.now} after "
                                 f"{len(ends) - 1} decode steps")
        first[self.slot_rids()[slot]] = time.perf_counter_ns()
        return started(self, slot, token)

    runner.step_paged, SlotScheduler.started = timed_step, timed_started
    try:
        yield out
    finally:
        runner.step_paged, SlotScheduler.started = step_paged, started
    arrival = {r.rid: r.arrival for r in reqs}
    out["ttft_us"] = [(t - ends[arrival[rid]]) / 1e3
                      for rid, t in first.items()]


def clocked_metrics(what, runs, clocks) -> dict:
    """Serving metrics over ``runs`` of one engine, their clocks pooled."""
    steps = [t for c in clocks for t in c["step_us"]]
    ttft = [t for c in clocks for t in c["ttft_us"]]
    out = {"ms_per_token": statistics.mean(_per_token_ms(r) for r in runs),
           "steady_tokens_per_sec": statistics.mean(
               r.stats["steady_tokens_per_sec"] for r in runs),
           "step_p50_us": float(np.percentile(steps, 50)),
           "step_p99_us": float(np.percentile(steps, 99)),
           "ttft_p50_us": float(np.percentile(ttft, 50)),
           "ttft_p99_us": float(np.percentile(ttft, 99))}
    print(f"  {what} metrics over {len(runs)} runs: {out['ms_per_token']:.2f}"
          f" ms per generated token (wall, prefill included), steady "
          f"{out['steady_tokens_per_sec']:.3f} tok/s, decode step wall p50 "
          f"{out['step_p50_us']:.1f} us, p99 {out['step_p99_us']:.1f} us "
          f"over {len(steps)} steps; TTFT from arrival p50 "
          f"{out['ttft_p50_us']:.1f} us, p99 {out['ttft_p99_us']:.1f} us "
          f"over {len(ttft)} requests")
    return out


def disagg_phase(lm, px) -> dict:
    """gemma-2b through the prefill and decode tiers: fp32 tokens equal
    paged serving's through B2 and through the gather path, B2's
    launches equal the paged run's; the prefix trace through both tiers;
    bf16 metrics beside paged serving's, read by the same clocks."""
    cfg, params = lm["cfg32"], lm["params32"]
    reqs = lm_requests(cfg.vocab)
    out = {"launches": 0}
    for name, engine in (("B2", LM_ENGINE.replace(use_kernel=True)),
                         ("gather", LM_ENGINE)):
        res, n, _ = serve_run(f"disagg fp32, {name}", cfg, params, reqs,
                              engine, serve=serve_disaggregated)
        same_tokens(f"disagg {name} vs paged serving", cfg, params, reqs,
                    res.tokens, lm["tokens32"])
        if res.stats["handoffs"] != len(reqs) \
                or res.stats["handoff_pages"] <= 0:
            raise AssertionError(f"disagg {name}: {res.stats['handoffs']} "
                                 f"handoffs, {res.stats['handoff_pages']} "
                                 f"pages")
        if name == "B2":
            if n != lm["launches32"]:
                raise AssertionError(f"disagg: B2 launched {n} kernels, "
                                     f"the paged run {lm['launches32']}")
            out["launches"] += n
            out.update(decode_steps=res.stats["decode_steps"],
                       handoffs=res.stats["handoffs"],
                       handoff_pages=res.stats["handoff_pages"])
    print(f"  disagg fp32: B2 and gather tokens equal paged serving's; B2 "
          f"launches {out['launches']} = the paged run's; "
          f"{out['handoffs']} handoffs mapping {out['handoff_pages']} pages")
    preq = prefix_requests(cfg.vocab)
    runs = {}
    for on in (True, False):
        runs[on], n, _ = serve_run(
            f"disagg prefix_cache={on} fp32, B2", cfg, params, preq,
            PREFIX_ENGINE.replace(prefix_cache=on),
            serve=serve_disaggregated)
        out["launches"] += n
    on, off = runs[True], runs[False]
    same_tokens("disagg prefix cache on vs off", cfg, params, preq,
                on.tokens, off.tokens)
    same_tokens("disagg vs serve_continuous, prefix cache on", cfg, params,
                preq, on.tokens, px["tokens_on"])
    if on.stats["prefix_hits"] != px["hits"] \
            or on.stats["prefill_tokens"] >= off.stats["prefill_tokens"]:
        raise AssertionError(
            f"disagg prefix cache: {on.stats['prefix_hits']} hits (paged "
            f"serving {px['hits']}), prefill tokens "
            f"{on.stats['prefill_tokens']} on, "
            f"{off.stats['prefill_tokens']} off")
    out.update(prefix_hits=on.stats["prefix_hits"],
               prefill_tokens_on=on.stats["prefill_tokens"],
               prefill_tokens_off=off.stats["prefill_tokens"])
    print(f"  disagg prefix trace: tokens equal with the cache on and off "
          f"and to paged serving's; {out['prefix_hits']} hits as paged "
          f"serving; prefill tokens {out['prefill_tokens_on']} on, "
          f"{out['prefill_tokens_off']} off")
    # bf16, in turns (paged, disagg, disagg, paged): host clocks drift
    # within a run
    cfg16, p16 = lm["cfg"], lm["params"]
    engines = (("paged", serve_continuous), ("disagg", serve_disaggregated))
    runs = {name: ([], []) for name, _ in engines}
    for name, serve in engines + engines[::-1]:
        with serve_clocks(reqs) as clocks:
            res, n, _ = serve_run(f"{name} bf16, B2", cfg16, p16, reqs,
                                  LM_ENGINE.replace(use_kernel=True),
                                  serve=serve)
        out["launches"] += n
        runs[name][0].append(res)
        runs[name][1].append(clocks)
    for name, (results, clocks) in runs.items():
        out[f"{name}_bfloat16"] = clocked_metrics(f"{name} bf16, B2",
                                                  results, clocks)
    last = runs["disagg"][0][-1].stats
    out["disagg_bfloat16"].update(handoffs=last["handoffs"],
                                  handoff_pages=last["handoff_pages"])
    return out


def router_phase(lm, step_us: float) -> dict:
    """``Router(2)`` over ``serve_continuous`` and over
    ``serve_disaggregated`` on the LM trace, fp32 through B2: the single
    engine's tokens, both replicas busy. ``simulate_replicas``' host
    replay for both policies at the measured step time is printed only:
    it is a model, not a measurement."""
    cfg, params = lm["cfg32"], lm["params32"]
    reqs = lm_requests(cfg.vocab)
    engine = LM_ENGINE.replace(use_kernel=True)
    out = {"launches": 0}
    for kind in ("continuous", "disagg"):
        router = Router(2, engine, engine=kind)
        paged_attn.LAUNCHES = 0
        res = router.serve(params, cfg, reqs)
        launches = paged_attn.LAUNCHES
        steps = sum(r.stats["decode_steps"] for r in res.per_replica)
        want = paged_attn.KERNELS_PER_CALL * cfg.n_layers * steps
        if launches != want or launches <= 0:
            raise AssertionError(f"router {kind}: B2 launched {launches} "
                                 f"kernels, expected {want}")
        same_tokens(f"router {kind} vs one engine", cfg, params, reqs,
                    res.tokens, lm["tokens32"])
        split = res.stats["replica_requests"]
        if len(split) != 2 or min(split) <= 0:
            raise AssertionError(f"router {kind}: requests per replica "
                                 f"{split}")
        out["launches"] += launches
        out[kind] = {"replica_requests": split, "decode_steps": steps,
                     "ms_per_token": 1e3 * res.wall_s
                     / res.stats["generated_tokens"]}
        print(f"  router {kind}, fp32, B2: requests per replica {split}, "
              f"{steps} decode steps, {launches} B2 launches, "
              f"{out[kind]['ms_per_token']:.2f} ms per token over "
              f"{res.wall_s:.2f} s; tokens equal one engine's")
    for policy in ("round_robin", "least_loaded"):
        sim = simulate_replicas(reqs, 2, policy=policy,
                                n_slots=engine.n_slots, step_time_us=step_us)
        print(f"  simulate_replicas (host replay x step p50) {policy}, 2 replicas x "
              f"{engine.n_slots} slots at {step_us:.1f} us a step: TTFT "
              f"p50 {sim['ttft_us']['p50']:.1f} us, p99 "
              f"{sim['ttft_us']['p99']:.1f}; latency p50 "
              f"{sim['latency_us']['p50']:.1f}, p99 "
              f"{sim['latency_us']['p99']:.1f}")
    return out


# ---------------------------------------------------------------------------
# the frontends: musicgen-medium and internvl2-2b at full width and depth
# ---------------------------------------------------------------------------

def build_frontend(arch: str, dtype: str, dev):
    """``arch`` at full width and depth in ``dtype``, random weights from
    a generator seeded ``SEED`` (the bf16 model is the fp32 one rounded)."""
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    params = LM.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    n = sum(t.numel() for t in _leaves(params))
    # param_count() counts one embedding and one head of `vocab` rows
    d = cfg.d_model
    rows = (cfg.n_codebooks * cfg.vocab if cfg.n_codebooks
            else cfg.padded_vocab)
    want = (cfg.param_count() + 2 * (rows - cfg.vocab) * d
            + (1024 * d if cfg.n_img_tokens else 0))
    if n != want:
        raise AssertionError(f"{n} parameters, the config counts {want}")
    size = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"{arch} {dtype}: full width and depth ({cfg.n_layers} layers, "
          f"d_model {d}, {cfg.n_heads} heads over {cfg.n_kv} KV heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          + (f", {cfg.n_codebooks} codebooks" if cfg.n_codebooks else "")
          + (f", {cfg.n_img_tokens} image tokens" if cfg.n_img_tokens
             else "")
          + f"): {n} parameters, {size / 1e9:.2f} GB")
    return cfg, params


def frontend_batch(cfg, dev) -> dict:
    """GEN_SHAPE prompts from a numpy seed (x K codebooks); internvl2's
    stub image embeddings (B, 256, 1024) from a seeded generator."""
    b, s = GEN_SHAPE
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    toks = np.random.default_rng(SEED + 7).integers(0, cfg.vocab,
                                                     size=shape)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    if cfg.n_img_tokens:
        batch["img_embeds"] = torch.randn(
            (b, cfg.n_img_tokens, 1024), device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 7))
    return batch


@contextlib.contextmanager
def runner_logits():
    """The logits of every prefill and contiguous decode step the
    engine's runner makes (``generate``'s), in call order, each (B, K, V)
    for a codebook model."""
    runner = serve_engine._Runner
    prefill, step = runner.prefill, runner.step
    seen = []

    def keep(fn):
        def call(self, *args, **kw):
            lg, cache = fn(self, *args, **kw)
            seen.append(lg.reshape(lg.shape[0], -1, lg.shape[-1]).clone())
            return lg, cache
        return call

    runner.prefill, runner.step = keep(prefill), keep(step)
    try:
        yield seen
    finally:
        runner.prefill, runner.step = prefill, step


def decode_loop(cfg, params, batch, max_new):
    """``prefill`` then ``max_new - 1`` greedy contiguous ``decode_step``s:
    (new tokens (B, max_new), the logits each token was picked from, the
    step state for a profile)."""
    head = LM.head_f32(params, cfg)
    s = batch["tokens"].shape[1] + cfg.n_img_tokens
    with torch.no_grad():
        lg, cache = LM.prefill(params, batch, cfg, head=head)
        cache = grow_cache(cache, max_new)
        cur = torch.argmax(lg, -1)[:, None]
        state = (_tree(cache, torch.clone), cur, s, head)
        toks, logits = [cur], [lg]
        for i in range(max_new - 1):
            lg, cache = LM.decode_step(params, cache, cur, s + i, cfg,
                                       head=head)
            cur = torch.argmax(lg[:, -1], -1)[:, None]
            toks.append(cur)
            logits.append(lg[:, -1])
    return torch.cat(toks, 1), logits, state


def prefill_check(what, cfg, params, batch, new, logits) -> float:
    """At each new token j of CHECK_AT: a prefill of the prompt and the
    j tokens before it picks, greedy, the token the decode loop emitted,
    from logits within 1e-4 of the decode step's."""
    worst = 0.0
    with torch.no_grad():
        for j in CHECK_AT:
            toks = torch.cat([batch["tokens"], new[:, :j]], 1)
            lg, _ = LM.prefill(params, {**batch, "tokens": toks}, cfg)
            if not torch.equal(torch.argmax(lg, -1), new[:, j]):
                raise AssertionError(f"{what}: a prefill through new token "
                                     f"{j} picks another token")
            err = float((lg - logits[j]).abs().max())
            worst = max(worst, err)
            if not torch.isfinite(lg).all() or err > LOGIT_TOL[torch.float32]:
                raise AssertionError(f"{what}: new token {j}: prefill and "
                                     f"decode logits differ by {err:.3e}")
    print(f"  {what}: at new tokens {CHECK_AT} a prefill of the prompt and "
          f"the tokens before picks the emitted token, logits within "
          f"{worst:.3e} of the decode step's (tol "
          f"{LOGIT_TOL[torch.float32]})")
    return worst


def frontend_run(arch, cfg, params, batch) -> tuple:
    """musicgen through ``generate`` (its logits read off the runner),
    internvl2 through ``prefill`` and ``decode_step``; returns (new
    tokens, their logits, a step state, wall ms per token)."""
    b = batch["tokens"].shape[0]
    torch.cuda.synchronize()
    paged_attn.LAUNCHES = 0
    t0 = time.perf_counter()
    if cfg.n_codebooks:
        with runner_logits() as logits:
            out = generate(params, cfg, batch["tokens"],
                           EngineConfig(max_new_tokens=MAX_NEW))
        s = batch["tokens"].shape[1]
        new = out[:, s:]
        if tuple(out.shape) != (b, s + MAX_NEW, cfg.n_codebooks) \
                or not torch.equal(out[:, :s], batch["tokens"]):
            raise AssertionError(f"{arch} generate: output "
                                 f"{tuple(out.shape)}")
        state = None
    else:
        new, logits, state = decode_loop(cfg, params, batch, MAX_NEW)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (b * MAX_NEW)
    if paged_attn.LAUNCHES:
        raise AssertionError(f"{arch}: the contiguous path launched B2")
    if new.shape[1] != MAX_NEW or int(new.min()) < 0 \
            or int(new.max()) >= cfg.vocab or len(logits) < MAX_NEW:
        raise AssertionError(f"{arch}: bad tokens {tuple(new.shape)}")
    return new, logits, state, ms


def contiguous_profile(arch, cfg, params, state) -> dict:
    cache, cur, pos, head = state
    return step_profile(
        f"{arch} {cfg.dtype}, contiguous", lambda: LM.decode_step(
            params, cache, cur, pos, cfg, head=head))


def frontends_phase(dev) -> dict:
    """musicgen-medium (4 codebooks, through ``generate``) and
    internvl2-2b (256 stub image tokens, through ``prefill`` and
    ``decode_step``) at full width and depth, fp32 then bf16."""
    out = {}
    for arch in FRONTEND_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        met = {}
        for dtype in ("float32", "bfloat16"):
            cfg, params = build_frontend(arch, dtype, dev)
            batch = frontend_batch(cfg, dev)
            new, logits, state, ms = frontend_run(arch, cfg, params, batch)
            met[f"ms_per_token_{dtype}"] = ms
            b, s = GEN_SHAPE
            how = (f"generate, {b} x {s} tokens x {cfg.n_codebooks} "
                   f"codebooks" if cfg.n_codebooks else
                   f"prefill of {b} x ({cfg.n_img_tokens} image + {s} text)"
                   f" tokens and {MAX_NEW - 1} decode steps")
            print(f"  {arch} {dtype}: {how}, {MAX_NEW} new tokens: "
                  f"{ms:.2f} ms per token (wall, prefill included)")
            if dtype == "float32":
                met["max_logit_err"] = prefill_check(
                    f"{arch} fp32", cfg, params, batch, new, logits)
            else:
                if state is None:
                    _, _, state = decode_loop(cfg, params, batch, 2)
                met.update(contiguous_profile(arch, cfg, params, state))
            del params, batch, new, logits, state
            gc.collect()
            torch.cuda.empty_cache()
        met["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"  {arch}: peak memory {met['peak_gb']:.2f} GB")
        out[arch] = met
    return out


def decode_profile(label, cfg, params, state, n=5,
                   first_design=None) -> dict:
    """Where one paged decode step's time goes (kernel path), at a first
    decode step's state: see :func:`step_profile`."""
    cache, cur, pos, table, head = state
    return step_profile(
        f"{label}, kernel path", lambda: LM.decode_step_paged(
            params, cache, cur, pos, table, cfg, use_kernel=True,
            head=head), n, first_design)


def step_profile(label, step, n=5, first_design=None) -> dict:
    """torch.profiler over ``n`` calls of ``step`` (one decode step at
    the first step's positions): device time by kernel and the device's
    busy share of the wall time. The profiler can miss launches at the
    edges of its window, so each profiled call is synchronised, one call
    before the window is traced and dropped (the schedule's warm-up),
    and the profile counts only when every kernel was recorded a whole
    number of times per call (each call launches the same kernels);
    else it is taken again, three times at most, and then it raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def run(k):
        for _ in range(k):
            step()
        torch.cuda.synchronize()

    with torch.no_grad():
        run(n)
        t0 = time.perf_counter()
        run(n)
        plain_us = (time.perf_counter() - t0) * 1e6 / n
        for attempt in range(1, 4):
            got = []
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=n,
                                           repeat=1),
                         on_trace_ready=lambda p: got.append(
                             p.key_averages())) as prof:
                for i in range(n + 1):
                    if i == 1:
                        t0 = time.perf_counter()
                    run(1)
                    if i == n:
                        # the last step() below closes the window and
                        # processes the trace: not part of the wall
                        wall_us = (time.perf_counter() - t0) * 1e6 / n
                    prof.step()
            # the schedule marks each step with a ProfilerStep range on
            # the device: an annotation, not a kernel
            kernels = [ev for ev in got[0]
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and not ev.key.startswith("ProfilerStep")]
            if kernels and all(ev.count % n == 0 for ev in kernels):
                break
            print(f"  profile {attempt} of {label}: kernel counts "
                  f"{sum(ev.count for ev in kernels)} over {n} steps, some "
                  f"not a multiple of {n}: the profiler missed launches")
        else:
            raise AssertionError(f"{label}: no profile of three recorded "
                                 f"every launch of {n} whole steps")
    busy_us = sum(ev.self_device_time_total for ev in kernels) / n
    per_step = sum(ev.count for ev in kernels) // n
    b2 = sum(ev.count for ev in kernels
             if any(nm in ev.key for nm in B2_NAMES)) // n
    first = ("" if first_design is None else
             f" ({first_design} with the one-launch paged-attention kernel "
             f"of the first design)")
    print(f"decode-step profile ({label}, {n} steps at the "
          f"first step's positions, torch.profiler): wall {wall_us:.1f} "
          f"us/step profiled, {plain_us:.1f} us/step unprofiled; device "
          f"busy {busy_us:.1f} us/step ({100 * busy_us / wall_us:.1f}% of "
          f"the profiled wall, {100 * busy_us / plain_us:.1f}% of the "
          f"unprofiled), {per_step} kernels/step{first}, {b2} of "
          f"them paged-attention kernels")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {ev.self_device_time_total / n:8.1f} us/step "
              f"{ev.count // n:4d}x  {ev.key[:90]}")
    return {"busy_us": busy_us, "wall_us": plain_us,
            "busy_share": busy_us / plain_us, "kernels_per_step": per_step}


def _sdpa_backend(fn) -> str:
    """Which SDPA backend ``fn`` ran, from the kernel names the profiler
    records."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # five calls: late in a long run the profiler may drop a call's kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    names = " ".join(ev.key.lower() for ev in prof.key_averages()
                     if ev.device_type == torch.autograd.DeviceType.CUDA)
    for key, backend in (("flash", "flash"), ("cudnn", "cudnn"),
                         ("fmha", "efficient"), ("efficient", "efficient"),
                         ("mem_eff", "efficient")):
        if key in names:
            return backend
    return "math (no fused attention kernel in the trace)"


def b2_timing(label, pos_h, active, dev, *, h, kv, d, psz, max_pages,
              dv=None, d2=0, scale=None, q_dtype=torch.bfloat16,
              pool_dtype=torch.bfloat16) -> dict:
    """B2 at one decode step's positions (one layer's pools): kernel,
    plain version, SDPA on the gathered K/V (the library yardstick; the
    gather timed apart) and the bound. With ``d2`` (MLA) one latent pool
    is both K and V (D = Dv) and a second pool holds the rope keys; SDPA
    then takes K = [latent | rope], V = latent."""
    rng = np.random.default_rng(SEED + 4)
    dv = dv or d
    tab, n_pages = _slot_table(rng, pos_h.tolist(), psz, max_pages)
    b = len(pos_h)
    q = _rand(rng, (b, h, d), dev).to(q_dtype)
    kp = _rand(rng, (n_pages, psz, kv, d), dev).to(pool_dtype)
    vp = kp if d2 else _rand(rng, (n_pages, psz, kv, dv), dev).to(
        pool_dtype)
    extra = {}
    if d2:
        extra = dict(q2=_rand(rng, (b, h, d2), dev).to(q_dtype),
                     k2_pool=_rand(rng, (n_pages, psz, kv, d2), dev).to(
                         pool_dtype))
    table = torch.from_numpy(tab).to(dev)
    pos = torch.from_numpy(pos_h.astype(np.int32)).to(dev)
    scale = scale or 1.0 / math.sqrt(d)
    t = max_pages * psz
    kpos = torch.arange(t, device=dev)
    mask = (kpos[None, :] <= pos[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :].to(pool_dtype)
    if d2:
        qs = torch.cat([qs, extra["q2"][:, :, None, :].to(pool_dtype)], -1)

    def gather():
        k = kp[table.long()].reshape(b, t, kv, d)
        if d2:
            k2 = extra["k2_pool"][table.long()].reshape(b, t, kv, d2)
            return torch.cat([k, k2], -1).transpose(1, 2), k.transpose(1, 2)
        return (k.transpose(1, 2),
                vp[table.long()].reshape(b, t, kv, dv).transpose(1, 2))

    kg, vg = gather()

    def library():
        return F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True)

    def kernel():
        return paged_attn.paged_attn_cuda(q, kp, vp, table, pos,
                                          scale=scale, **extra)

    def plain_version():
        return paged_attn_ref(q, kp, vp, table, pos, scale=scale, **extra)

    lib_err = float((library()[:, :, 0].float() - kernel()).abs().max())
    plain_err = float((plain_version() - kernel()).abs().max())
    backend = _sdpa_backend(library)
    ms = median_ms(kernel)
    plain_ms = median_ms(plain_version)
    library_ms = median_ms(library)
    gather_ms = median_ms(gather)
    dev_ms, each = device_kernel_ms(kernel, B2_NAMES, once_per_call=True)
    library_dev_ms, _ = device_kernel_ms(library, None)
    kernel_graph_ms, library_graph_ms = graph_ms(kernel), graph_ms(library)
    gather_sdpa_graph_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, *gather(), attn_mask=mask, scale=scale, enable_gqa=True))
    hpc, ps, splits = paged_attn.plan(b, h // kv, kv, d, d2, psz, max_pages,
                                      paged_attn.sm_count(dev.index))
    planned = (splits, kv * (h // kv // hpc), b)
    # the profiler can miss kernels at the edges of its window (at MLA's
    # shape it missed a whole call once and a call's scores kernel once;
    # at hymba's, after the phases before it, a whole trace once), so
    # drop what precedes the first scores kernel and a partial call at
    # the end: the rest must be whole calls, each the scores kernel then
    # the PV kernel and nothing else. A trace with no whole call is
    # taken again, three times at most.
    for attempt in range(1, 4):
        traced = traced_kernels(kernel, B2_NAMES, calls=5)
        first = next((i for i, (name, _) in enumerate(traced)
                      if B2_NAMES[0] in name), len(traced))
        calls = (len(traced) - first) // len(B2_NAMES)
        if calls:
            break
        print(f"  trace {attempt} of B2 at {label} holds no whole call")
    seq = traced[first:first + calls * len(B2_NAMES)]
    per_call = len(seq) / calls if calls else 0
    if not calls or any(B2_NAMES[i % len(B2_NAMES)] not in name
                        for i, (name, _) in enumerate(seq)) \
            or per_call != paged_attn.KERNELS_PER_CALL:
        raise AssertionError(f"a call launched {per_call} kernels, the "
                             f"launch count adds "
                             f"{paged_attn.KERNELS_PER_CALL}: {traced}")
    traced = seq
    grids = sorted({g for _, g in traced}, key=str)
    ctas = None
    if None not in grids:
        if grids != [planned]:
            raise AssertionError(f"traced grids {grids}, planned {planned}")
        ctas = math.prod(planned)
    live = int((pos_h + 1).sum())
    pool_bytes = kp.element_size()
    # the live rows of each pool, read once (MLA's latent is K and V)
    kv_bytes = live * kv * (d + d2 + (0 if d2 else dv)) * pool_bytes
    io_bytes = (q.numel() * q.element_size() + b * h * dv * 4
                + table.numel() * 4 + pos.numel() * 4
                + (extra["q2"].numel() * q.element_size() if d2 else 0))
    flops = 2 * live * h * (d + d2 + dv)
    bytes_s = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    # the products' operands are the pool's type (q is rounded to it)
    ops_s = flops / (FP32_FLOPS if pool_dtype == torch.float32
                     else BF16_FLOPS)
    bound_ms = max(bytes_s, ops_s) * 1e3
    print(f"paged timing, {label}, one layer at the busiest decode step "
          f"(pools {pool_dtype}, q {q_dtype}, H {h}, KV {kv}, D {d}, Dv {dv}"
          f", D2 {d2}; pos {pos_h.tolist()}, active {active.tolist()}, "
          f"{live} live keys; median of 50, CUDA events): kernel {ms:.4f} "
          f"ms (device time "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}"
          f" from torch.profiler), plain {plain_ms:.4f} ms (kernel vs "
          f"plain max abs err {plain_err:.3e}), library SDPA "
          f"{library_ms:.4f} ms ({backend} backend; device time "
          f"{_ms(library_dev_ms)}) on pre-gathered K/V (the gather alone "
          f"{gather_ms:.4f} ms; SDPA vs kernel max abs diff "
          f"{lib_err:.3e}); replayed from a CUDA graph (no host): kernel "
          f"{kernel_graph_ms:.4f} ms, SDPA {library_graph_ms:.4f} ms, gather "
          f"+ SDPA {gather_sdpa_graph_ms:.4f} ms; bound {bound_ms:.5f} ms "
          f"({kv_bytes} live pool "
          f"bytes + {io_bytes} q/out/table/pos bytes; {flops} flops; bound "
          f"by {'bytes' if bytes_s >= ops_s else 'operations'}); "
          f"planned grid {splits} splits of {ps} pages x {planned[1]} "
          f"(group, head chunk) x {b} slots; traced ({calls} whole calls "
          f"of 5 in the trace): {per_call:g} kernels per call, grids "
          f"{grids} = "
          f"{'not in the trace' if ctas is None else f'{ctas} CTAs'}")
    for key, t_ms in each.items():
        print(f"  device time {t_ms:.4f} ms  {key[:90]}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "device_ms": dev_ms, "library_device_ms": library_dev_ms,
            "graph_ms": kernel_graph_ms, "library_graph_ms": library_graph_ms,
            "gather_sdpa_graph_ms": gather_sdpa_graph_ms,
            "gather_ms": gather_ms, "live_kv_bytes": kv_bytes, "ctas": ctas,
            "kernels_per_call": per_call, "plain_err": plain_err,
            "sdpa_backend": backend}


def busiest_step(vocab: int, reqs) -> tuple:
    """(pos, active, max_pages) of the decode step of ``reqs`` with the
    most live keys, the engine's protocol replayed on the host."""
    pos_h, active = max(replay_positions(vocab, reqs),
                        key=lambda s: int((s[0] + 1)[s[1]].sum()))
    max_pages = -(-max(r.prompt_len + r.max_new_tokens for r in reqs)
                  // LM_ENGINE.page_size)
    return pos_h, active, max_pages


def replay_matches(vocab: int, reqs, res) -> None:
    """The host replay of ``reqs`` (whose busiest step B2 is timed at)
    takes the decode steps the run took."""
    n = len(replay_positions(vocab, reqs))
    if n != res.stats["decode_steps"]:
        raise AssertionError(f"replayed {n} decode steps, the run took "
                             f"{res.stats['decode_steps']}")


def paged_timing_phase(lm, dev) -> dict:
    """B2, bf16 pools, at the busiest decode step of three models'
    traces: gemma-2b's LM trace (H 8, KV 1, D 256), deepseek-v2-236b's
    (MLA: H 128, D 512 + 64, fp32 q) and hymba-1.5b's (H 25, KV 5, D 64).
    All three early in the run: late in a long run the profiler drops
    kernels from its traces. The deepseek and SSD phases check that the
    host replay takes their runs' steps."""
    cfg = lm["cfg"]
    pos_h, active = max(lm["steps"],
                        key=lambda s: int((s[0] + 1)[s[1]].sum()))
    max_pages = -(-max(n + MAX_NEW for n in PROMPT_LENS)
                  // LM_ENGINE.page_size)
    out = b2_timing("gemma-2b", pos_h, active, dev, h=cfg.n_heads,
                    kv=cfg.n_kv, d=cfg.hd, psz=LM_ENGINE.page_size,
                    max_pages=max_pages)
    print(f"  {cfg.n_layers} calls = "
          f"{out['kernels_per_call'] * cfg.n_layers:g} kernels per decode "
          f"step")
    ds = get_config(DS_ARCH)
    pos_h, active, max_pages = busiest_step(
        ds.vocab, lm_requests(ds.vocab, DS_PROMPT_LENS, DS_MAX_NEW))
    out["mla"] = b2_timing(
        f"{DS_ARCH} MLA", pos_h, active, dev, h=ds.n_heads, kv=1,
        d=ds.kv_lora, d2=ds.rope_head_dim,
        scale=1.0 / math.sqrt(ds.hd + ds.rope_head_dim),
        psz=LM_ENGINE.page_size, max_pages=max_pages, q_dtype=torch.float32)
    hy = get_config(SSD_ARCHS[0])
    pos_h, active, max_pages = busiest_step(hy.vocab, lm_requests(hy.vocab))
    out["hymba"] = b2_timing(
        f"{hy.name} attention", pos_h, active, dev, h=hy.n_heads, kv=hy.n_kv,
        d=hy.hd, psz=LM_ENGINE.page_size, max_pages=max_pages)
    return out


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
    phase("LM decode profile", decode_profile, "gemma-2b bf16", lm["cfg"],
          lm["params"], lm["step_state"], 5, FIRST_DESIGN_KERNELS_PER_STEP)
    pt = phase("B2 timing", paged_timing_phase, lm, dev)
    lm_launches, lm_steady, lm_p99 = (lm["launches"],
                                      lm["steady_tokens_per_sec"],
                                      lm["step_p99_us"])
    gen_launches = phase("generate", generate_phase, lm, dev)
    phase("contiguous serving", contiguous_phase, lm)
    px = phase("prefix cache", prefix_phase, lm)
    px_launches = px["launches"]
    phase("speculative serving", speculative_phase, lm)
    dg = phase("disagg", disagg_phase, lm, px)
    rt = phase("router", router_phase, lm,
               dg["paged_bfloat16"]["step_p50_us"])
    del lm, px
    gc.collect()
    torch.cuda.empty_cache()
    print(f"gemma-2b phases freed: peak memory so far "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, now allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ds = phase("deepseek", deepseek_phase, dev)
    ssd = phase("ssd", ssd_phase, dev)
    fe = phase("frontends", frontends_phase, dev)
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
        **PAGED_KERNEL,
        "launches": (lm_launches + gen_launches + px_launches
                     + dg["launches"] + rt["launches"] + ds["launches"]
                     + ssd["launches"]),
        "max_abs_err": paged_err["gemma"], "ms": pt["ms"],
        "plain_ms": pt["plain_ms"], "bound_ms": pt["bound_ms"],
        "bound_by": pt["bound_by"], "library_ms": pt["library_ms"],
        "device_ms": pt["device_ms"], "gather_ms": pt["gather_ms"],
        "library_device_ms": pt["library_device_ms"],
        "graph_ms": pt["graph_ms"], "library_graph_ms": pt["library_graph_ms"],
        "gather_sdpa_graph_ms": pt["gather_sdpa_graph_ms"],
        "kernels_per_call": pt["kernels_per_call"], "ctas": pt["ctas"],
        "steady_tokens_per_sec": lm_steady,
        "step_p99_us": lm_p99,
        "mla_max_abs_err": max(ds["b2_err_float32"],
                               ds["b2_err_bfloat16"]),
        **{f"mla_{k}": pt["mla"][k] for k in (
            "ms", "device_ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms",
            "library_graph_ms", "gather_sdpa_graph_ms", "sdpa_backend",
            "ctas")},
        "deepseek": {d: ds[d] for d in ("float32", "bfloat16")},
        "hymba_launches": ssd["launches"],
        "hymba_max_abs_err": max(paged_err["hymba"], ssd["b2_err_float32"],
                                 ssd["b2_err_bfloat16"]),
        **{f"hymba_{k}": pt["hymba"][k] for k in (
            "ms", "device_ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms",
            "library_graph_ms", "gather_sdpa_graph_ms", "sdpa_backend",
            "ctas")},
        **{a: ssd[a] for a in SSD_ARCHS},
        "internvl2_max_abs_err": paged_err["internvl2"],
        "disagg": {**{k: dg[k] for k in (
            "launches", "decode_steps", "handoffs", "handoff_pages",
            "prefix_hits", "prefill_tokens_on", "prefill_tokens_off",
            "paged_bfloat16", "disagg_bfloat16")}, "router": rt},
        "frontends": fe,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

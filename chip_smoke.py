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
   Then B1 at the serving batch (``[phase B1 at the serving batch]``),
   where ``csb_matvec`` takes the batch-tiled body (1,024 true rows, at
   or above ``csb_mvm.TILED_MIN_ROWS``): SR1's 18 and SR2's 12 matrices
   as the benchmark serves them (``portbench``'s weights, seed 0, encoded
   by its ``Program``) and gemma-2b's FFN projections (in 2048, out
   16384 and back) at ``CSBSpec(32, 32, 0.75)``, x fp32 (and bf16 at the
   FFN). Each output is held to the plain version at the kernel phase's
   tolerances and must equal, as numbers, the row body's on the same
   rows (run in slices of ``TILED_MIN_ROWS - 1`` rows, which take it);
   ``csb_mvm.TILED_LAUNCHES``, set to 0 first, must count every call at
   1,024 rows and none of the slices. Each set is then timed as phase
   4's MVMs are, its device time printed beside its bound.
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
   hymba-1.5b (d_model 1600, attention of 25 heads over 5 KV heads of 64
   beside 25 SSD heads, SwiGLU) and mamba2-370m (d_model 1024, SSD
   alone, no FFN) at full width, a quarter of their depth (SSD_LAYERS: 8
   of 32 and 12 of 48 layers, the script's time limit), random
   weights from a seeded generator, fp32 and a bf16 copy, each serving
   the LM trace with bucketing off (the engine turns it off for these
   mixers). hymba in fp32: paged through B2 and through the gather
   path, and contiguous, with equal tokens, B2's launches 2 x layers x
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
   musicgen-medium (d_model 1536, 4 codebooks of 2048) and internvl2-2b
   (d_model 2048, 16 heads over 8 KV heads of 128, 256 image tokens
   from stub embeddings drawn from a seeded generator) at full width, a
   quarter of their depth (FRONTEND_LAYERS: 12 of 48 and 6 of 24
   layers, the script's time limit), random weights from a seeded
   generator, fp32 then bf16. musicgen through ``generate`` (4 x 256
   prompt tokens x 4 codebooks, 32 new tokens, output (4, 288, 4));
   internvl2 through ``prefill`` and 31 greedy contiguous
   ``decode_step`` calls. In fp32, at new tokens 0, 8 and 31, a prefill
   of the prompt and the tokens before picks, greedy, the token emitted,
   from logits within 1e-4 of the decode step's. In bf16: ms per token,
   a decode-step profile (kernels, the device's busy share; every
   decode-step profile of the script must record each kernel a whole
   number of times per step) and peak memory. No kernel runs on these
   contiguous paths (B2's launches 0). B2 is timed at internvl2-2b's
   shape in phase 6, at the busiest step of its trace replayed on the
   host.
13. The paper pipeline (``[phase paper]``), last. (a) tests/test_system.py
   on the card: a GRU (16 -> 32) classifier on ``SeqClassifyTask(16, 4,
   12)`` trained 150 dense steps (SGD, lr 0.05, batch 32), then from the
   same start 100 steps with the ADMM penalty on U_z, U_r, U_n at
   ``CSBSpec(8, 8, 0.5)`` (rho 0.02, ``admm_update`` every 10 steps,
   ``admm_finalize``); dense accuracy > 0.5, pruned > max(dense - 0.2,
   0.4), density(U_z) <= 0.56, one step through ``cell_apply`` with the
   three matrices packed (B1) within 3e-5 of the masked-dense cell, and
   the engine's 2-D sharing no worse than none on U_n. (b) SR1 at full
   width between a 153 x 153 embedding and a 512 x 4 readout on
   ``SeqClassifyTask(153, 4, 12)``: 100 dense steps,
   ``csb_specs_for_params(..., CSBSpec(32, 32, 1 - 1/13), exclude=("emb",
   "out"))`` (18 matrices), 100 ADMM steps at rho 2.0 (its residual
   must fall; at test_system.py's 0.02 it grows, in the JAX package as in
   the port: tests/test_torch_admm_sr1.py), finalized, each matrix frozen
   through ``CSBLinear.freeze`` (the finalized weight and its packing
   keep at most Algorithm 1's rows per block-column and columns per
   block-row, every nonzero is stored, and as many entries as the CPU's
   packing of the same weight stores), and the 200 frames of phase 4 served
   through ``rnn_serve_frames`` (B1: 18 x 402 launches) within 1e-4 of
   the finalized masked-dense model; printed: accuracies, ms per training
   step, how many mask entries the card's projection of the trained
   weights differs in from the CPU's, ``compression()``, us_per_frame and
   p99, and per matrix the paper engine's cycle model
   (``EngineConfig(4, 4, 4, 4)``, modelled at 200 MHz: efficiency and
   latency without and with sharing). (c) B1 at gemma-2b's FFN shape (in
   2048, out 16384) through ``csb_dense``: a ``CSBLinear(transposed=True)``
   at ``CSBSpec(32, 32, 0.75)`` frozen, x (4, 2048) in fp32 and bf16, held
   to the plain version and the masked mode at phase 3's tolerances. It
   is built and timed early, right after phase 4's timing, as phase 4
   times SR1's MVMs (events, device, graph, the library matmul on the
   masked-dense weight in x's dtype, live and padded bounds): late in a
   long run the profiler drops kernels. B1's launch count is set to 0
   before (a) and read after (c).
14. Kernel B3 (``[phase sharded]``), after the paper phase: the CSB
   matvec with W's block-rows split over a mesh's "model" axis
   (``kernels/csrc/csb_sharded.cu``: one launch a call on each rank, B1's
   block-row body over the rank's live block-rows, each output stored at
   its global column into every rank's output: through CUDA IPC and
   stream memory operations where there are peers). Ranks are processes
   of their own (``dist.launch.spawn_ranks``, spawn start method, the
   kernels built above and only loaded there), all on this card: one
   rank is an NCCL group; several ranks join a gloo group (NCCL refuses
   two ranks on one card), which B3 uses only to swap IPC handles once.
   (a) On SR1's 18 matrices (batch 1) and gemma-2b's FFN projection
   (batch 4, x fp32 and bf16) at R = 1, 2 and 4 ranks and overlap 1, 2,
   3: every rank's y bit-equal to B1 on the unsharded matrix and within
   ``TOL`` of B3's plain version (B1's plain version on the shard, the
   chunked gathers), one B3 launch a call and no B1 launch; each rank's
   rows from the kernel alone (``csb_sharded_rows``) within ``TOL`` of
   their plain version; at R = 2 and 4, 200 calls back to back with a new
   x each, every output bit-equal to B1's (a slot overwritten before a
   peer copied it out would show); the plans' imbalance and block-rows
   per rank and the exchange route printed. (b) On two ranks of a (1, 2)
   ("data", "model") mesh, SR1 at full width through
   ``rnn_serve_frames(mesh=...)`` for 200 frames at batch 1: outputs and
   final states bit-equal to the unsharded run through B1 and within
   1e-4 of the masked-dense model; us_per_frame and p99 printed as two
   ranks sharing one card, not a multi-GPU number. (c) On the same ranks
   ``csb_dense`` at gemma-2b's FFN under ``use_rules``, equal to its
   unsharded run. B3's and B1's launch counts are set to 0 on each rank
   before (b) and read after (c): B3 once a call, B1 never. Then B3's
   CUDA events per call at R = 2 on SR1's 18 MVMs. (d) On the NCCL rank,
   B3 timed on SR1's 18 MVMs and on the FFN: events (median of 50)
   beside B1 on the whole matrix and B3's plain version, the profiler's
   device time (one device kernel a call, or it raises) beside B1's,
   CUDA-graph replay, and the bound (the live bytes). A rank that fails
   or outlives its deadline fails the phase.

15. Training (``[phase train]``). TF32 is off (printed). (a)
   gemma-2b at full width and depth (18 layers, d_model 2048, 8 heads
   over 1 KV head of 256, GeGLU d_ff 16384, vocab 256000, untied head:
   3.03 B parameters, bf16) through ``repro_torch.launch.train.main``, the
   JAX launcher's defaults (batch 8, seq 128, AdamW with fp32 moments,
   lr 1e-3 warmed up over 10 steps, clip 1.0, remat on), 8 steps: every
   loss finite; peak memory, step wall p50/p99 over steps 1-7, tokens/s,
   each step's loss; at the trained weights every gradient leaf finite
   and the global norm above 0; a profile of three steps through
   ``make_train_step`` (kernels a step, the device's busy share, the top
   device ops); AdamW's update timed alone against its bytes bound. (b)
   ADMM-CSB on the FFN (w_gate, w_up, w_down at ``CSBSpec(32, 32,
   0.75)``, examples/train_lm_e2e.py's) at full width, depth cut to 2
   layers: 6 steps of ``train`` with the penalty, ``admm_update`` every 3,
   ``admm_finalize``; every matrix's density <= 0.31 (0.25 + the 0.06
   cross-point allowance of tests/test_train.py:76); each frozen through
   ``CSBLinear(transposed=True)`` (its packing holds the finalized weight
   exactly) and one batch's FFN inputs through ``csb_dense`` into B1
   (6 launches), within phase 3's bf16 bound of the masked-dense product.
   (c) reduced gemma-2b (fp32) trained 5 steps on the card and on the
   CPU from the same weights and numpy batches, losses within 1e-4; then
   on the card 4 steps with checkpoints every 2 and a fresh ``train`` on
   that directory to step 6, its params bit-equal to 6 uninterrupted
   steps under ``torch.use_deterministic_algorithms(True)``
   (``CUBLAS_WORKSPACE_CONFIG`` is set before cuBLAS starts). A JSON line
   ``{"train": ...}`` holds the phase's numbers.

16. Training on a mesh (``[phase mesh-train]``), after ``[phase train]``
   has freed its model. No kernel of the port runs (the launch counts
   must not move). (a) gemma-2b at full width and depth, bf16, through
   ``launch.train.main(["--arch", "gemma-2b", "--mesh", "1x2", "--steps",
   "4"])``: two ranks sharing this card over gloo (DTensor's collectives
   as c10d's synchronous ones, ``dist.gloo_cuda``), tensor-parallel over
   "model"; every loss finite and alike on both ranks, and each within
   MESH_LOSS_RTOL relative of ``[phase train]`` (a)'s at the same step
   (the same seed, batches and learning rates: warm-up 10 exceeds both
   runs' steps); per-rank peak memory, step wall p50 and the collectives of
   step 0 by op, printed as two ranks sharing one card, not a multi-GPU
   number. Then the state check, which bf16's losses cannot make: at full
   width and 4 layers, two steps on one card and on 1x2, the norms of
   AdamW's m and v and of the params' change per tensor within
   MESH_STATE_RTOL, alike on both ranks. (b) reduced gemma-2b (fp32) on 2x1 (also with int8
   compression), 1x2 and 2x1x2 meshes, reduced deepseek-v2-236b and
   mamba2-370m on 1x2: each rank's losses alike and within (c)'s 1e-4 of
   the unsharded run on the CPU from the same weights and batches. (c)
   Adafactor, int8 compression and two microbatches, each 4 steps at
   gemma-2b's full width on one card (compression at 12 layers): losses
   finite, peak memory, step wall, Adafactor's update and the wire
   stage (compress + decompress) timed alone; and each at the reduced
   width, card against CPU within 1e-4. A JSON line ``{"mesh_train":
   ...}`` holds the phase's numbers.

17. LM serving on a mesh (``[phase mesh-serve]``): the engines'
   ``mesh=`` over the dense placements, ranks sharing this card over
   gloo (``spawn_ranks``; every number of theirs is two ranks
   time-slicing one card, not a multi-GPU number). Each rank draws the
   weights from the same seeded generator and places them once
   (``csb_shard_specs``), caches and pools on ``cache_specs``. (a)
   gemma-2b at full width, MS_LAYERS layers (4 of 18), fp32, on
   one card and then over a 1x2 ("data", "model") mesh: six requests
   (prompts 40..300, arrivals 0..4, 8 new tokens) through
   ``serve_continuous`` paged with B2 and with the gather path,
   contiguous, the prefix cache (six requests sharing 64 tokens, through
   B2), speculative (``spec_k`` 4, draft rate 0), ``serve_disaggregated``
   and ``Router(2)`` through B2, and ``generate`` (4 x 64): every path's
   tokens on every rank equal to one card's, B2's launches a rank equal
   to one card's (each held to 2 x layers x single-query paged decode
   steps, 0 off the kernel), the first decode step's logits within
   MS_LOGIT_RTOL; per-rank peak memory, paged step wall p50/p99 and one
   decode step's collectives by op printed. (b) gemma-2b over 2x1 with
   the pool's pages split over "data" (MS_SPLIT_POOL + 1 pages; its
   placement asserted) through B2, which runs on the pools made whole
   on every layer and step as in JAX (the bytes printed): tokens,
   launches and logits as (a). (c) reduced deepseek-v2-236b (MLA, B2's
   rope term) and reduced hymba-1.5b (B2 beside SSD's state) on 1x2
   through B2, as (a). A JSON line ``{"mesh_serve": ...}`` holds the
   phase's numbers; B2's entry in the kernels line adds the launches of
   one rank of each mesh.

18. The dry run held to the card (``[phase dryrun]``,
   ``repro_torch.launch.dryrun``): (a) DRY_CELLS traced on the fake 16x16
   mesh (a fake process group of 256 ranks, ``FakeTensorMode``) under
   this card's torch, each ``status: ok``, with its peak bytes a device,
   FLOPs, bytes, collectives by op and roofline terms printed; (b)
   gemma-2b decode_32k at full width and DRY_REAL_LAYERS layers over a
   one-rank (1, 1) mesh: the dry run's estimate, then one real step of
   the same ``build_cell`` on the card under ``op_cost.OpCounter``: its
   peak memory (reset after placement) within DRY_MEM_RTOL of the
   estimate, its FLOPs equal to the trace's, its wall (CUDA events,
   median of 5) at or above the roofline's largest term; (c) the same at
   DRY_MESH_LAYERS layers over 1x2, two ranks sharing the card over
   gloo: each rank's peak within DRY_MEM_RTOL of the 1x2 estimate, its
   collectives by op equal to the trace's; (d) a bf16 matmul's TFLOP/s
   and a device copy's GB/s beside the roofline's constants. A JSON line
   ``{"dryrun": ...}`` holds the phase's numbers.

19. Paper Algorithm 1 (``[phase progressive]``):
   ``examples/prune_progressive_torch.py --fast`` on the card (a GRU of
   hidden 32 over vocab 16, 8x8 blocks), each round's rate, accuracy and
   lossless flag and the best lossless rate printed; the best lossless
   round's model (the last round's where none was lossless) frozen to
   ``PaddedCSB`` and evaluated on the same batches through B1, its
   accuracy equal to the masked-dense one. B1's launches there join the
   kernels line's.

20. The serve examples (``[phase serve-examples]``), last:
   ``examples/serve_batched_torch.py`` and ``serve_router_torch.py``
   through their ``main([])``, each a (2, 4) ("data", "model") mesh of
   eight ranks sharing this card over gloo (``spawn_ranks``; every number
   of theirs is eight ranks time-slicing one card, not a multi-GPU
   number), every part of the JAX examples on every rank with their
   assertions (paged = contiguous tokens, the paging win under a
   96-token budget, prefix hits, speculative, ``generate``, CSB-RNN
   frames, the traced re-run; disagg and the prefix cache through the
   tiers, ``Router(2)``, ``simulate_replicas`` on the host), the ranks
   held to one another. serve_batched's part 5 (an LSTM 64 -> 128, 16x16
   blocks at rate 0.9, 32 frames x batch 4 through
   ``rnn_serve_frames(mesh=)``) runs B3 at R = 4 with the batch over
   "data": each rank's B3 launches, counted by the rank around the part,
   equal (frames + warm-up) x the matrices it holds rows of, B1's 0; the
   outputs and final state bit-equal to the same call through B1 on this
   card with no mesh. A JSON line
   ``{"serve_examples": ...}`` holds the phase's numbers; B3's entry in
   the kernels line adds one rank's launches.

The line before the last is a JSON object with one entry per kernel (B1,
B2, B3); the last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
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

from repro_torch.cells import (  # noqa: E402
    cell_apply, init_params, init_state, make_cell, rnn_scan,
)
from repro_torch.configs import (  # noqa: E402
    PAPER_MODELS, get_config, get_reduced,
)
from repro_torch.core import (  # noqa: E402
    CSBLinear, CSBMatrix, CSBSpec, admm_finalize, admm_init, admm_penalty,
    admm_update, csb_masks, csb_project, csb_specs_for_params, density,
    padded_csb_from_dense, residual_norm,
)
from repro_torch.data import (  # noqa: E402
    CharLMTask, SeqClassifyTask, lm_batch_iterator, sharded_batches,
)
from repro_torch.dist import Rules, partition_padded, use_rules  # noqa: E402
from repro_torch.dist.launch import spawn_ranks  # noqa: E402
from repro_torch.dist.symm import exchange_route  # noqa: E402
from repro_torch.engine import EngineConfig as CycleConfig  # noqa: E402
from repro_torch.engine import simulate_matrix  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, csb_matvec, csb_mvm, csb_mvm_ref, csb_sharded, densify,
    pad_to_grid, paged_attn, paged_attn_decode, paged_attn_ref,
)
from repro_torch.kernels.csb_sharded import (  # noqa: E402
    csb_matvec_sharded, csb_matvec_sharded_ref, csb_sharded_rows,
)
from repro_torch.kernels.ref import csb_sharded_rows_ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.layers import csb_dense  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    get_optimizer, global_norm, linear_warmup_cosine,
)
from repro_torch.serve import (  # noqa: E402
    EngineConfig, PagePool, Request, Router, SlotScheduler, bucket_len,
    derive_draft_params, generate, rnn_serve_frames, serve_continuous,
    serve_disaggregated, simulate_replicas,
)
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serve.scheduler import (  # noqa: E402
    fit_cache_len, grow_cache, insert_paged_cache,
)
from repro_torch.train import TrainConfig, make_train_step, train  # noqa: E402
from repro_torch.train.classifier import (  # noqa: E402
    classifier_accuracy, train_classifier,
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
SHARDED_KERNEL = {
    "name": "csb_matvec_sharded",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/csb_sharded.cu",
    "replaces": "src/repro/kernels/csb_sharded.py:155",
    "library_ms": None,      # no single PyTorch call computes it
}
SHARD_OVERLAPS = (1, 2, 3)
SHARD_LOOP = 200           # B3 calls back to back at R = 2 and 4 (slot reuse)
SHARD_TIMEOUT_S = 300      # a spawned group's deadline
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
# a quarter of each model's depth (32 and 48 layers), full width: the
# depth cut that fits [phase serve-examples] in the script's time limit
SSD_LAYERS = {"hymba-1.5b": 8, "mamba2-370m": 12}
SHORT_LENS = (1, 2)        # shorter than conv_k - 1: a 1-row conv state
# the frontends, at full width and depth: GEN_SHAPE prompts (x 4 codebooks
# for musicgen, after 256 stub image tokens for internvl2), MAX_NEW tokens
FRONTEND_ARCHS = ("musicgen-medium", "internvl2-2b")
# a quarter of each model's depth (48 and 24 layers), full width: the
# same cut as SSD_LAYERS
FRONTEND_LAYERS = {"musicgen-medium": 12, "internvl2-2b": 6}
# new tokens held against a prefill of the prompt and every token before
CHECK_AT = (0, 8, 31)
# the paper pipeline: tests/test_system.py's GRU flow (SGD at lr 0.05,
# batch 32; ADMM at rho 0.02, updated every 10 steps), then SR1 at full
# width on the same recipe, then B1 at gemma-2b's FFN width
PAPER_LR = 0.05
PAPER_BATCH = 32
ADMM_RHO = 0.02
ADMM_EVERY = 10
GRU_DIMS = (16, 32)
GRU_TASK = dict(vocab=16, n_classes=4, seq_len=12, seed=0)
GRU_SPEC = CSBSpec(bm=8, bn=8, prune_rate=0.5)
GRU_PRUNED = ("U_z", "U_r", "U_n")
GRU_DENSE_STEPS = 150
GRU_ADMM_STEPS = 100
SR1_TASK = dict(vocab=153, n_classes=4, seq_len=12, seed=0)
SR1_SPEC = CSBSpec(bm=BLOCK, bn=BLOCK, prune_rate=RATE)
SR1_DENSE_STEPS = 100
SR1_ADMM_STEPS = 100
# tests/test_admm.py's rho: at test_system.py's 0.02 the residual of
# SR1's 18 matrices grows over 100 steps (tests/test_torch_admm_sr1.py),
# at 2.0 it falls
SR1_RHO = 2.0
SR1_EVAL_START = 10_000    # batches no training step draws
SR1_ENGINE = CycleConfig(K=4, L=4, P=4, Q=4)
LM_FFN = (2048, 16384)     # gemma-2b's w_gate / w_up, (in, out)
LM_FFN_SPEC = CSBSpec(bm=32, bn=32, prune_rate=0.75)  # train_lm_e2e.py:47
LM_FFN_BATCH = 4
SERVE_BATCH = 1024         # the benchmark's slots (portbench/traffic/offline.json)
# [phase train]: the JAX launcher's defaults (src/repro/launch/train.py)
TRAIN_STEPS = 8            # (a): the loop's first step sets up; 7 steady
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR, TRAIN_WARMUP = 8, 128, 1e-3, 10
ADMM_LAYERS = 2            # (b): gemma-2b's depth cut; full width
ADMM_TRAIN_STEPS, ADMM_TRAIN_EVERY = 6, 3
# tests/test_train.py:76 holds density <= 0.56 at keep 0.5: 0.06 above
# the keep fraction for the cross-point rounding of rows and columns
DENSITY_ALLOWANCE = 0.06
REDUCED_STEPS = 5          # (c): card against CPU, reduced gemma-2b
# (c)'s bound on |loss(card) - loss(CPU)|: runs that differ only in
# summation order agree to ~1e-6 over 15 steps (the port against JAX,
# tests/test_torch_train.py's trajectories); AdamW's near-sign steps at
# warm-up lrs <= 4e-4 keep a flipped element's move small: 100x that
REDUCED_LOSS_TOL = 1e-4
OPT_TIMING_REPS = 5
# [phase mesh-train]: the dense placements over ranks sharing the card
MESH_STEPS = 4             # (a) and (c): the first step sets up
MESH_FULL = "1x2"          # (a): gemma-2b tensor-parallel over "model"
# (a): each loss against [phase train] (a)'s at the same step (the same
# seed, batches and learning rates: warm-up 10 exceeds both runs' steps;
# TRAIN_STEPS >= MESH_STEPS). tools/mesh_loss_gap.py on the card read a
# sound 1x2 run 1.18e-4 from one card, and runs with one gradient's
# reduction skipped 9.06e-5 and 7.82e-5: bf16's rounding hides such a
# fault in four losses, so this bound only catches a gross one; the
# state check below catches the skipped reduction
MESH_LOSS_RTOL = 1e-3
# (a)'s state check: AdamW's moments and the params' change, per tensor,
# mesh against one card; full width, cut depth. Step 0 (lr 0) fills the
# moments with the reduced, clipped gradients; step 1 moves the params
MESH_STATE_LAYERS, MESH_STATE_STEPS = 4, 2
MESH_STATE_RTOL = 1e-2
# (b): reduced configs per mesh, each card run against the CPU's
MESH_REDUCED = {
    (2, 1): (("gemma-2b", {}), ("gemma-2b", {"compress_grads": True})),
    (1, 2): (("gemma-2b", {}), ("deepseek-v2-236b", {}),
             ("mamba2-370m", {})),
    (2, 1, 2): (("gemma-2b", {}),),
}
# (c): item 25's features, each alone on one card
FEATURES = {"adafactor": {"optimizer": "adafactor"},
            "int8": {"compress_grads": True},
            "microbatches2": {"microbatches": 2}}
# (c)'s depth per feature at full width: int8 compression keeps an fp32
# residual beside AdamW's moments, and at all 18 layers it peaked at
# 78.79 GB on the card with nothing else held (PERF.md §6), too close
# to 80 GB beside this script's own state: 12 layers
FEATURE_LAYERS = {"int8": 12}
# [phase mesh-serve]: LM serving on the dense placements, ranks sharing
# the card. (a) gemma-2b at full width, fp32, one card then 1x2 over
# "model", on a short trace through every engine; (b) the pool's pages
# split over "data" on 2x1 (MS_SPLIT_POOL pages + the scratch page
# divide by 2: the divisibility guard would replicate an odd count); (c)
# reduced deepseek-v2-236b (MLA: B2's rope term) and hymba-1.5b (B2 beside
# SSD's state) on 1x2, fp32
MS_MESH, MS_SPLIT_MESH = (1, 2), (2, 1)
MS_LAYERS = 4              # of gemma-2b's 18: the depth cut to fit
                           # [phase serve-examples] in the time limit
MS_PROMPT_LENS = (40, 97, 150, 200, 256, 300)
MS_ARRIVALS = (0, 0, 1, 2, 3, 4)
MS_MAX_NEW = 8
MS_ENGINE = EngineConfig(paged=True, page_size=16, n_slots=4)
MS_SPLIT_POOL = 79         # < 4 slots x 20 pages, and 79 + 1 is even
MS_PREFIX_LEN = 64
MS_SUFFIX_LENS = (8, 24, 40, 56, 72, 100)
MS_GEN_SHAPE = (4, 64)
MS_SPEC_K = 4              # speculative at draft rate 0: the target's
#                            placed params are the draft's (no second copy)
MS_LOGIT_RTOL = 1e-4       # first decode step, mesh against one card
MS_REDUCED = ("deepseek-v2-236b", "hymba-1.5b")
MS_TIMEOUT_S = 600         # a spawned group's deadline
# [phase dryrun]: (a) cells traced on the fake 16x16 mesh, (arch, shape,
# layers; None: all). gemma-2b prefill_32k is left out: its blockwise
# attention is ~250,000 eager ops a layer under fake tensors (54 s for one
# layer on a CPU), past the phase's budget; mamba2-370m train_4k is cut
# to 4 of its 48 layers (~20 s traced on a CPU; all 48 would be minutes)
DRY_CELLS = (("gemma-2b", "decode_32k", None),
             ("mamba2-370m", "decode_32k", None),
             ("mamba2-370m", "train_4k", 4))
DRY_REAL = ("gemma-2b", "decode_32k")   # (b) and (c)
DRY_REAL_LAYERS = 8        # (b): one real step over a (1, 1) mesh
DRY_MESH, DRY_MESH_LAYERS = (1, 2), 4   # (c): two ranks sharing the card
DRY_MEM_RTOL = 0.10        # real peak against the dry run's estimate
DRY_MATMUL_N = 8192        # (d): a bf16 N^3 product
DRY_COPY_BYTES = 4_000_000_000          # (d): a device copy
# [phase serve-examples]: examples/serve_batched_torch.py and
# serve_router_torch.py on a (2, 4) ("data", "model") mesh of eight ranks
# sharing the card over gloo; part 5 of serve_batched runs B3 at R = 4
SE_WARMUP = EngineConfig().frame_warmup    # rnn_serve_frames' default


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def card_info() -> str:
    line = card_line()
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


def serve_sr1(cells, params, dense, frames) -> dict:
    """``frames`` through the SR1 layers in turn with ``rnn_serve_frames``
    (``params`` per layer: PaddedCSB matrices go through B1), B1's
    launches (9 per cell step) counted, and outputs and final states held
    within 1e-4 of the same cells run on ``dense`` through the dense
    branch (fp32 summation order, compounded over 200 recurrent steps)."""
    cfg = EngineConfig(frame_warmup=WARMUP, collect_frame_times=True)
    launches = csb_mvm.LAUNCHES
    x, results = frames, []
    for cell, p in zip(cells, params):
        y, st, us, frame_us = rnn_serve_frames(cell, p, x, config=cfg)
        results.append((y, st, us, frame_us))
        x = y
    launches = csb_mvm.LAUNCHES - launches
    want = len(cells) * MVMS_PER_STEP * (WARMUP + 2 * FRAMES)
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times on the main "
                             f"path, expected {want}")
    err = 0.0
    with torch.no_grad():
        x = frames
        for cell, d, (y, st, _, _) in zip(cells, dense, results):
            ry, rst = rnn_scan(cell, d, x)
            if y.shape != (FRAMES, 1, cell.op("W_proj").shape[0]) \
                    or not torch.isfinite(y).all():
                raise AssertionError(f"{cell.name}: bad outputs {y.shape}")
            for a, b, what in [(y, ry, "outputs")] + [
                    (st[k], rst[k], f"state {k}") for k in rst]:
                e = float((a - b).abs().max())
                err = max(err, e)
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                    raise AssertionError(
                        f"{what} differ from the dense run: {e:.3e}")
            x = ry
    frame_us = sum(r[3] for r in results)
    return {"launches": launches, "max_abs_err": err,
            "us_per_frame": sum(r[2] for r in results),
            "p50_us": float(np.percentile(frame_us, 50)),
            "p99_us": float(np.percentile(frame_us, 99)),
            "layers": [(r[2], float(np.percentile(r[3], 99)))
                       for r in results]}


def slice_phase(layers, frames) -> dict:
    csb_mvm.LAUNCHES = 0
    cells, csb, dense = zip(*layers)
    out = serve_sr1(cells, csb, dense, frames)
    for i, (us, p99) in enumerate(out["layers"]):
        print(f"layer {i + 1}: {us:.1f} us/frame unblocked, p99 "
              f"{p99:.1f} us blocked")
    print(f"SR1 slice: {FRAMES} frames at batch 1, {out['launches']} kernel "
          f"launches ({MVMS_PER_STEP} per cell step), outputs within 1e-4 "
          f"of the densified run; us_per_frame {out['us_per_frame']:.1f}, "
          f"frame p50 {out['p50_us']:.1f} us, p99 {out['p99_us']:.1f} us, "
          f"budget {FRAME_BUDGET_US:.0f} us: "
          f"{'met' if out['p99_us'] <= FRAME_BUDGET_US else 'NOT met'}")
    return out


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


def _annotation(ev) -> bool:
    """A range the profiler puts on the device (a collective's ``nccl:``
    range, ``ProfilerStep``): it spans kernels, it is not one."""
    return bool(getattr(ev, "is_user_annotation", False)) or \
        ev.key.startswith(("nccl:", "ProfilerStep"))


def device_kernel_ms(fn, names=("csb_mvm_kernel",), reps=20,
                     once_per_call=False, per_call=None, launch_counts=None):
    """Device time per call of fn of every kernel whose name contains one
    of ``names`` (every kernel if ``names`` is None), from torch.profiler:
    (total ms, {kernel: ms}), or (None, {}) where the profiler shows no
    device time. Device annotations are left out (``_annotation``). With
    ``once_per_call`` (each named kernel launched once a call) a kernel's
    time is its mean over the launches the profiler recorded, which late
    in a long run are not always all of them. With ``per_call`` ({name:
    launches a call}) the profile counts only when it recorded ``reps``
    times as many launches of each name and, where ``names`` is None, a
    whole number a call of every kernel; else it is taken again, three
    times at most, and then it raises. ``launch_counts``, a dict, receives
    each kernel's launches per call of fn."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not _annotation(ev)
               and (names is None or any(nm in ev.key for nm in names))]
        if per_call is None:
            break
        counts = {nm: sum(ev.count for ev in evs if nm in ev.key)
                  for nm in per_call}
        whole = names is not None or all(ev.count % reps == 0 for ev in evs)
        if whole and all(counts[nm] == reps * n
                                 for nm, n in per_call.items()):
            break
        print(f"  profile {attempt}: {counts} launches recorded over {reps} "
              f"calls of {per_call} each"
              f"{'' if whole else ', a kernel not a whole number a call'}"
              f": the profiler missed launches")
    else:
        raise AssertionError(f"no profile of three recorded every launch "
                             f"of {reps} calls ({per_call} a call)")
    if once_per_call and any(ev.count < reps for ev in evs):
        print(f"  the profiler recorded {[ev.count for ev in evs]} of "
              f"{reps} launches a kernel; times are means over those")
    each = {ev.key: ev.self_device_time_total / 1e3
            / (ev.count if once_per_call else reps) for ev in evs}
    if launch_counts is not None:
        launch_counts.update({ev.key: ev.count / reps for ev in evs})
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


def mvm_work(p, x) -> tuple[int, int, int]:
    """(live bytes, padded bytes, flops) one B1 call on (p, x) must move
    and do: each live value and index, x and y once (padded: every stored
    value and index instead); 2 x live products x rows."""
    rows = x.reshape(-1, x.shape[-1]).shape[0]
    nnz = int((p.m.long() * p.n.long()).sum())
    idx = int(p.m.sum() + p.n.sum()) + 2 * p.m.numel()
    io = x.element_size() * x.numel() + 4 * rows * p.shape[0]
    live = p.vals.element_size() * nnz + 4 * idx + io
    padded = (p.vals.element_size() * p.vals.numel() + io
              + 4 * (p.row_idx.numel() + p.col_idx.numel() + 2 * p.m.numel()))
    return live, padded, 2 * nnz * rows


def b1_timing(label, pairs) -> dict:
    """B1 on ``pairs`` of (PaddedCSB, x (rows, in)), one call each: the
    kernel on x pre-padded to its tile grid, its plain version, one
    library matmul each against the densified weight in x's dtype, and
    the bound: each matrix's live values and indices, x and y moved once
    (``padded_bound_ms``: every padded value and index instead), or its
    products at the fp32 rate (the kernel sums in fp32)."""
    items = []
    live_bytes = padded_bytes = flops = 0
    for p, x in pairs:
        xp = pad_to_grid(x, 8, p.grid[1] * p.block[1]).contiguous()
        items.append((p, x, xp, densify(p).to(x.dtype), x.shape[0]))
        live, padded, ops = mvm_work(p, x)
        live_bytes += live
        padded_bytes += padded
        flops += ops

    def kernel():
        for p, _, xp, _, rows in items:
            csb_mvm.csb_mvm_cuda(p.vals, p.row_idx, p.col_idx, p.m, p.n, xp,
                                 grid=p.grid, block=p.block, batch_tile=8,
                                 group=1, rows=rows)

    def plain_version():
        for p, _, xp, _, _ in items:
            csb_mvm_ref(p.vals, p.row_idx, p.col_idx, p.m, p.n, xp,
                        grid=p.grid, block=p.block)

    def library():
        for _, x, _, w, _ in items:
            torch.matmul(x, w.T)

    ms = median_ms(kernel)
    plain_ms = median_ms(plain_version)
    library_ms = median_ms(library)
    dev_ms, _ = device_kernel_ms(kernel, per_call={
        "csb_mvm_kernel": len(items)})
    library_dev_ms, _ = device_kernel_ms(library, None, per_call={})
    kernel_graph_ms, library_graph_ms = graph_ms(kernel), graph_ms(library)
    bytes_s = live_bytes / HBM_BYTES_PER_S
    ops_s = flops / FP32_FLOPS
    bound_ms = max(bytes_s, ops_s) * 1e3
    padded_bound_ms = max(padded_bytes / HBM_BYTES_PER_S, ops_s) * 1e3
    print(f"timing, {label} (median of 50, CUDA events): kernel {ms:.4f} ms "
          f"(device time {_ms(dev_ms)} from torch.profiler), plain "
          f"{plain_ms:.4f} ms, library matmul {library_ms:.4f} ms (device "
          f"time {_ms(library_dev_ms)}); replayed from a CUDA graph (no "
          f"host): kernel {kernel_graph_ms:.4f} ms, library "
          f"{library_graph_ms:.4f} ms; bound {bound_ms:.5f} ms "
          f"({live_bytes} live bytes; padded vals+indices+x+y "
          f"{padded_bytes} bytes = {padded_bound_ms:.5f} ms; {flops} flops)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "device_ms": dev_ms, "library_device_ms": library_dev_ms,
            "graph_ms": kernel_graph_ms, "library_graph_ms": library_graph_ms,
            "live_bytes": live_bytes, "padded_bytes": padded_bytes,
            "padded_bound_ms": padded_bound_ms}


def timing_phase(layers, dev) -> dict:
    """The 18 CSB MVMs of one SR1 frame at batch 1: kernel, plain version,
    one dense matmul each (library yardstick), and the bound."""
    rng = np.random.default_rng(SEED + 2)
    pairs = [(p, torch.from_numpy(rng.standard_normal(
        (1, p.shape[1])).astype(np.float32)).to(dev))
        for _, csb, _ in layers for p in csb.values()
        if not isinstance(p, torch.Tensor)]
    return b1_timing(f"one SR1 frame's {len(pairs)} CSB MVMs at batch 1",
                     pairs)


def served_matrices(config: str, dev) -> list:
    """The CSB matrices of the benchmark's configuration ``config``
    (``portbench/configs``) as its ``Program`` serves them: the
    benchmark's weights from seed 0, encoded by the port's loader."""
    from portbench.drivers.rnn_frames import Program, make_model
    root = Path(__file__).resolve().parent / "portbench"
    cfg = json.loads((root / "configs" / f"{config}.json").read_text())
    mix = dict(json.loads((root / "traffic" / "offline.json").read_text()),
               bank_frames=16)
    prog = Program(cfg, make_model(cfg, mix, 0, dev), dev)
    return [p for params in prog.params for p in params.values()
            if not isinstance(p, torch.Tensor)]


def ffn_matrix(shape, gen, dev):
    """gemma-2b's FFN weight of ``shape`` (in, out), random from ``gen``,
    frozen through ``CSBLinear(transposed=True)`` at LM_FFN_SPEC."""
    w = (torch.randn(shape, generator=gen) / math.sqrt(shape[0])).to(dev)
    return CSBLinear(w, LM_FFN_SPEC, mode="masked",
                     transposed=True).freeze()._packed


def serving_batch_phase(dev, ffn) -> dict:
    """B1 at the benchmark's serving batch, where ``csb_matvec`` takes the
    batch-tiled body: every matrix of SR1 and SR2 as the benchmark serves
    them, and gemma-2b's FFN projections (``ffn``'s in 2048, out 16384,
    and one of out 2048 from in 16384), on SERVE_BATCH rows of x; each
    output within TOL of the plain version and equal as numbers to the
    row body's on the same rows (slices of TILED_MIN_ROWS - 1 rows take
    it); ``TILED_LAUNCHES``, set to 0 here, counts each call at
    SERVE_BATCH rows and none of the slices, and every launch of the
    timing. Each set is timed by ``b1_timing`` (x fp32)."""
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator().manual_seed(SEED + 3)
    sets = {"sr1": served_matrices("sr1", dev),
            "sr2": served_matrices("sr2", dev),
            "lm_ffn": [ffn["frozen"]._packed,
                       ffn_matrix(LM_FFN[::-1], gen, dev)]}
    step = csb_mvm.TILED_MIN_ROWS - 1
    csb_mvm.TILED_LAUNCHES = 0
    start = csb_mvm.LAUNCHES
    calls = slices = 0
    out = {}
    for name, mats in sets.items():
        pairs, err = [], 0.0
        for p in mats:
            x32 = torch.from_numpy(rng.standard_normal(
                (SERVE_BATCH, p.shape[1])).astype(np.float32)).to(dev)
            pairs.append((p, x32))
            dtypes = ((torch.float32, torch.bfloat16) if name == "lm_ffn"
                      else (torch.float32,))
            for dtype in dtypes:
                label = (f"{name} {tuple(p.shape)} x {dtype} at "
                         f"B {SERVE_BATCH}")
                x = x32.to(dtype)
                e = compare(label, p, x)
                y = csb_matvec(p, x)
                row = torch.cat([csb_matvec(p, x[i:i + step])
                                 for i in range(0, SERVE_BATCH, step)])
                calls += 2
                slices += -(-SERVE_BATCH // step)
                if not torch.equal(y, row):
                    raise AssertionError(
                        f"{label}: the batch-tiled body and the row body "
                        f"differ, max abs "
                        f"{float((y - row).abs().max()):.3e}")
                if dtype == torch.float32:
                    err = max(err, e)
        launches = csb_mvm.LAUNCHES - start
        if csb_mvm.TILED_LAUNCHES != calls or launches != calls + slices:
            raise AssertionError(
                f"{name}: TILED_LAUNCHES {csb_mvm.TILED_LAUNCHES} of "
                f"{launches} launches; want {calls} of {calls + slices}")
        t = b1_timing(f"B1 at the serving batch, {name}'s {len(pairs)} "
                      f"matrices at {SERVE_BATCH} rows", pairs)
        launches = csb_mvm.LAUNCHES - start
        if csb_mvm.TILED_LAUNCHES != launches - slices:
            raise AssertionError(
                f"{name}: the timing took the row body "
                f"({launches - slices - csb_mvm.TILED_LAUNCHES} launches)")
        calls = csb_mvm.TILED_LAUNCHES
        out[name] = {"matrices": len(pairs), "max_abs_err": err,
                     **{k: t[k] for k in (
                         "ms", "device_ms", "graph_ms", "bound_ms",
                         "bound_by", "plain_ms", "library_device_ms",
                         "library_graph_ms")}}
        print(f"  {name}: {len(pairs)} matrices at {SERVE_BATCH} rows, "
              f"equal to the row body and within TOL of the plain version "
              f"(fp32 max abs err {err:.3e}); device {_ms(t['device_ms'])} "
              f"against a bound of {t['bound_ms']:.5f} ms")
    out["tiled_launches"] = csb_mvm.TILED_LAUNCHES
    out["launches"] = csb_mvm.LAUNCHES - start
    print(f"  TILED_LAUNCHES {out['tiled_launches']} of "
          f"{out['launches']} launches (the rest: {slices} row-body slices)")
    return out


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
    """``arch`` at full width and ``SSD_LAYERS`` layers in ``dtype``,
    random weights from a generator seeded ``SEED`` (the bf16 model is the
    fp32 one rounded: the same draws; SSD's a_log, d_skip and dt_bias stay
    fp32)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype=dtype, n_layers=SSD_LAYERS[arch])
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
    print(f"{arch} {dtype}: full width, depth cut ({cfg.n_layers} of "
          f"{full.n_layers} layers, d_model {d}, mixer {cfg.mixer}"
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
    """``arch`` at full width and ``FRONTEND_LAYERS`` layers in
    ``dtype``, random weights from a generator seeded ``SEED`` (the bf16
    model is the fp32 one rounded)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype=dtype,
                              n_layers=FRONTEND_LAYERS[arch])
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
    print(f"{arch} {dtype}: full width, depth cut ({cfg.n_layers} of "
          f"{full.n_layers} layers, d_model {d}, {cfg.n_heads} heads over {cfg.n_kv} KV heads of "
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


def step_profile(label, step, n=5, first_design=None,
                 what="decode-step") -> dict:
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
    print(f"{what} profile ({label}, {n} steps at the "
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
    """B2, bf16 pools, at the busiest decode step of four models'
    traces: gemma-2b's LM trace (H 8, KV 1, D 256), deepseek-v2-236b's
    (MLA: H 128, D 512 + 64, fp32 q), hymba-1.5b's (H 25, KV 5, D 64) and
    internvl2-2b's (H 16, KV 8, D 128; its own path is contiguous, so the
    engine's protocol is replayed on the host for its vocab). All four
    early in the run: late in a long run the profiler drops
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
    iv = get_config(FRONTEND_ARCHS[1])
    pos_h, active, max_pages = busiest_step(iv.vocab, lm_requests(iv.vocab))
    out["internvl2"] = b2_timing(
        f"{iv.name} attention", pos_h, active, dev, h=iv.n_heads, kv=iv.n_kv,
        d=iv.hd, psz=LM_ENGINE.page_size, max_pages=max_pages)
    return out


# ---------------------------------------------------------------------------
# The paper pipeline: ADMM-CSB training, CSBLinear, the engine cycle model
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def gru_params(dev, seed=SEED) -> dict:
    """tests/test_system.py's GRU classifier, from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    cell = make_cell("gru", *GRU_DIMS)
    return {"emb": (torch.randn(GRU_DIMS[0], GRU_DIMS[0], generator=gen)
                    * 0.3).to(dev),
            "rnn": [init_params(cell, gen, device=dev)],
            "out": (torch.randn(GRU_DIMS[1], GRU_TASK["n_classes"],
                                generator=gen) * 0.3).to(dev)}


def gru_specs(params) -> dict:
    specs = _tree(params, lambda _: None)
    for name in GRU_PRUNED:
        specs["rnn"][0][name] = GRU_SPEC
    return specs


def gru_flow(dev, params=None) -> dict:
    """tests/test_system.py on ``dev``: train the GRU dense, ADMM-prune
    its U matrices from the same start, pack them, serve a step through
    ``cell_apply`` (B1 on the card) against the masked-dense cell, and
    hold the engine's 2-D sharing to no worse than none on U_n; raises
    where a gate of test_system.py fails."""
    params = gru_params(dev) if params is None else params
    cells = [make_cell("gru", *GRU_DIMS)]
    task = SeqClassifyTask(**GRU_TASK)
    dense = train_classifier(cells, params, task, GRU_DENSE_STEPS)
    dense_acc = classifier_accuracy(cells, dense["params"], task)
    pruned = train_classifier(cells, params, task, GRU_ADMM_STEPS,
                              specs=gru_specs(params))
    pruned_acc = classifier_accuracy(cells, pruned["params"], task)
    cp = pruned["params"]["rnn"][0]
    dens = float(density(cp["U_z"]))
    if not (dense_acc > 0.5 and pruned_acc > max(dense_acc - 0.2, 0.4)
            and dens <= 0.56):
        raise AssertionError(f"GRU flow: dense accuracy {dense_acc}, pruned "
                             f"{pruned_acc}, density(U_z) {dens}")
    csb, masks = dict(cp), {}
    for name in GRU_PRUNED:
        masks[name] = rm, cm = csb_masks(cp[name], GRU_SPEC)
        csb[name] = padded_csb_from_dense(
            cp[name], GRU_SPEC.bm, GRU_SPEC.bn, row_mask=rm, col_mask=cm,
            device=dev)
    gen = torch.Generator().manual_seed(SEED + 9)
    x = torch.randn(4, GRU_DIMS[0], generator=gen).to(dev)
    st = init_state(cells[0], (4,), device=dev)
    with torch.no_grad():
        y_dense, _ = cell_apply(cells[0], cp, x, st)
        launches = csb_mvm.LAUNCHES
        y_csb, _ = cell_apply(cells[0], csb, x, st)
        launches = csb_mvm.LAUNCHES - launches
    err = float((y_csb - y_dense).abs().max())
    if not torch.allclose(y_csb, y_dense, rtol=3e-5, atol=3e-5):
        raise AssertionError(f"GRU served through CSB: {err:.3e} from the "
                             f"masked-dense cell (bound 3e-5)")
    rm, cm = masks["U_n"]
    mat = CSBMatrix.from_dense(cp["U_n"].cpu().numpy(), GRU_SPEC.bm,
                               GRU_SPEC.bn, rm.cpu().numpy(),
                               cm.cpu().numpy())
    e = CycleConfig(K=2, L=2, P=4, Q=4)
    eff0 = simulate_matrix(mat, e, "none").efficiency
    eff2 = simulate_matrix(mat, e, "2d").efficiency
    if eff2 < eff0:
        raise AssertionError(f"2-D sharing {eff2:.3f} < none {eff0:.3f}")
    print(f"  (a) GRU {GRU_DIMS[0]}->{GRU_DIMS[1]} classifier: dense "
          f"{GRU_DENSE_STEPS} steps, accuracy {dense_acc:.4f} (> 0.5); "
          f"ADMM at {GRU_SPEC} on {GRU_PRUNED}, {GRU_ADMM_STEPS} steps, "
          f"accuracy {pruned_acc:.4f} (> {max(dense_acc - 0.2, 0.4):.4f}), "
          f"density(U_z) {dens:.4f} (<= 0.56); one step served through "
          f"CSB ({launches} B1 launches) {err:.3e} from the masked-dense "
          f"cell (bound 3e-5); engine cycle model on U_n "
          f"(EngineConfig(2, 2, 4, 4), modelled): efficiency none "
          f"{eff0:.4f}, 2d {eff2:.4f}; ms per step dense "
          f"{dense['step_ms']:.2f}, ADMM {pruned['step_ms']:.2f}")
    return {"dense_acc": dense_acc, "pruned_acc": pruned_acc,
            "density_U_z": dens, "serve_err": err, "launches": launches,
            "eff_none": eff0, "eff_2d": eff2,
            "step_ms_dense": dense["step_ms"],
            "step_ms_admm": pruned["step_ms"]}


def sr1_classifier(dev, seed=SEED) -> tuple:
    """SR1's two LSTMP layers at full width between a vocab x vocab
    embedding and a readout to the task's classes, from a seeded
    generator."""
    gen = torch.Generator().manual_seed(seed)
    cells = [make_cell(c.cell, c.n_input, c.n_hidden, c.proj)
             for c in PAPER_MODELS["SR1"].layers]
    vocab, n_out = SR1_TASK["vocab"], cells[-1].op("W_proj").shape[0]
    params = {"emb": (torch.randn(vocab, vocab, generator=gen)
                      * 0.3).to(dev),
              "rnn": [init_params(c, gen, device=dev) for c in cells],
              "out": (torch.randn(n_out, SR1_TASK["n_classes"],
                                  generator=gen) / math.sqrt(n_out)).to(dev)}
    return cells, params


def csb_pattern_check(name, z, packed, mat, spec) -> tuple:
    """Algorithm 1's counts on a finalized weight ``z`` and its frozen
    packing: in each block-column at most keep_r rows of z are nonzero,
    in each block-row at most keep_c columns (keep_r, keep_c as
    ``csb_masks`` counts them), and the same holds for the packing's m,
    n; the packing stores every nonzero of z, and as many entries as
    ``mat``, the CPU's packing of the same weights. Returns the stored
    fraction and the density of z; raises where a count is broken."""
    q = 1.0 - math.sqrt(1.0 - spec.prune_rate)
    (br, bc), (bm, bn) = packed.grid, (spec.bm, spec.bn)
    keep_r = max(int(round((1.0 - q) * br * bm)), 1)
    keep_c = max(int(round((1.0 - q) * bc * bn)), 1)
    nz = F.pad(z != 0, (0, bc * bn - z.shape[1], 0, br * bm - z.shape[0]))
    nz = nz.reshape(br, bm, bc, bn)
    rows = nz.any(3).sum((0, 1))                 # per block-column
    cols = nz.any(1).sum((1, 2))                 # per block-row
    m = packed.m.reshape(br, bc).long()
    n = packed.n.reshape(br, bc).long()
    stored, nnz = int((m * n).sum()), int(nz.sum())
    bad = [what for what, ok in (
        (f"rows of z per block-column {int(rows.max())} > {keep_r}",
         int(rows.max()) <= keep_r),
        (f"columns of z per block-row {int(cols.max())} > {keep_c}",
         int(cols.max()) <= keep_c),
        (f"packed rows per block-column {int(m.sum(0).max())} > {keep_r}",
         int(m.sum(0).max()) <= keep_r),
        (f"packed columns per block-row {int(n.sum(1).max())} > {keep_c}",
         int(n.sum(1).max()) <= keep_c),
        (f"{nnz} nonzeros, {stored} stored", nnz <= stored),
        (f"{stored} stored on the card, {mat.nnz} by the CPU",
         stored == mat.nnz)) if not ok]
    if bad:
        raise AssertionError(f"{name}: {'; '.join(bad)}")
    size = z.shape[0] * z.shape[1]
    return stored / size, nnz / size


def sr1_pipeline(dev, frames, sl) -> dict:
    """SR1 at full width through the paper's pipeline: dense training,
    ``csb_specs_for_params``, ADMM, finalize, ``CSBLinear.freeze`` and
    ``rnn_serve_frames`` through B1 on the SR1 phase's frames."""
    cells, params = sr1_classifier(dev)
    task = SeqClassifyTask(**SR1_TASK)
    dense = train_classifier(cells, params, task, SR1_DENSE_STEPS)
    specs = csb_specs_for_params(dense["params"], SR1_SPEC,
                                 exclude=("emb", "out"))
    names = [(i, k) for i, s in enumerate(specs["rnn"])
             for k, v in s.items() if v is not None]
    if len(names) != len(cells) * MVMS_PER_STEP or specs["emb"] is not None \
            or specs["out"] is not None:
        raise AssertionError(f"csb_specs_for_params selected {names}")
    # at test_system.py's rho 0.02 the residual grows over these 100
    # steps, in the JAX package as in the port
    # (tests/test_torch_admm_sr1.py); at SR1_RHO it falls
    admm = train_classifier(cells, dense["params"], task, SR1_ADMM_STEPS,
                            specs=specs, start=SR1_DENSE_STEPS, rho=SR1_RHO)
    res = admm["residuals"]
    if not res[-1] < res[0]:
        raise AssertionError(f"ADMM residual {res[0]:.4f} after the first "
                             f"update, {res[-1]:.4f} after the last")
    # the trained weights before finalize, masked on the card and on the
    # CPU: summation order may flip a near-tie (a count, not a gate)
    trained, flips = admm["trained"], 0
    for i, k in names:
        w = trained["rnn"][i][k]
        for a, b in zip(csb_masks(w, SR1_SPEC), csb_masks(w.cpu(), SR1_SPEC)):
            flips += int((a.cpu() != b).sum())
    fin = admm["params"]
    accs = {k: classifier_accuracy(cells, r["params"], task, SR1_EVAL_START)
            for k, r in (("dense", dense), ("pruned", admm))}
    serve, rows = [dict(p) for p in fin["rnn"]], []
    for i, k in names:
        z = fin["rnn"][i][k]
        lin = CSBLinear(z, SR1_SPEC, mode="masked").freeze()
        p = lin._packed
        serve[i][k] = p
        # the CPU's packing of the same weights, a second witness
        zc = z.cpu()
        mat = CSBMatrix.from_dense(zc.numpy(), SR1_SPEC.bm, SR1_SPEC.bn,
                                   *(a.numpy() for a in csb_masks(zc,
                                                                  SR1_SPEC)))
        stored, dens = csb_pattern_check(f"layer {i + 1} {k}", z, p, mat,
                                         SR1_SPEC)
        sims = {m: simulate_matrix(mat, SR1_ENGINE, m)
                for m in ("none", "horizontal", "2d")}
        rows.append({"matrix": f"{i + 1}.{k}", "shape": p.shape,
                     "density": dens, "stored": stored,
                     "compression": lin.compression(),
                     **{f"eff_{m}": s.efficiency for m, s in sims.items()},
                     **{f"latency_us_{m}": s.latency_us
                        for m, s in sims.items()}})
    srv = serve_sr1(cells, serve, fin["rnn"], frames)
    print(f"  (b) SR1 at full width, {SR1_SPEC}: {len(names)} matrices "
          f"selected; dense {SR1_DENSE_STEPS} steps, accuracy "
          f"{accs['dense']:.4f}, {dense['step_ms']:.2f} ms a step; ADMM "
          f"{SR1_ADMM_STEPS} steps at rho {SR1_RHO}: residual "
          f"{res[0]:.4f} -> {res[-1]:.4f}, accuracy "
          f"{accs['pruned']:.4f}, {admm['step_ms']:.2f} ms a step; card vs "
          f"CPU masks of the trained weights differ in {flips} block rows "
          f"and columns")
    print(f"      served {FRAMES} frames through B1 ({srv['launches']} "
          f"launches): {srv['max_abs_err']:.3e} from the masked-dense model "
          f"(bound 1e-4); us_per_frame {srv['us_per_frame']:.1f}, frame "
          f"p99 {srv['p99_us']:.1f} us "
          f"(SR1 phase, projected weights: {sl['us_per_frame']:.1f}, "
          f"{sl['p99_us']:.1f} us)")
    print(f"      per matrix: density, stored fraction (sum m*n / "
          f"size; the spec keeps {SR1_SPEC.keep_fraction:.4f} on average "
          f"over uniform blocks), CSBLinear.compression(); engine cycle "
          f"model at {SR1_ENGINE} "
          f"(modelled at 200 MHz, not card times): efficiency none / "
          f"horizontal / 2d, latency us none / 2d")
    for r in rows:
        print(f"      {r['matrix']:9s} {str(r['shape']):12s} "
              f"{r['density']:.4f} {r['stored']:.4f} "
              f"{r['compression']:6.2f}x  {r['eff_none']:.4f} "
              f"{r['eff_horizontal']:.4f} {r['eff_2d']:.4f}  "
              f"{r['latency_us_none']:.2f} {r['latency_us_2d']:.2f}")
    return {"launches": srv["launches"], "max_abs_err": srv["max_abs_err"],
            "dense_acc": accs["dense"], "pruned_acc": accs["pruned"],
            "step_ms_dense": dense["step_ms"], "step_ms_admm": admm["step_ms"],
            "residual_first": res[0], "residual_last": res[-1],
            "mask_flips": flips, "us_per_frame": srv["us_per_frame"],
            "frame_p99_us": srv["p99_us"], "matrices": rows}


def build_lm_ffn(dev) -> dict:
    """gemma-2b's w_gate / w_up shape (in 2048, out 16384), random weights
    from a generator seeded 0, as a ``CSBLinear(transposed=True)`` in
    masked mode at examples/train_lm_e2e.py's spec and its ``freeze()``
    (B1's grid and launch configuration checked and printed), and x
    (4, 2048)."""
    gen = torch.Generator().manual_seed(SEED)
    d_in, d_out = LM_FFN
    w = (torch.randn(LM_FFN, generator=gen) / math.sqrt(d_in)).to(dev)
    x = torch.randn(LM_FFN_BATCH, d_in, generator=gen).to(dev)
    lin = CSBLinear(w, LM_FFN_SPEC, mode="masked", transposed=True)
    t0 = time.perf_counter()
    frozen = lin.freeze()
    freeze_s = time.perf_counter() - t0
    p = frozen._packed
    (br, bc), (bm, _) = p.grid, p.block
    cfg = csb_mvm.launch_config(bc, bm, p.pm, p.pn, 8, LM_FFN_BATCH)
    ctas = (br, -(-LM_FFN_BATCH // 8))
    if ctas[0] > 2 ** 31 - 1 or ctas[1] > 65535 or cfg[0] > 1024 \
            or 8 * bm > 1024:
        raise AssertionError(f"B1 cannot launch grid {ctas}, {cfg}")
    print(f"{ARCH} FFN projection (in {d_in}, out {d_out}) at "
          f"{LM_FFN_SPEC}: frozen in {freeze_s:.2f} s, grid {p.grid} = "
          f"{p.m.numel()} blocks, Pm {p.pm}, Pn {p.pn}, compression "
          f"{frozen.compression():.3f}x; B1 launch: CTAs {ctas}, (threads, "
          f"lanes, chunk, smem) {cfg}")
    return {"lin": lin, "frozen": frozen, "x": x, "freeze_s": freeze_s,
            "ctas": ctas, "launch_config": cfg,
            "compression": frozen.compression()}


def ffn_timing_phase(ffn) -> dict:
    """B1 at gemma-2b's FFN shape, x in fp32 and bf16, timed as the SR1
    frame's MVMs are (early in the run: late in a long run the profiler
    drops kernels from its traces)."""
    p = ffn["frozen"]._packed
    return {str(dtype).split(".")[-1]: b1_timing(
        f"B1 at {ARCH}'s FFN (in {LM_FFN[0]}, out {LM_FFN[1]}, batch "
        f"{LM_FFN_BATCH}, x {dtype})", [(p, ffn["x"].to(dtype))])
        for dtype in (torch.float32, torch.bfloat16)}


def lm_ffn(ffn) -> dict:
    """B1 at an LM width through ``csb_dense``: the frozen FFN projection
    on x in fp32 and bf16, held to the plain version and to the masked
    mode at the kernel phase's tolerances."""
    lin, frozen, x = ffn["lin"], ffn["frozen"], ffn["x"]
    p = frozen._packed
    out = {"max_abs_err": 0.0}
    launches = csb_mvm.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        y = csb_dense(xd, frozen)
        masked = csb_dense(xd, lin)
        ref = plain(p, xd).to(dtype)
        tol = TOL[dtype]
        errs = (float((y.float() - ref.float()).abs().max()),
                float((y.float() - masked.float()).abs().max()))
        if y.shape != (LM_FFN_BATCH, LM_FFN[1]) or y.dtype != dtype \
                or not torch.allclose(y.float(), ref.float(), rtol=tol,
                                      atol=tol) \
                or not torch.allclose(y.float(), masked.float(), rtol=tol,
                                      atol=tol):
            raise AssertionError(f"csb_dense {dtype}: {errs} from the plain "
                                 f"version and the masked mode (tol {tol})")
        if dtype == torch.float32:
            out["max_abs_err"] = errs[0]
        print(f"  (c) csb_dense at {ARCH}'s FFN, x {dtype}: {errs[0]:.3e} "
              f"from the plain version, {errs[1]:.3e} from the masked mode "
              f"(tol {tol})")
    out["launches"] = csb_mvm.LAUNCHES - launches
    return out


def paper_phase(dev, frames, sl, ffn) -> dict:
    """The paper pipeline on the card: (a) tests/test_system.py's flow,
    (b) SR1 at full width through ADMM, ``CSBLinear`` and B1, (c) B1 at
    gemma-2b's FFN width through ``csb_dense`` (``ffn`` from
    ``build_lm_ffn``, timed in ``ffn_timing_phase``). B1's launch count
    is set to 0 before the three parts and read after them."""
    csb_mvm.LAUNCHES = 0
    t = [time.perf_counter()]
    gru = gru_flow(dev)
    t.append(time.perf_counter())
    sr1 = sr1_pipeline(dev, frames, sl)
    t.append(time.perf_counter())
    out = lm_ffn(ffn)
    t.append(time.perf_counter())
    launches = csb_mvm.LAUNCHES
    if launches != gru["launches"] + sr1["launches"] + out["launches"] \
            or gru["launches"] != len(GRU_PRUNED) or out["launches"] != 2:
        raise AssertionError(f"B1 launched {launches} times in the paper "
                             f"phase: GRU {gru['launches']}, SR1 "
                             f"{sr1['launches']}, FFN {out['launches']}")
    secs = [b - a for a, b in zip(t, t[1:])]
    print(f"  paper phase: B1 launched {launches} times; (a) {secs[0]:.1f} "
          f"s, (b) {secs[1]:.1f} s, (c) {secs[2]:.1f} s")
    return {"gru": gru, "sr1": sr1, "lm_ffn": out, "launches": launches,
            "part_s": secs}


# ---------------------------------------------------------------------------
# B3: the sharded CSB matvec over ranks of one card ([phase sharded])
# ---------------------------------------------------------------------------

def b3_rows_plain(s, x, rank):
    """B3's contract on ``rank`` without the exchange, by its plain version
    on the same tensors (``ref.csb_sharded_rows_ref``)."""
    x2 = x.reshape(-1, x.shape[-1])
    cols = csb_sharded._column_table(s.row_map, rank, s.rows_per_dev,
                                     s.block[0], s.shape[0], x.device)
    return csb_sharded_rows_ref(*s.shard_arrays(rank), x2, cols,
                                grid=(s.rows_per_dev, s.grid[1]),
                                block=s.block, out_dim=s.shape[0])


def b3_cases(mesh, cases) -> dict:
    """(a) on this rank: B3 (``csb_matvec_sharded``) on each matrix of
    ``cases`` ({name: (PaddedCSB, x, B1's y on the whole matrix)}) split
    over the mesh's "model" axis, for every overlap: bit-equal to B1,
    within ``TOL`` of B3's plain version (the chunked gathers), one kernel
    launch a call (none on a rank with only pad rows) and no B1 launch;
    and the kernel's own contract on this rank (``csb_sharded_rows``)
    within ``TOL`` of its plain version; or it raises. Returns the plans,
    the launches a call and the errors."""
    n_model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    rank = mesh.get_local_rank("model")
    out = {"plans": {}, "launches": {}, "max_abs_err": 0.0}
    for name, (p, x, want) in cases.items():
        plan, s = partition_padded(p.to("cpu"), n_model)
        s = s.local(rank).to(x.device)
        out["plans"][name] = (plan.imbalance,
                              [len(r) for r in plan.assignment])
        owns = int(bool(plan.assignment[rank]))
        for ov in SHARD_OVERLAPS:
            before = (csb_sharded.LAUNCHES, csb_mvm.LAUNCHES)
            y = csb_matvec_sharded(s, x, mesh=mesh, overlap=ov)
            per_call = (csb_sharded.LAUNCHES - before[0],
                        csb_mvm.LAUNCHES - before[1])
            out["launches"][(name, ov)] = per_call
            ref = csb_matvec_sharded_ref(s, x, mesh=mesh, overlap=ov)
            _sync(x.device)
            what = f"B3 over {n_model} ranks, {name}, overlap {ov}"
            if per_call != (owns, 0):
                raise AssertionError(f"{what}: launches (B3, B1) {per_call}"
                                     f", expected ({owns}, 0)")
            if y.shape != want.shape or not torch.equal(y, want):
                diff = (float((y - want).abs().max())
                        if y.shape == want.shape else "a shape")
                raise AssertionError(f"{what}: differs from B1 on the "
                                     f"unsharded matrix by {diff}")
            err = float((y - ref).abs().max())
            if not torch.allclose(y, ref, rtol=TOL[x.dtype],
                                  atol=TOL[x.dtype]):
                raise AssertionError(f"{what}: {err:.3e} from its plain "
                                     f"version (tol {TOL[x.dtype]})")
            out["max_abs_err"] = max(out["max_abs_err"], err)
        rows = csb_sharded_rows(s, x, rank)
        ref = b3_rows_plain(s, x, rank)
        _sync(x.device)
        err = float((rows - ref).abs().max())
        if not torch.allclose(rows, ref, rtol=TOL[x.dtype],
                              atol=TOL[x.dtype]):
            raise AssertionError(f"B3's rows of rank {rank}, {name}: {err:.3e}"
                                 f" from their plain version")
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def b3_loop(mesh, loop) -> int:
    """``SHARD_LOOP`` B3 calls back to back on one matrix with a new x each
    (``loop`` = (PaddedCSB, xs, B1's ys)), no host wait between them, then
    every output held bit-equal to B1's: a rank that ran ahead and
    overwrote a slot a peer had not yet copied out would show here."""
    p, xs, wants = loop
    n_model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    rank = mesh.get_local_rank("model")
    s = partition_padded(p.to("cpu"), n_model)[1].local(rank).to(
        xs[0].device)
    ys = [csb_matvec_sharded(s, x, mesh=mesh) for x in xs]
    _sync(xs[0].device)
    bad = [i for i, (y, w) in enumerate(zip(ys, wants))
           if not torch.equal(y, w)]
    if bad:
        raise AssertionError(f"B3 over {n_model} ranks, {len(xs)} calls "
                             f"back to back: calls {bad[:10]} differ from B1")
    return len(ys)


def b3_shards(mesh, pairs, dev):
    n_model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    rank = mesh.get_local_rank("model")
    return [(partition_padded(p.to("cpu"), n_model)[1].local(rank).to(dev),
             x) for p, x in pairs]


def b3_timing(mesh, label, pairs) -> dict:
    """B3 at R = 1 on ``pairs`` of (PaddedCSB, x): CUDA events (median of
    50) beside B1 on the whole matrix (``csb_matvec``) and B3's plain
    version; the profiler's device time of every kernel B3's calls launch
    (gated at one kernel a call) and of B1's, each profile holding every
    launch of its calls; CUDA-graph replay; and the bound: the live bytes
    (the shard's values and indices, x, and its rows stored once to each of
    the R = 1 ranks), or the products at the fp32 rate."""
    dev = torch.device("cuda", torch.cuda.current_device())
    shards = b3_shards(mesh, pairs, dev)
    live = flops = 0
    for p, x in pairs:
        b, _, ops = mvm_work(p, x)
        live += b
        flops += ops

    def b3():
        for s, x in shards:
            csb_matvec_sharded(s, x, mesh=mesh)

    def b1():
        for p, x in pairs:
            csb_matvec(p, x)

    def plain_version():
        for s, x in shards:
            csb_matvec_sharded_ref(s, x, mesh=mesh)

    out = {"ms": median_ms(b3), "b1_ms": median_ms(b1),
           "plain_ms": median_ms(plain_version)}
    counts = {}
    out["device_ms"], each = device_kernel_ms(
        b3, None, per_call={"csb_sharded_kernel": len(pairs)},
        launch_counts=counts)
    out["device_kernels_per_call"] = sum(counts.values()) / len(pairs)
    if out["device_kernels_per_call"] != 1:
        raise AssertionError(f"(d) {label}: {counts} device kernels a frame "
                             f"of {len(pairs)} B3 calls, expected one a call")
    out["b1_device_ms"], _ = device_kernel_ms(
        b1, per_call={"csb_mvm_kernel": len(pairs)})
    out["device_vs_b1"] = out["device_ms"] / out["b1_device_ms"]
    try:
        out["graph_ms"], out["graph_note"] = graph_ms(b3), None
    except RuntimeError as e:          # a timing only: the gates ran above
        out["graph_ms"], out["graph_note"] = None, str(e).splitlines()[0]
    bytes_s = live / HBM_BYTES_PER_S
    ops_s = flops / FP32_FLOPS
    out["bound_ms"] = max(bytes_s, ops_s) * 1e3
    out["bound_by"] = "bytes" if bytes_s >= ops_s else "operations"
    out["bytes"] = live
    print(f"  (d) {label}, one NCCL rank (median of 50, CUDA events): B3 "
          f"{out['ms']:.4f} ms, B1 on the whole matrix {out['b1_ms']:.4f} "
          f"ms, B3's plain version {out['plain_ms']:.4f} ms; device time B3 "
          f"{_ms(out['device_ms'])} in {out['device_kernels_per_call']:g} "
          f"device kernel a call, B1 {_ms(out['b1_device_ms'])} (B3 / B1 "
          f"{out['device_vs_b1']:.3f}); CUDA graph B3 "
          f"{_ms(out['graph_ms'])}"
          f"{'' if out['graph_note'] is None else ' (' + out['graph_note'] + ')'}"
          f"; bound {out['bound_ms']:.5f} ms ({live} live bytes, {flops} "
          f"flops)")
    print("      device time by kernel: " + ", ".join(
        f"{k[:40]} {v:.4f} ms" for k, v in sorted(
            each.items(), key=lambda kv: -kv[1])[:4]))
    return out


def b3_rank_events(mesh, pairs) -> dict:
    """B3 over the ranks of ``mesh`` on ``pairs`` (one SR1 frame's 18
    MVMs), every rank at once: CUDA events around the frame (median of
    50) and the host's wall clock over 50 frames ending in a synchronise,
    both per call."""
    dev = torch.device("cuda", torch.cuda.current_device())
    shards = b3_shards(mesh, pairs, dev)

    def b3():
        for s, x in shards:
            csb_matvec_sharded(s, x, mesh=mesh)

    ms = median_ms(b3) / len(pairs)
    t0 = time.perf_counter()
    for _ in range(50):
        b3()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (50 * len(pairs))
    return {"events_ms_per_call": ms, "wall_ms_per_call": wall}


def sharded_one_rank(mesh, cases, sr1_pairs, ffn_pairs) -> dict:
    """The NCCL rank: (a) at R = 1, then (d)."""
    out = {"a": b3_cases(mesh, cases)}
    out["sr1"] = b3_timing(mesh, f"one SR1 frame's {len(sr1_pairs)} CSB "
                           f"MVMs at batch 1", sr1_pairs)
    out["ffn"] = {str(x.dtype).split(".")[-1]: b3_timing(
        mesh, f"{ARCH}'s FFN, batch {LM_FFN_BATCH}, x {x.dtype}", [(p, x)])
        for p, x in ffn_pairs}
    return out


def serve_sharded(mesh, layers, frames, want, lin, ffn_x, ffn_want) -> dict:
    """(b) SR1 through ``rnn_serve_frames(mesh=...)`` and (c) ``csb_dense``
    under ``use_rules``, each with both launch counts set to 0 just before
    it and read just after; outputs and final states bit-equal to the
    unsharded run through B1 and within 1e-4 of the masked-dense model,
    and ``csb_dense`` equal to its unsharded run, or it raises."""
    cfg = EngineConfig(frame_warmup=WARMUP, collect_frame_times=True)
    csb_mvm.LAUNCHES = csb_sharded.LAUNCHES = 0
    x, runs = frames, []
    for (cell, csb), (y_b1, st_b1, y_dense, st_dense) in zip(layers, want):
        y, st, us, frame_us = rnn_serve_frames(cell, csb, x, config=cfg,
                                               mesh=mesh)
        for a, b, c, what in [(y, y_b1, y_dense, "outputs")] + [
                (st[k], st_b1[k], st_dense[k], f"state {k}") for k in st_b1]:
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{cell.name} {what}: sharded differ from unsharded B1 "
                    f"by {float((a - b).abs().max()):.3e}")
            if not torch.allclose(a, c, rtol=1e-4, atol=1e-4):
                raise AssertionError(
                    f"{cell.name} {what}: {float((a - c).abs().max()):.3e} "
                    f"from the masked-dense model")
        runs.append((us, frame_us, float((y - y_dense).abs().max())))
        x = y
    launches = {"b": {"b3": csb_sharded.LAUNCHES, "b1": csb_mvm.LAUNCHES}}
    csb_mvm.LAUNCHES = csb_sharded.LAUNCHES = 0
    with use_rules(Rules(mesh=mesh)):
        for dtype, y_want in ffn_want.items():
            y = csb_dense(ffn_x.to(dtype), lin)
            if not torch.equal(y, y_want):
                raise AssertionError(f"csb_dense {dtype} through the mesh "
                                     f"differs from its unsharded run")
    launches["c"] = {"b3": csb_sharded.LAUNCHES, "b1": csb_mvm.LAUNCHES}
    frame_us = sum(r[1] for r in runs)
    return {"launches": launches,
            "us_per_frame": sum(r[0] for r in runs),
            "p50_us": float(np.percentile(frame_us, 50)),
            "p99_us": float(np.percentile(frame_us, 99)),
            "dense_err": max(r[2] for r in runs),
            "shards": sorted(lin._shards)}


def sharded_two_ranks(mesh, cases, layers, frames, want, lin, ffn_x,
                      ffn_want, loop, sr1_pairs) -> dict:
    out = {"a": b3_cases(mesh, cases), "loop": b3_loop(mesh, loop),
           "route": exchange_route(2)}
    out["bc"] = serve_sharded(mesh, layers, frames, want, lin, ffn_x,
                              ffn_want)
    out["events"] = b3_rank_events(mesh, sr1_pairs)
    return out


def sharded_four_ranks(mesh, cases, loop) -> dict:
    return {"a": b3_cases(mesh, cases), "loop": b3_loop(mesh, loop),
            "route": exchange_route(4)}


def print_b3_cases(n_ranks, results) -> float:
    """(a)'s per-rank results: plans (imbalance, rows per rank) and the
    launches a call; returns the max abs error from the plain versions."""
    r0 = results[0]["a"]
    for other in results[1:]:
        if other["a"]["plans"] != r0["plans"]:
            raise AssertionError(f"ranks planned differently: "
                                 f"{other['a']['plans']} vs {r0['plans']}")
    per = sorted({v for r in results for v in r["a"]["launches"].values()})
    err = max(r["a"]["max_abs_err"] for r in results)
    loop = (f"; {results[0]['loop']} calls back to back bit-equal on every "
            f"rank" if "loop" in results[0] else "")
    print(f"  (a) R = {n_ranks} (exchange: {exchange_route(n_ranks)}): "
          f"{len(r0['plans'])} matrices x overlap {SHARD_OVERLAPS} bit-equal "
          f"to B1 on the unsharded matrix on every rank; max abs err from "
          f"the plain versions {err:.3e}; (B3, B1) launches a call on a rank "
          f"{per}{loop}")
    for name, (imb, rows) in r0["plans"].items():
        print(f"      {name:28s} imbalance {imb:.4f}, block-rows per rank "
              f"{rows}")
    return err


def sharded_phase(dev, layers, frames, ffn) -> dict:
    """Kernel B3 on one card: (a) against B1 at R = 1 (an NCCL group of
    one), 2 and 4 (gloo ranks sharing the card, exchanging through B3's
    stores), with ``SHARD_LOOP`` calls back to back at R = 2 and 4, (b) SR1
    served sharded and (c) ``csb_dense`` through the mesh on two ranks,
    with B3's per-call events there, (d) B3 timed at R = 1. Every rank is
    a process of its own (``spawn_ranks``); a rank that fails makes the
    phase raise."""
    rng = np.random.default_rng(SEED + 3)
    cases, sr1_pairs = {}, []
    for i, (cell, csb, _) in enumerate(layers):
        for name, p in csb.items():
            if isinstance(p, torch.Tensor):
                continue
            x = torch.from_numpy(rng.standard_normal(
                (1, p.shape[1])).astype(np.float32)).to(dev)
            cases[f"SR1 layer {i + 1} {name} {p.shape}"] = (
                p, x, csb_matvec(p, x))
            sr1_pairs.append((p, x))
    frozen, ffn_pairs, ffn_want = ffn["frozen"], [], {}
    p = frozen._packed
    for dtype in (torch.float32, torch.bfloat16):
        x = ffn["x"].to(dtype)
        cases[f"{ARCH} FFN, x {str(dtype).split('.')[-1]}"] = (
            p, x, csb_matvec(p, x))
        ffn_pairs.append((p, x))
        ffn_want[dtype] = csb_dense(x, frozen)
    p0 = sr1_pairs[0][0]
    xs = [torch.from_numpy(rng.standard_normal((1, p0.shape[1])).astype(
        np.float32)).to(dev) for _ in range(SHARD_LOOP)]
    loop = (p0, xs, [csb_matvec(p0, x) for x in xs])
    cfg = EngineConfig(frame_warmup=WARMUP)
    want, x, xd = [], frames, frames
    with torch.no_grad():
        for cell, csb, dense in layers:
            y, st, _ = rnn_serve_frames(cell, csb, x, config=cfg)
            yd, std = rnn_scan(cell, dense, xd)
            want.append((y, st, yd, std))
            x, xd = y, yd
    _sync(dev)
    srv_layers = [(cell, csb) for cell, csb, _ in layers]
    t = [time.perf_counter()]
    one = spawn_ranks(sharded_one_rank, (1, 1), cases, sr1_pairs, ffn_pairs,
                      timeout_s=SHARD_TIMEOUT_S)[0]
    t.append(time.perf_counter())
    two = spawn_ranks(sharded_two_ranks, (1, 2), cases, srv_layers, frames,
                      want, frozen, ffn["x"], ffn_want, loop, sr1_pairs,
                      timeout_s=SHARD_TIMEOUT_S)
    t.append(time.perf_counter())
    four = spawn_ranks(sharded_four_ranks, (1, 4), cases, loop,
                       timeout_s=SHARD_TIMEOUT_S)
    t.append(time.perf_counter())
    err = max(print_b3_cases(1, [one]), print_b3_cases(2, two),
              print_b3_cases(4, four))
    bc = [r["bc"] for r in two]
    # one B3 launch a call on a rank that holds rows of the matrix (R = 2's
    # plans, from (a)), B1 none
    plans = two[0]["a"]["plans"]
    calls = WARMUP + 2 * FRAMES
    sr1 = [n for n in plans if n.startswith("SR1 ")]
    if len(sr1) != len(layers) * MVMS_PER_STEP:
        raise AssertionError(f"{len(sr1)} SR1 matrices in (a)'s plans")
    for rank, r in enumerate(bc):
        expect = {"b": {"b3": calls * sum(plans[n][1][rank] > 0
                                          for n in sr1), "b1": 0},
                  "c": {"b3": sum(plans[n][1][rank] > 0 for n in plans
                                  if "FFN" in n), "b1": 0}}
        if r["launches"] != expect or r["shards"] != [(2, "model")]:
            raise AssertionError(f"(b), (c) on rank {rank}: launches "
                                 f"{r['launches']}, expected {expect}; "
                                 f"shards {r['shards']}")
    ev = [r["events"] for r in two]
    print(f"  (b) SR1 at full width, {FRAMES} frames at batch 1, over a "
          f"(1, 2) ('data', 'model') mesh: outputs and final states "
          f"bit-equal to the unsharded run through B1 on both ranks, "
          f"{max(r['dense_err'] for r in bc):.3e} from the masked-dense "
          f"model (bound 1e-4); two ranks sharing one card, exchanging "
          f"through B3's stores ({two[0]['route']}): us_per_frame "
          f"{[round(r['us_per_frame'], 1) for r in bc]}, frame p50 "
          f"{[round(r['p50_us'], 1) for r in bc]} us, p99 "
          f"{[round(r['p99_us'], 1) for r in bc]} us (rank 0, rank 1)")
    print(f"  (c) csb_dense at {ARCH}'s FFN through the mesh (fp32, bf16) "
          f"equals its unsharded run on both ranks; launches on each rank, "
          f"each counted from 0 just before its step: (b) "
          f"{[r['launches']['b'] for r in bc]}, (c) "
          f"{[r['launches']['c'] for r in bc]}")
    print(f"  B3 at R = 2 on one card, one SR1 frame's {len(sr1_pairs)} MVMs "
          f"(every rank at once): CUDA events per call "
          f"{[round(e['events_ms_per_call'], 4) for e in ev]} ms, host wall "
          f"per call {[round(e['wall_ms_per_call'], 4) for e in ev]} ms "
          f"(rank 0, rank 1); at R = 1: events "
          f"{one['sr1']['ms'] / len(sr1_pairs):.4f} ms a call")
    print(f"  sharded phase: spawn + run R = 1 {t[1] - t[0]:.1f} s, R = 2 "
          f"{t[2] - t[1]:.1f} s, R = 4 {t[3] - t[2]:.1f} s; every number of "
          f"this phase on {card_line()}")
    return {"max_abs_err": err, "launches": bc[0]["launches"]["b"]["b3"],
            "b1_launches": bc[0]["launches"]["b"]["b1"],
            "exchange_route": two[0]["route"],
            "us_per_frame_2_ranks": bc[0]["us_per_frame"],
            "frame_p99_us_2_ranks": bc[0]["p99_us"],
            "events_ms_per_call_2_ranks": ev[0]["events_ms_per_call"],
            "wall_ms_per_call_2_ranks": ev[0]["wall_ms_per_call"],
            "loop_calls": {"R2": two[0]["loop"], "R4": four[0]["loop"]},
            "sr1": one["sr1"], "ffn": one["ffn"],
            "plans": {f"R{n}": r[0]["a"]["plans"]
                      for n, r in ((1, [one]), (2, two), (4, four))}}


# ---------------------------------------------------------------------------
# Training ([phase train]): the JAX launcher's loop at gemma-2b's full
# width and depth, ADMM-CSB on its FFN then B1, card against CPU
# ---------------------------------------------------------------------------

def _flat(t) -> list:
    return list(_leaves(t))


def grad_gate(cfg, params, dev) -> float:
    """Autograd gradients of one batch (step TRAIN_STEPS of the launcher's
    stream) at the trained weights: every leaf finite, the global norm
    above 0. Returns the norm."""
    task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             task.batch(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ).items()}
    leaves = _flat(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = LM.forward_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    bad = [i for i, g in enumerate(grads) if not bool(torch.isfinite(g).all())]
    gn = float(global_norm(list(grads)))
    if bad or not gn > 0 or not math.isfinite(float(loss.detach())):
        raise AssertionError(f"gradients at the trained weights: leaves "
                             f"{bad} not finite, global norm {gn}, loss "
                             f"{float(loss.detach())}")
    return gn


def optimizer_timing(params, p50_ms) -> dict:
    """AdamW's update alone on the trained weights (CUDA events, median of
    OPT_TIMING_REPS), its share of the step, and its bound: each input
    read once (params, grads, m, v), each output written once (params,
    m, v), at the card's memory rate."""
    opt = get_optimizer("adamw")
    state = opt.init(params)
    grads = _tree(params, lambda t: torch.full_like(t, 1e-3))
    ms = median_ms(lambda: opt.update(grads, state, params, 1e-6),
                   reps=OPT_TIMING_REPS, warm=1)
    n = sum(t.numel() for t in _flat(params))
    pbytes = sum(t.numel() * t.element_size() for t in _flat(params))
    moments = 2 * 4 * n
    moved = 2 * pbytes + pbytes + 2 * moments
    bound = moved / HBM_BYTES_PER_S * 1e3
    del state, grads
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  optimizer (AdamW, fp32 moments) alone: {ms:.2f} ms, "
          f"{100 * ms / p50_ms:.1f}% of the step p50; bound {bound:.2f} ms "
          f"({moved / 1e9:.1f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
          f"params read and written, grads read, m and v read and "
          f"written), {bound / ms:.2f} of it")
    return {"ms": ms, "share": ms / p50_ms, "bound_ms": bound,
            "bytes": moved}


def train_full(dev) -> dict:
    """(a) gemma-2b at full width and depth, bf16, through the launcher
    (``repro_torch.launch.train.main``: batch 8, seq 128, AdamW, lr 1e-3
    with warm-up 10, clip 1.0, remat on) for TRAIN_STEPS steps; then the
    gradient gate at the trained weights, a profile of steps through
    ``make_train_step`` and the optimizer timed alone."""
    cfg = get_config(ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reg = obs_metrics.enable()
    try:
        ranks, hist = launch_train.main(["--arch", ARCH, "--steps",
                                         str(TRAIN_STEPS)])
        params = ranks.pop()["params"]
        wall_us = reg.histogram("train/step/wall_us").summary()
    finally:
        obs_metrics.disable()
    peak = torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{ARCH} training: {len(hist)} steps, losses "
                             f"{losses}")
    steady = np.asarray([h["dt"] for h in hist[1:]]) * 1e3
    p50, p99 = (float(np.percentile(steady, q)) for q in (50, 99))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.param_count()
    print(f"  (a) {ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv} of {cfg.hd}, {cfg.ffn} d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {n:,} parameters, {cfg.dtype}, "
          f"remat {cfg.remat}; {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ} through launch.train.main")
    for h in hist:
        print(f"      step {h['step']}: loss {h['loss']:.4f}, "
              f"{h['dt'] * 1e3:.1f} ms")
    print(f"      peak memory {peak / 1e9:.2f} GB above the "
          f"{base / 1e9:.2f} GB held before (max_memory_allocated); steps "
          f"1..{TRAIN_STEPS - 1}: wall p50 {p50:.1f} ms, p99 {p99:.1f} ms, "
          f"{tokens / p50 * 1e3:.0f} tokens/s at p50; the first step (set-up "
          f"included) {hist[0]['dt'] * 1e3:.1f} ms; train/step/wall_us "
          f"histogram {wall_us}")
    gn = grad_gate(cfg, params, dev)
    print(f"      gradients at the trained weights: every leaf finite, "
          f"global norm {gn:.4f}")
    step_fn, opt = make_train_step(
        lambda p, b: LM.forward_loss(p, b, cfg), TrainConfig(lr=TRAIN_LR),
        linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    state = opt.init(params)
    task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             task.batch(0, TRAIN_BATCH, TRAIN_SEQ).items()}
    step = torch.tensor(0, dtype=torch.int32)
    prof = step_profile(f"{ARCH}, bf16, one batch", lambda: step_fn(
        params, state, None, None, batch, step), n=3, what="training-step")
    del state, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    opt_t = optimizer_timing(params, p50)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": [h["dt"] * 1e3 for h in hist],
            "step_p50_ms": p50, "step_p99_ms": p99,
            "tokens_per_s": tokens / p50 * 1e3, "peak_gb": peak / 1e9,
            "grad_norm": gn, "kernels_per_step": prof["kernels_per_step"],
            "busy_share": prof["busy_share"],
            "device_ms_per_step": prof["busy_us"] / 1e3,
            "optimizer_ms": opt_t["ms"], "optimizer_share": opt_t["share"],
            "optimizer_bound_ms": opt_t["bound_ms"]}


def _ffn_specs(params, spec) -> dict:
    specs = {k: None for k in params if k != "layers"}
    specs["layers"] = [
        {"norm1": None, "norm2": None,
         "mixer": {k: None for k in lp["mixer"]},
         "ffn": {k: spec for k in ("w_gate", "w_up", "w_down")}}
        for lp in params["layers"]]
    return specs


def train_admm(dev) -> dict:
    """(b) ADMM-CSB on gemma-2b's FFN at full width, depth cut to
    ADMM_LAYERS: ``train`` with the penalty, ``admm_update`` every
    ADMM_TRAIN_EVERY steps and ``admm_finalize``; then each finalized
    matrix frozen (``CSBLinear(transposed=True)``) and one batch's FFN
    inputs through ``csb_dense`` into B1, against the masked-dense
    product."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=ADMM_LAYERS)
    params = LM.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    specs = _ffn_specs(params, LM_FFN_SPEC)
    task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
    batches = sharded_batches(lm_batch_iterator(task, TRAIN_BATCH,
                                                TRAIN_SEQ), device=dev)
    tcfg = TrainConfig(lr=TRAIN_LR, steps=ADMM_TRAIN_STEPS,
                       admm_every=ADMM_TRAIN_EVERY, log_every=10 ** 9)
    t0 = time.perf_counter()
    params, hist = train(lambda p, b: LM.forward_loss(p, b, cfg), params,
                         batches, tcfg, lr_schedule=linear_warmup_cosine(
                             TRAIN_LR, TRAIN_WARMUP, ADMM_TRAIN_STEPS),
                         csb_specs=specs, log=lambda *_: None)
    secs = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    bound = 1 - LM_FFN_SPEC.prune_rate + DENSITY_ALLOWANCE
    dens = {f"{i}.{k}": float(density(lp["ffn"][k]))
            for i, lp in enumerate(params["layers"])
            for k in ("w_gate", "w_up", "w_down")}
    if len(hist) != ADMM_TRAIN_STEPS or not all(map(math.isfinite, losses)) \
            or max(dens.values()) > bound:
        raise AssertionError(f"ADMM on {ARCH}'s FFN: losses {losses}, "
                             f"densities {dens} (bound {bound})")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in
             task.batch(ADMM_TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ).items()}
    tol = TOL[torch.bfloat16]
    err, start = 0.0, csb_mvm.LAUNCHES
    with torch.no_grad():
        x = LM.embed_tokens(params, batch["tokens"], cfg)
        for i, lp in enumerate(params["layers"]):
            x = x + LM.L.attn_apply(lp["mixer"],
                                    LM.L.rmsnorm(x, lp["norm1"]), cfg)
            h = LM.L.rmsnorm(x, lp["norm2"])
            ins = {"w_gate": h, "w_up": h}
            outs = {}
            for k in ("w_gate", "w_up", "w_down"):
                w = lp["ffn"][k]
                if k == "w_down":
                    ins[k] = F.gelu(outs["w_gate"], approximate="tanh") \
                        * outs["w_up"]
                frozen = CSBLinear(w, LM_FFN_SPEC, mode="masked",
                                   transposed=True).freeze()
                if not torch.equal(densify(frozen._packed), w.T):
                    raise AssertionError(f"layer {i} {k}: the packing does "
                                         f"not hold the finalized weight")
                y = csb_dense(ins[k], frozen)
                ref = ins[k].float() @ w.float()
                e = float((y.float() - ref).abs().max())
                if not torch.allclose(y.float(), ref, rtol=tol, atol=tol):
                    raise AssertionError(f"layer {i} {k}: B1 {e:.3e} from "
                                         f"the masked-dense product (tol "
                                         f"{tol})")
                err = max(err, e)
                outs[k] = y
            x = x + outs["w_down"]
    launches = csb_mvm.LAUNCHES - start
    if launches != 3 * ADMM_LAYERS:
        raise AssertionError(f"B1 launched {launches} times for "
                             f"{3 * ADMM_LAYERS} FFN products")
    print(f"  (b) ADMM-CSB on {ARCH}'s FFN (w_gate, w_up, w_down) at "
          f"{LM_FFN_SPEC}, full width, depth cut to {ADMM_LAYERS} layers: "
          f"{ADMM_TRAIN_STEPS} steps, admm_update every {ADMM_TRAIN_EVERY}, "
          f"finalized ({secs:.1f} s); losses {[round(v, 4) for v in losses]}")
    print(f"      densities {dens} (bound {bound:.2f}: the keep fraction "
          f"{1 - LM_FFN_SPEC.prune_rate:.2f} + {DENSITY_ALLOWANCE}, "
          f"tests/test_train.py:76's cross-point allowance)")
    print(f"      one batch ({TRAIN_BATCH} x {TRAIN_SEQ} tokens, bf16) "
          f"through csb_dense: B1 launched {launches} times, max abs err "
          f"{err:.3e} from the masked-dense product (tol {tol}, phase 3's "
          f"bf16 bound)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "densities": dens, "density_bound": bound,
            "b1_launches": launches, "max_abs_err": err}


def _copy(params, dev) -> dict:
    return _tree(params, lambda t: t.detach().to(dev).clone())


def _reduced_run(cfg, params, dev, steps, ckpt_dir=None):
    task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
    tcfg = TrainConfig(lr=TRAIN_LR, steps=steps, ckpt_dir=ckpt_dir,
                       ckpt_every=2, log_every=10 ** 9)
    return train(lambda p, b: LM.forward_loss(p, b, cfg),
                 _copy(params, dev),
                 lm_batch_iterator(task, TRAIN_BATCH, TRAIN_SEQ), tcfg,
                 log=lambda *_: None)


def resume_gate(cfg, params, dev) -> str:
    """4 steps with checkpoints every 2, then a fresh ``train`` on that
    directory to step 6: its params equal an uninterrupted 6-step run's.
    Bit-equal under ``torch.use_deterministic_algorithms(True)``."""
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="ckpt-") as ck:
            ref, _ = _reduced_run(cfg, params, dev, 6)
            _reduced_run(cfg, params, dev, 4, ck)
            got, hist = _reduced_run(cfg, params, dev, 6, ck)
    finally:
        torch.use_deterministic_algorithms(False)
    diff = max(float((a - b).abs().max())
               for a, b in zip(_flat(ref), _flat(got)))
    if [h["step"] for h in hist] != [4, 5] or diff != 0.0:
        raise AssertionError(f"resume: steps {[h['step'] for h in hist]}, "
                             f"params {diff:.3e} from the uninterrupted run")
    return "bit-equal"


def train_reduced(dev) -> dict:
    """(c) ``get_reduced(gemma-2b)`` (fp32) trained REDUCED_STEPS steps on
    the card and on the CPU from the same weights (made on the CPU from a
    generator seeded 0 and copied) on the same numpy batches; then the
    resume gate on the card."""
    cfg = get_reduced(ARCH)
    params = LM.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    runs = {d: _reduced_run(cfg, params, d, REDUCED_STEPS)[1]
            for d in ("cpu", dev)}
    diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(runs["cpu"],
                                                        runs[dev])]
    if len(diffs) != REDUCED_STEPS or max(diffs) > REDUCED_LOSS_TOL:
        raise AssertionError(f"reduced {ARCH}: card vs CPU losses differ "
                             f"by {diffs} (bound {REDUCED_LOSS_TOL})")
    resumed = resume_gate(cfg, params, dev)
    print(f"  (c) reduced {ARCH} (fp32, {cfg.param_count():,} params), "
          f"{REDUCED_STEPS} steps on the card and on the CPU: losses "
          f"{[round(h['loss'], 6) for h in runs[dev]]}, largest difference "
          f"{max(diffs):.3e} (bound {REDUCED_LOSS_TOL}); resume (4 steps "
          f"with checkpoints every 2, a fresh train to 6) against 6 "
          f"uninterrupted steps: {resumed} (deterministic algorithms, "
          f"CUBLAS_WORKSPACE_CONFIG="
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')})")
    return {"loss_diffs": diffs, "resume": resumed}


def train_phase(dev) -> dict:
    """Training on the card: (a) gemma-2b at full width and depth through
    the launcher, (b) ADMM-CSB on its FFN then B1, (c) card against CPU
    at the reduced size and the resume gate. B1's launch count is read
    around (b)'s products; (a) and (c) launch no kernel of the port."""
    print(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    start = (csb_mvm.LAUNCHES, paged_attn.LAUNCHES, csb_sharded.LAUNCHES)
    t = [time.perf_counter()]
    full = train_full(dev)
    t.append(time.perf_counter())
    after_a = (csb_mvm.LAUNCHES, paged_attn.LAUNCHES, csb_sharded.LAUNCHES)
    admm = train_admm(dev)
    t.append(time.perf_counter())
    red = train_reduced(dev)
    t.append(time.perf_counter())
    end = (csb_mvm.LAUNCHES, paged_attn.LAUNCHES, csb_sharded.LAUNCHES)
    if after_a != start or end != (after_a[0] + admm["b1_launches"],
                                   *after_a[1:]):
        raise AssertionError(f"kernel launches (B1, B2, B3) in the train "
                             f"phase: {start} -> {after_a} -> {end}")
    secs = [b - a for a, b in zip(t, t[1:])]
    print(f"  train phase: (a) {secs[0]:.1f} s, (b) {secs[1]:.1f} s, (c) "
          f"{secs[2]:.1f} s; B1 launched {admm['b1_launches']} times, B2 "
          f"and B3 none")
    out = {"full": full, "admm": admm, "reduced": red, "part_s": secs}
    print(json.dumps({"train": out}))
    return out


# ---------------------------------------------------------------------------
# Training on a mesh ([phase mesh-train]): the dense placements, ranks
# sharing the one card over gloo; item 25's features on one card
# ---------------------------------------------------------------------------

def _p50(hist) -> float:
    return float(np.percentile([h["dt"] for h in hist[1:]], 50)) * 1e3


def mesh_full(one_card: list[float]) -> dict:
    """(a) gemma-2b at full width and depth, bf16, through
    ``launch.train.main(["--mesh", "1x2"])``: two ranks on the one card,
    tensor-parallel over "model". Every loss finite and each within
    MESH_LOSS_RTOL of [phase train] (a)'s at the same step."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ranks, hist = launch_train.main(["--arch", ARCH, "--mesh", MESH_FULL,
                                     "--steps", str(MESH_STEPS)])
    secs = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, one_card)]
    if len(hist) != MESH_STEPS or not all(map(math.isfinite, losses)) \
            or max(rel) > MESH_LOSS_RTOL:
        raise AssertionError(f"{ARCH} on a {MESH_FULL} mesh: losses "
                             f"{losses}, relative to one card's "
                             f"{one_card[:MESH_STEPS]}: {rel} (bound "
                             f"{MESH_LOSS_RTOL})")
    per_rank = []
    for r, res in enumerate(ranks):
        if [h["loss"] for h in res["history"]] != losses:
            raise AssertionError(f"rank {r}'s losses differ from rank 0's")
        per_rank.append({"peak_gb": res["peak_bytes"] / 1e9,
                         "step_p50_ms": _p50(res["history"]),
                         "step_ms": [h["dt"] * 1e3 for h in res["history"]],
                         "collectives_step0": res["collectives_step0"]})
    print(f"  (a) {ARCH}, full width and depth, bf16, AdamW, "
          f"{MESH_STEPS} steps through launch.train.main(--mesh "
          f"{MESH_FULL}): two ranks sharing this card ({card_line()}), gloo "
          f"(host-staged collectives), not a multi-GPU number; {secs:.1f} s "
          f"with the ranks' boot; the parent holds {held / 1e9:.2f} GB")
    print(f"      losses {losses}; relative to one card's at each step "
          f"{[f'{v:.3e}' for v in rel]} (bound {MESH_LOSS_RTOL})")
    for r, pr in enumerate(per_rank):
        n = sum(pr["collectives_step0"].values())
        print(f"      rank {r}: peak {pr['peak_gb']:.2f} GB; steps "
              f"1..{MESH_STEPS - 1} wall p50 {pr['step_p50_ms']:.1f} ms "
              f"({[round(v, 1) for v in pr['step_ms']]} ms); {n} "
              f"collectives in step 0: {pr['collectives_step0']}")
    return {"losses": losses, "rel": rel, "ranks": per_rank, "secs": secs}


def train_state(mesh=None) -> dict:
    """gemma-2b at full width and MESH_STATE_LAYERS layers, bf16, from
    the launcher's seeded init and batch stream: MESH_STATE_STEPS steps
    of the loop's step (AdamW, the launcher's schedule), on one card or,
    given a mesh, placed and ruled as the launcher places it. Per tensor
    of the params (in their order): the norms of AdamW's m and v and of
    the params' change."""
    from repro_torch._device import resolve_device
    from repro_torch.dist.api import place_tree, whole
    from repro_torch.dist.rules import (
        ShardingPolicy, activation_rules, batch_specs, param_specs,
    )
    from repro_torch.launch.shardspec import to_named
    cfg = dataclasses.replace(get_config(ARCH), n_layers=MESH_STATE_LAYERS)
    dev = resolve_device(None if mesh is None else mesh.device_type)
    rules = bspecs = None
    if mesh is not None:
        policy = ShardingPolicy()
        rules = activation_rules(cfg, mesh, policy, global_batch=TRAIN_BATCH)
    with use_rules(rules):
        params = LM.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                dev)
        if mesh is not None:
            params = place_tree(params, to_named(
                mesh, param_specs(cfg, params, mesh, policy)))
            bspecs = batch_specs(cfg, "train", mesh,
                                 global_batch=TRAIN_BATCH)
        start = [t.clone() for t in _flat(params)]
        step_fn, opt = make_train_step(
            lambda p, b: LM.forward_loss(p, b, cfg), TrainConfig(lr=TRAIN_LR),
            linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, MESH_STEPS))
        state = opt.init(params)
        task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
        batches = sharded_batches(itertools.islice(lm_batch_iterator(
            task, TRAIN_BATCH, TRAIN_SEQ), MESH_STATE_STEPS), mesh, bspecs,
            device=dev)
        for step, batch in batches:
            params, state, *_ = step_fn(params, state, None, None, batch,
                                        torch.tensor(step, dtype=torch.int32))

        def norm(t):
            return float(whole(t.float().square().sum()).sqrt())
        return {"m": [norm(t) for t in _flat(state.inner["m"])],
                "v": [norm(t) for t in _flat(state.inner["v"])],
                "update": [norm(t - t0) for t, t0 in
                           zip(_flat(params), start)]}


def state_gap(got: dict, want: dict) -> dict:
    """Per statistic of :func:`train_state`, the largest relative gap
    of ``got``'s norms from ``want``'s over the tensors."""
    return {k: max(abs(a - b) / b if b else abs(a)
                   for a, b in zip(got[k], want[k])) for k in want}


def mesh_state() -> dict:
    """(a)'s state check: :func:`train_state` on one card and on the
    MESH_FULL mesh, each tensor's norms within MESH_STATE_RTOL."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = train_state()
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn_ranks(train_state, launch_train.make_mesh(MESH_FULL)[0],
                        timeout_s=SHARD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for r, res in enumerate(ranks[1:], 1):
        if res != ranks[0]:
            raise AssertionError(f"rank {r}'s optimizer state differs "
                                 f"from rank 0's")
    gap = state_gap(ranks[0], one)
    if max(gap.values()) > MESH_STATE_RTOL:
        raise AssertionError(f"{ARCH} ({MESH_STATE_LAYERS} layers) on a "
                             f"{MESH_FULL} mesh: AdamW's state and update "
                             f"{gap} from one card's (bound "
                             f"{MESH_STATE_RTOL})")
    print(f"      state check: {ARCH} at full width, {MESH_STATE_LAYERS} "
          f"layers, {MESH_STATE_STEPS} steps on one card and on "
          f"{MESH_FULL} ({secs:.1f} s): the largest relative gap over "
          f"{len(one['m'])} tensors of the norms of AdamW's m "
          f"{gap['m']:.3e}, v {gap['v']:.3e}, the params' change "
          f"{gap['update']:.3e} (bound {MESH_STATE_RTOL})")
    return {"gap": gap, "secs": secs}


def mesh_reduced_rank(mesh, cases) -> list:
    """One rank of (b): each (arch, TrainConfig overrides, CPU params)
    trained as the launcher does on its mesh; the losses."""
    from repro_torch._device import resolve_device
    from repro_torch.dist.api import place_tree
    from repro_torch.dist.rules import (
        ShardingPolicy, activation_rules, batch_specs, param_specs,
    )
    from repro_torch.launch.shardspec import to_named
    out = []
    for arch, over, params in cases:
        cfg = get_reduced(arch)
        policy = ShardingPolicy()
        rules = activation_rules(cfg, mesh, policy, global_batch=TRAIN_BATCH)
        task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
        with use_rules(rules):
            p = _copy(params, resolve_device(mesh.device_type))
            p = place_tree(p, to_named(mesh, param_specs(cfg, p, mesh,
                                                         policy)))
            batches = sharded_batches(
                lm_batch_iterator(task, TRAIN_BATCH, TRAIN_SEQ), mesh,
                batch_specs(cfg, "train", mesh, global_batch=TRAIN_BATCH))
            tcfg = TrainConfig(lr=TRAIN_LR, steps=REDUCED_STEPS,
                               log_every=10 ** 9, **over)
            _, hist = train(lambda q, b: LM.forward_loss(q, b, cfg), p,
                            batches, tcfg, log=lambda *_: None)
        out.append([h["loss"] for h in hist])
    return out


def _cpu_losses(arch, over, params) -> list:
    cfg = get_reduced(arch)
    task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
    tcfg = TrainConfig(lr=TRAIN_LR, steps=REDUCED_STEPS, log_every=10 ** 9,
                       **over)
    _, hist = train(lambda q, b: LM.forward_loss(q, b, cfg),
                    _copy(params, "cpu"),
                    lm_batch_iterator(task, TRAIN_BATCH, TRAIN_SEQ), tcfg,
                    log=lambda *_: None)
    return [h["loss"] for h in hist]


def mesh_reduced() -> dict:
    """(b) reduced configs (fp32) on 2x1, 1x2 and 2x1x2 meshes of ranks
    sharing the card, each against the port's unsharded CPU run from the
    same weights (made on the CPU, seeded) and batches, at [phase train]
    (c)'s bound."""
    params = {a: LM.init_params(get_reduced(a),
                                torch.Generator().manual_seed(SEED), "cpu")
              for a in {a for cs in MESH_REDUCED.values() for a, _ in cs}}
    cpu, out = {}, {}
    for shape, cases in MESH_REDUCED.items():
        t0 = time.perf_counter()
        got = spawn_ranks(mesh_reduced_rank, shape,
                          [(a, o, params[a]) for a, o in cases],
                          timeout_s=SHARD_TIMEOUT_S)
        secs = time.perf_counter() - t0
        name = "x".join(map(str, shape))
        for i, (arch, over) in enumerate(cases):
            key = (arch, tuple(sorted(over.items())))
            if key not in cpu:
                cpu[key] = _cpu_losses(arch, over, params[arch])
            diffs = [abs(a - b) for a, b in zip(got[0][i], cpu[key])]
            same = all(g[i] == got[0][i] for g in got)
            what = f"{arch}{' ' + str(over) if over else ''} on {name}"
            if len(diffs) != REDUCED_STEPS or max(diffs) > REDUCED_LOSS_TOL \
                    or not same:
                raise AssertionError(f"(b) {what}: card vs CPU losses "
                                     f"{diffs} (bound {REDUCED_LOSS_TOL}), "
                                     f"ranks alike {same}")
            out[what] = max(diffs)
            print(f"  (b) {what} ({len(got)} ranks): losses "
                  f"{[round(v, 6) for v in got[0][i]]}, {max(diffs):.3e} "
                  f"from the CPU's (bound {REDUCED_LOSS_TOL})")
        print(f"      {name}: {secs:.1f} s with the ranks' boot")
    return out


def feature_timing(name, params) -> float | None:
    """The optimizer's update alone (Adafactor), or the compression's
    wire stage alone (compress + decompress), on gradients of ones x 1e-3
    at the trained weights: CUDA events, median of OPT_TIMING_REPS."""
    from repro_torch.dist.compress import compress, compress_init, decompress
    grads = _tree(params, lambda t: torch.full_like(t, 1e-3))
    if name == "adafactor":
        opt = get_optimizer("adafactor")
        state = opt.init(params)
        fn = lambda: opt.update(grads, state, params, 1e-9)  # noqa: E731
    elif name == "int8":
        res = compress_init(params)
        fn = lambda: decompress(compress(grads, res)[0])  # noqa: E731
    else:
        return None
    ms = median_ms(fn, reps=OPT_TIMING_REPS, warm=1)
    del grads, fn
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def features_full(dev) -> dict:
    """(c) item 25 at gemma-2b's full width on one card, at full depth
    but where FEATURE_LAYERS cuts it: Adafactor, int8 compression and
    two microbatches, each MESH_STEPS steps of the launcher's loop;
    losses finite; peak memory, step wall and the update's (or the wire
    stage's) ms."""
    out = {}
    for name, over in FEATURES.items():
        cfg = get_config(ARCH)
        if name in FEATURE_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=FEATURE_LAYERS[name])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params = LM.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                dev)
        task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
        tcfg = TrainConfig(lr=TRAIN_LR, steps=MESH_STEPS, log_every=10 ** 9,
                           **over)
        params, hist = train(
            lambda q, b: LM.forward_loss(q, b, cfg), params,
            sharded_batches(lm_batch_iterator(task, TRAIN_BATCH, TRAIN_SEQ),
                            device=dev), tcfg,
            lr_schedule=linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP,
                                             MESH_STEPS),
            log=lambda *_: None)
        peak = torch.cuda.max_memory_allocated() - base
        losses = [h["loss"] for h in hist]
        if len(hist) != MESH_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"(c) {ARCH} {name}: losses {losses}")
        ms = feature_timing(name, params)
        out[name] = {"losses": losses, "peak_gb": peak / 1e9,
                     "layers": cfg.n_layers,
                     "step_p50_ms": _p50(hist),
                     "step_ms": [h["dt"] * 1e3 for h in hist], "ms": ms}
        what = {"adafactor": "Adafactor's update alone",
                "int8": "compress + decompress alone"}.get(name)
        print(f"  (c) {ARCH} full width, {cfg.n_layers} layers, {name} "
              f"({over}), {MESH_STEPS} steps on one card: losses {[round(v, 4) for v in losses]}; "
              f"peak {peak / 1e9:.2f} GB; steps 1..{MESH_STEPS - 1} wall "
              f"p50 {out[name]['step_p50_ms']:.1f} ms"
              + (f"; {what} {ms:.2f} ms" if what else ""))
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def features_reduced(dev) -> dict:
    """(c) item 25 at the reduced width: each feature trained on the card
    and on the CPU from the same weights and batches, [phase train] (c)'s
    bound."""
    cfg = get_reduced(ARCH)
    params = LM.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    out = {}
    for name, over in FEATURES.items():
        task = CharLMTask(vocab=min(cfg.vocab, 256), seed=0)
        runs = {}
        for d in ("cpu", dev):
            tcfg = TrainConfig(lr=TRAIN_LR, steps=REDUCED_STEPS,
                               log_every=10 ** 9, **over)
            _, hist = train(lambda q, b: LM.forward_loss(q, b, cfg),
                            _copy(params, d),
                            lm_batch_iterator(task, TRAIN_BATCH, TRAIN_SEQ),
                            tcfg, log=lambda *_: None)
            runs[str(d)] = [h["loss"] for h in hist]
        diffs = [abs(a - b) for a, b in zip(runs["cpu"], runs[str(dev)])]
        if len(diffs) != REDUCED_STEPS or max(diffs) > REDUCED_LOSS_TOL:
            raise AssertionError(f"(c) reduced {ARCH} {name}: card vs CPU "
                                 f"{diffs} (bound {REDUCED_LOSS_TOL})")
        out[name] = max(diffs)
        print(f"  (c) reduced {ARCH}, {name}: card {max(diffs):.3e} from "
              f"the CPU over {REDUCED_STEPS} steps (bound "
              f"{REDUCED_LOSS_TOL})")
    return out


def mesh_train_phase(dev, one_card: list[float]) -> dict:
    """Training on the dense placements: (a) gemma-2b at full width on a
    1x2 mesh through the launcher, (b) reduced meshes against the CPU,
    (c) Adafactor, compression and microbatches on one card. No kernel of
    the port runs here (its launch counts must not move)."""
    start = (csb_mvm.LAUNCHES, paged_attn.LAUNCHES, csb_sharded.LAUNCHES)
    t = [time.perf_counter()]
    full = mesh_full(one_card)
    full["state"] = mesh_state()
    t.append(time.perf_counter())
    red = mesh_reduced()
    t.append(time.perf_counter())
    feats = features_full(dev)
    feats_red = features_reduced(dev)
    t.append(time.perf_counter())
    end = (csb_mvm.LAUNCHES, paged_attn.LAUNCHES, csb_sharded.LAUNCHES)
    if end != start:
        raise AssertionError(f"kernel launches (B1, B2, B3) in the "
                             f"mesh-train phase: {start} -> {end}")
    secs = [b - a for a, b in zip(t, t[1:])]
    print(f"  mesh-train phase: (a) {secs[0]:.1f} s, (b) {secs[1]:.1f} s, "
          f"(c) {secs[2]:.1f} s; card {card_line()}")
    out = {"full": full, "reduced": red, "features": feats,
           "features_reduced": feats_red, "part_s": secs}
    print(json.dumps({"mesh_train": out}))
    return out


def ms_requests(vocab: int, prefix: bool = False) -> list:
    """[phase mesh-serve]'s short trace (MS_PROMPT_LENS), or its prefix
    trace: one MS_PREFIX_LEN-token prefix shared, distinct suffixes."""
    rng = np.random.default_rng(SEED + (8 if prefix else 7))
    if prefix:
        head = rng.integers(0, vocab, size=MS_PREFIX_LEN)
        toks = [np.concatenate([head, rng.integers(0, vocab, size=n)])
                for n in MS_SUFFIX_LENS]
    else:
        toks = [rng.integers(0, vocab, size=n) for n in MS_PROMPT_LENS]
    return [Request(rid=i, tokens=t, max_new_tokens=MS_MAX_NEW, arrival=a)
            for i, (t, a) in enumerate(zip(toks, MS_ARRIVALS))]


def ms_config(arch: str, layers: int | None, reduced: bool):
    cfg = get_reduced(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def ms_engine(path: str):
    """The EngineConfig of one path of [phase mesh-serve]."""
    kern = MS_ENGINE.replace(use_kernel=True)
    return {"kernel": kern, "gather": MS_ENGINE,
            "contiguous": MS_ENGINE.replace(paged=False),
            "prefix": kern.replace(prefix_cache=True),
            "speculative": kern.replace(speculative=True, spec_k=MS_SPEC_K,
                                        draft_prune_rate=0.0),
            "disagg": kern, "router": kern,
            "split": kern.replace(pool_pages=MS_SPLIT_POOL),
            "generate": EngineConfig(max_new_tokens=MS_MAX_NEW)}[path]


def ms_expected_launches(path: str, cfg, res) -> int:
    """B2's launches a rank makes on ``path``: 2 x layers x the run's
    single-query paged decode steps (the speculative verify step carries
    k + 1 queries and takes the gather path, as in JAX)."""
    if path in ("gather", "contiguous", "speculative", "generate"):
        return 0
    st = res.stats
    steps = (sum(r["decode_steps"] for r in st["per_replica"])
             if path == "router" else st["decode_steps"])
    return paged_attn.KERNELS_PER_CALL * cfg.n_layers * steps


def ms_serve(mesh, jobs: list) -> list:
    """:func:`ms_serve_one` for each (arch, layers, reduced, paths) of
    ``jobs`` in turn (one spawn of ranks serves them all)."""
    out = []
    for job in jobs:
        out.append(ms_serve_one(mesh, *job))
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def ms_serve_one(mesh, arch: str, layers: int | None, reduced: bool,
                 paths: tuple) -> dict:
    """Serve [phase mesh-serve]'s traces through each of ``paths`` on one
    device (``mesh`` None) or, on every rank, on ``mesh``; the weights
    from the same seeded generator on the same device type. Per path:
    the tokens, B2's launches (checked against the run's decode steps),
    the first decode step's logits, the decode steps' walls, the pools'
    placements and the bytes of split pools made whole; on a mesh also
    the collectives of one decode step by op, and the peak memory."""
    from repro_torch._device import resolve_device
    from repro_torch.models import layers as layer_mod
    dev = resolve_device(None if mesh is None else mesh.device_type)
    cfg = ms_config(arch, layers, reduced)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = LM.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    if mesh is not None:
        # placed once: every engine's runner takes placed params as they are
        params = serve_engine._Runner(params, cfg, mesh).params
    kw = {"device": dev} if mesh is None else {"device": dev, "mesh": mesh}
    reqs, px_reqs = ms_requests(cfg.vocab), ms_requests(cfg.vocab, True)
    prompts = np.random.default_rng(SEED + 9).integers(0, cfg.vocab,
                                                       size=MS_GEN_SHAPE)
    out = {}
    for path in paths:
        eng = ms_engine(path)
        rec = {"logits": None, "walls": [], "comm": None, "pools": []}
        layer_mod.POOL_GATHER.update(bytes=0, calls=0)
        paged_attn.LAUNCHES = 0
        t0 = time.perf_counter()
        with ms_spy(rec, mesh is not None and path == "kernel"):
            if path == "generate":
                res = generate(params, cfg, prompts, eng, **kw)
                tokens = res.cpu().numpy().tolist()
            else:
                trace = px_reqs if path == "prefix" else reqs
                if path == "disagg":
                    res = serve_disaggregated(params, cfg, trace, eng, **kw)
                elif path == "router":
                    res = Router(2, eng).serve(params, cfg, trace, **kw)
                else:
                    res = serve_continuous(params, cfg, trace, eng, **kw)
                tokens = {int(k): list(map(int, v))
                          for k, v in res.tokens.items()}
        secs = time.perf_counter() - t0
        launches = paged_attn.LAUNCHES
        want = (0 if path == "generate"
                else ms_expected_launches(path, cfg, res))
        if launches != want:
            raise AssertionError(f"{arch} {path}: paged_attn launched "
                                 f"{launches} kernels, expected {want}")
        walls = [w * 1e3 for w in rec["walls"][1:]]
        out[path] = {
            "tokens": tokens, "launches": launches, "secs": secs,
            "logits": rec["logits"], "comm": rec["comm"],
            "pools": rec["pools"],
            "gather_bytes": layer_mod.POOL_GATHER["bytes"],
            "paged_steps": len(rec["walls"]),
            "step_p50_ms": (float(np.percentile(walls, 50)) if walls
                            else None),
            "step_p99_ms": (float(np.percentile(walls, 99)) if walls
                            else None),
            "sharded": (res.stats.get("sharded") if path not in
                        ("generate", "router") else None),
            "prefix_hits": (res.stats.get("prefix_hits")
                            if path == "prefix" else None)}
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if dev.type == "cuda" else None)
    return out


@contextlib.contextmanager
def ms_spy(rec: dict, count_comm: bool):
    """For the engines' paged decode steps: each step's wall (the device
    synchronised on both sides), the first step's last-position logits
    over the model's vocab (not its padding columns), the collectives of
    the second step (``count_comm``); and the placements of every pool
    the runners place."""
    step_paged = serve_engine._Runner.step_paged
    place_cache = serve_engine._Runner.place_cache

    def sync(t):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def step(self, cache, tokens, *a, **kw):
        sync(tokens)
        t0 = time.perf_counter()
        if count_comm and rec["comm"] is None and len(rec["walls"]) == 1:
            from torch.distributed.tensor.debug import CommDebugMode
            mode = CommDebugMode()
            with mode:
                out = step_paged(self, cache, tokens, *a, **kw)
            rec["comm"] = {str(k).split(".")[-1]: v
                           for k, v in mode.get_comm_counts().items()}
        else:
            out = step_paged(self, cache, tokens, *a, **kw)
        sync(tokens)
        rec["walls"].append(time.perf_counter() - t0)
        if rec["logits"] is None:
            # the model's own vocab: its padded columns are -1e30
            rec["logits"] = out[0][:, -1, :self.cfg.vocab].float().cpu()
        return out

    def place(self, cache, paged=False):
        placed = place_cache(self, cache, paged=paged)
        if paged and self.mesh is not None:
            rec["pools"] += [str(tuple(t.placements))
                             for t in _leaves(placed)]
        return placed

    serve_engine._Runner.step_paged = step
    serve_engine._Runner.place_cache = place
    try:
        yield
    finally:
        serve_engine._Runner.step_paged = step_paged
        serve_engine._Runner.place_cache = place_cache


def ms_compare(what: str, one: dict, ranks: list, paths) -> dict:
    """Each path's tokens on every rank equal to one device's, B2's
    launches per rank equal to one device's (each already held to the
    run's decode steps), the first decode step's logits within
    MS_LOGIT_RTOL (relative to their largest magnitude)."""
    out = {}
    for path in paths:
        want = one[path]
        for r, res in enumerate(ranks):
            got = res[path]
            if got["tokens"] != want["tokens"]:
                raise AssertionError(f"{what} {path}: rank {r}'s tokens "
                                     f"{got['tokens']} != one device's "
                                     f"{want['tokens']}")
            if got["launches"] != want["launches"]:
                raise AssertionError(f"{what} {path}: rank {r} launched "
                                     f"B2 {got['launches']} times, one "
                                     f"device {want['launches']}")
            if got["sharded"] is False:
                raise AssertionError(f"{what} {path}: not sharded")
        rel = None
        if want["logits"] is not None:
            ref = want["logits"]
            rel = max(float((res[path]["logits"] - ref).abs().max()
                            / ref.abs().max()) for res in ranks)
            if rel > MS_LOGIT_RTOL:
                raise AssertionError(f"{what} {path}: first decode step's "
                                     f"logits {rel:.3e} from one device's "
                                     f"(bound {MS_LOGIT_RTOL})")
        r0 = ranks[0][path]
        out[path] = {"launches_per_rank": r0["launches"],
                     "one_card_secs": want["secs"],
                     "mesh_secs": [r[path]["secs"] for r in ranks],
                     "logit_rel": rel,
                     "one_card_step_p50_ms": want["step_p50_ms"],
                     "step_p50_ms": [r[path]["step_p50_ms"] for r in ranks],
                     "step_p99_ms": [r[path]["step_p99_ms"] for r in ranks],
                     "gather_bytes_per_step": (
                         r0["gather_bytes"] / max(r0["paged_steps"], 1)),
                     "pools": r0["pools"], "prefix_hits": r0["prefix_hits"]}
        print(f"  {what} {path}: tokens equal on {len(ranks)} ranks; B2 "
              f"{r0['launches']} launches a rank"
              + (f"; first step's logits {rel:.3e}" if rel is not None
                 else "")
              + f"; {want['secs']:.1f} s one card, "
              f"{max(out[path]['mesh_secs']):.1f} s on the mesh"
              + (f"; step p50 {want['step_p50_ms']:.1f} ms one card, "
                 f"{[round(v, 1) for v in out[path]['step_p50_ms']]} ms "
                 f"(p99 {[round(v, 1) for v in out[path]['step_p99_ms']]})"
                 if r0["paged_steps"] else ""))
    return out


def mesh_serve_phase(dev) -> dict:
    """LM serving on the dense placements over ranks sharing the card:
    (a) gemma-2b at full width (MS_LAYERS layers), fp32, on one card and
    on MS_MESH through every engine; (b) the pool split over "data" on
    MS_SPLIT_MESH through B2; (c) reduced deepseek-v2-236b and
    hymba-1.5b on MS_MESH through B2. Every path's tokens on every rank
    equal to one card's, B2's launches a rank equal to one card's (2 x
    layers x single-query paged steps), the first decode step's logits
    within MS_LOGIT_RTOL."""
    out, t = {}, [time.perf_counter()]
    paths = ("kernel", "gather", "contiguous", "prefix", "speculative",
             "disagg", "router", "generate")
    # (a) and (c) share one spawn of MS_MESH's ranks
    jobs = [(ARCH, MS_LAYERS, False, paths)] + [
        (arch, None, True, ("kernel",)) for arch in MS_REDUCED]
    gc.collect()
    torch.cuda.empty_cache()
    one_all = ms_serve(None, jobs)
    gc.collect()
    torch.cuda.empty_cache()
    ranks_all = spawn_ranks(ms_serve, MS_MESH, jobs, timeout_s=MS_TIMEOUT_S)
    one, ranks = one_all[0], [r[0] for r in ranks_all]
    cfg = ms_config(ARCH, MS_LAYERS, False)
    if cfg.n_layers < get_config(ARCH).n_layers:
        print(f"  (a) and (b): {ARCH}'s depth cut to {cfg.n_layers} of "
              f"{get_config(ARCH).n_layers} layers (the phase's time)")
    print(f"  (a) {ARCH} at full width, {cfg.n_layers} layers, fp32, "
          f"{len(MS_PROMPT_LENS)} requests (prompts {MS_PROMPT_LENS}, "
          f"{MS_MAX_NEW} new tokens, arrivals {MS_ARRIVALS}), "
          f"{MS_ENGINE.n_slots} slots, pages of {MS_ENGINE.page_size}; one "
          f"card, then {MS_MESH} (\"data\", \"model\"): two ranks sharing "
          f"this card ({card_line()}) over gloo, not a multi-GPU number")
    out["a"] = ms_compare(f"(a) {MS_MESH}", one, ranks, paths)
    out["a"]["peak_gb"] = [r["peak_gb"] for r in ranks]
    out["a"]["one_card_peak_gb"] = one["peak_gb"]
    out["a"]["decode_step_collectives"] = ranks[0]["kernel"]["comm"]
    print(f"      per-rank peak {out['a']['peak_gb']} GB (one card "
          f"{out['a']['one_card_peak_gb']} GB); one decode step's "
          f"collectives on rank 0: {ranks[0]['kernel']['comm']}")
    t.append(time.perf_counter())
    # (b) the pool split over "data": its placements asserted
    job_b = [(ARCH, MS_LAYERS, False, ("split",))]
    one_b = ms_serve(None, job_b)[0]
    gc.collect()
    torch.cuda.empty_cache()
    ranks_b = [r[0] for r in spawn_ranks(ms_serve, MS_SPLIT_MESH, job_b,
                                         timeout_s=MS_TIMEOUT_S)]
    for r, res in enumerate(ranks_b):
        pools = res["split"]["pools"]
        if not pools or any("Shard(dim=1)" not in p for p in pools):
            raise AssertionError(f"(b) rank {r}: the pools' placements "
                                 f"{pools}, not split on their page dim")
    print(f"  (b) {ARCH}, {MS_SPLIT_POOL} pages + the scratch page over "
          f"{MS_SPLIT_MESH}: pools placed {sorted(set(ranks_b[0]['split']['pools']))}")
    out["b"] = ms_compare(f"(b) {MS_SPLIT_MESH}", one_b, ranks_b, ("split",))
    print(f"      split pools made whole for B2 (as JAX does): "
          f"{out['b']['split']['gather_bytes_per_step'] / 1e6:.2f} MB a "
          f"decode step a rank")
    t.append(time.perf_counter())
    # (c) reduced MLA and hybrid through B2 (served in (a)'s spawn)
    out["c"] = {}
    for i, arch in enumerate(MS_REDUCED, start=1):
        out["c"][arch] = ms_compare(
            f"(c) reduced {arch} {MS_MESH}", one_all[i],
            [r[i] for r in ranks_all], ("kernel",))["kernel"]
    out["part_s"] = [b - a for a, b in zip(t, t[1:])]
    # B2's launches on one rank over (a), (b) and (c)
    out["launches"] = (sum(out["a"][p]["launches_per_rank"] for p in paths)
                       + out["b"]["split"]["launches_per_rank"]
                       + sum(v["launches_per_rank"]
                             for v in out["c"].values()))
    print(f"  mesh-serve phase: (a) with (c) {out['part_s'][0]:.1f} s, (b) "
          f"{out['part_s'][1]:.1f} s; card {card_line()}")
    print(json.dumps({"mesh_serve": out}))
    return out


# ---------------------------------------------------------------------------
# The launch tooling held to the card ([phase dryrun]) and paper
# Algorithm 1 ([phase progressive])
# ---------------------------------------------------------------------------

def dry_summary(label: str, rec: dict) -> str:
    rl, cost, coll = rec["roofline"], rec["cost"], rec["collectives"]
    return (f"{label}: peak {rec['memory']['peak_bytes_per_device'] / 1e9:.3f}"
            f" GB a device, {cost['flops_per_device']:.6e} FLOPs "
            f"({cost['dot_flops_per_device']:.6e} in products), "
            f"{cost['bytes_per_device']:.6e} bytes, collectives "
            f"{coll['count_by_op']} ({coll['total_bytes']:.6e} bytes); "
            f"roofline compute {rl['t_compute'] * 1e3:.4f} ms, memory "
            f"{rl['t_memory'] * 1e3:.4f} ms, collective "
            f"{rl['t_collective'] * 1e3:.4f} ms, dominant {rl['dominant']}; "
            f"traced in {rec['trace_s']} s")


def dry_run(arch, shape, layers=None, mesh_shape=None) -> dict:
    """``launch.dryrun.run_cell`` on fake ranks; raises unless ok."""
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell(arch, shape, save=False, mesh_shape=mesh_shape,
                   extra_over=None if layers is None
                   else {"n_layers": layers})
    if rec["status"] != "ok":
        print(rec.get("traceback", ""), file=sys.stderr)
        raise AssertionError(f"dry run of {arch} {shape} (layers "
                             f"{layers or 'all'}, mesh {rec['mesh']}): "
                             f"{rec['status']} {rec.get('error')}")
    return rec


def dry_real_step(mesh, arch, shape, layers, reps=0) -> dict:
    """The dry run's cell built by ``build_cell`` on ``mesh`` (real
    ranks, real tensors on the card) and stepped once under
    ``op_cost.OpCounter``: the peak memory above what was allocated
    before the cell was built (the peak reset after placement), the
    FLOPs and the collectives by op; with ``reps`` also the step's wall
    (CUDA events, median of ``reps``)."""
    from repro_torch.dist.api import use_rules as rules_scope
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.op_cost import count
    torch.manual_seed(SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    step_fn, args, rules, _ = build_cell(arch, shape, mesh,
                                         {"n_layers": layers})
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    with rules_scope(rules):
        _, c = count(step_fn, *args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    rec = {"peak_bytes": peak, "placed_bytes": placed,
           "counted_peak_bytes": c.peak_bytes, "flops": c.cost.flops,
           "dot_flops": c.cost.dot_flops, "bytes": c.cost.bytes,
           "coll_count": dict(c.cost.coll_count),
           "coll_bytes": dict(c.cost.coll_bytes)}
    if reps:
        def step():
            with rules_scope(rules):
                step_fn(*args)
        rec["wall_ms"] = median_ms(step, reps=reps, warm=1)
    del args
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def dry_mesh_rank(mesh, arch, shape, layers) -> dict:
    """(c) on every rank: :func:`dry_real_step` on this rank's card."""
    return dry_real_step(mesh, arch, shape, layers)


def attained_peaks(dev) -> dict:
    """(d): a bf16 DRY_MATMUL_N^3 ``torch.matmul`` in TFLOP/s and a
    DRY_COPY_BYTES device copy in GB/s (bytes read + written over the
    time), each beside the card's name and power limit."""
    n = DRY_MATMUL_N
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(n, n, generator=gen, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, generator=gen, device=dev, dtype=torch.bfloat16)
    mm_ms = median_ms(lambda: torch.matmul(a, b), reps=20, warm=3)
    del a, b
    src = torch.empty(DRY_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    cp_ms = median_ms(lambda: dst.copy_(src), reps=20, warm=3)
    del src, dst
    torch.cuda.empty_cache()
    from repro_torch.launch import roofline as RL
    out = {"matmul_tflops": 2 * n ** 3 / (mm_ms * 1e-3) / 1e12,
           "matmul_ms": mm_ms,
           "copy_gbps": 2 * DRY_COPY_BYTES / (cp_ms * 1e-3) / 1e9,
           "copy_ms": cp_ms, "card": card_line()}
    print(f"  (d) attained: bf16 {n}^3 matmul {out['matmul_tflops']:.1f} "
          f"TFLOP/s ({mm_ms:.3f} ms; roofline's peak "
          f"{RL.PEAK_FLOPS / 1e12:.0f}), {DRY_COPY_BYTES / 1e9:.0f} GB copy "
          f"{out['copy_gbps']:.1f} GB/s read + write ({cp_ms:.3f} ms; "
          f"roofline's HBM rate {RL.HBM_BW / 1e9:.0f}); card {out['card']}")
    return out


def dryrun_phase(dev) -> dict:
    """The dry run (``launch.dryrun``) held to the card. (a) DRY_CELLS
    over the fake 16x16 mesh under this card's torch; (b) gemma-2b
    decode_32k at DRY_REAL_LAYERS layers over a one-rank (1, 1) mesh:
    the dry run's estimate first (its fake group before the real one),
    then one real step, its peak within DRY_MEM_RTOL of the estimate,
    its FLOPs equal to the trace's and its wall at or above the
    roofline's largest term; (c) the same cell at DRY_MESH_LAYERS layers
    over 1x2, two ranks sharing the card over gloo: each rank's peak
    within DRY_MEM_RTOL of the 1x2 estimate, the collectives by op equal
    to the trace's; (d) attained peaks beside the roofline's constants."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    t = [time.perf_counter()]
    cells = {}
    for arch, shape, layers in DRY_CELLS:
        rec = dry_run(arch, shape, layers)
        key = f"{arch} {shape}" + (f" ({layers} layers)" if layers else "")
        print(f"  (a) {dry_summary(key, rec)}")
        cells[key] = {k: rec[k] for k in ("memory", "cost", "collectives",
                                          "roofline", "trace_s")}
    t.append(time.perf_counter())

    arch, shape = DRY_REAL
    est = dry_run(arch, shape, DRY_REAL_LAYERS, mesh_shape=(1, 1))
    print(f"  (b) estimate: {dry_summary(f'{arch} {shape} at {DRY_REAL_LAYERS} layers, 1x1', est)}")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        real = dry_real_step(mesh, arch, shape, DRY_REAL_LAYERS, reps=5)
    finally:
        dist.destroy_process_group()
    want = est["memory"]["peak_bytes_per_device"]
    rl = est["roofline"]
    top = max(rl["t_compute"], rl["t_memory"], rl["t_collective"])
    wall_s = real["wall_ms"] * 1e-3
    print(f"  (b) real step: peak {real['peak_bytes'] / 1e9:.3f} GB above "
          f"the base ({real['placed_bytes'] / 1e9:.3f} GB placed; the "
          f"counter's own {real['counted_peak_bytes'] / 1e9:.3f} GB) against "
          f"the estimate's {want / 1e9:.3f} GB ({real['peak_bytes'] / want:.4f}x; "
          f"bound {DRY_MEM_RTOL}); FLOPs {real['flops']:.6e} (trace "
          f"{est['cost']['flops_per_device']:.6e}); wall {real['wall_ms']:.3f} "
          f"ms (median of 5), roofline's largest term {top * 1e3:.3f} ms "
          f"({est['roofline']['dominant']}), wall / memory term "
          f"{wall_s / rl['t_memory']:.3f}")
    if abs(real["peak_bytes"] - want) > DRY_MEM_RTOL * want:
        raise AssertionError(f"(b) peak {real['peak_bytes']} bytes, the dry "
                             f"run estimated {want}")
    if real["flops"] != est["cost"]["flops_per_device"]:
        raise AssertionError(f"(b) the real step counted {real['flops']} "
                             f"FLOPs, the trace {est['cost']['flops_per_device']}")
    if wall_s < top:
        raise AssertionError(f"(b) wall {wall_s} s below the roofline's "
                             f"largest term {top} s")
    t.append(time.perf_counter())

    est2 = dry_run(arch, shape, DRY_MESH_LAYERS, mesh_shape=DRY_MESH)
    print(f"  (c) estimate: {dry_summary(f'{arch} {shape} at {DRY_MESH_LAYERS} layers, 1x2', est2)}")
    ranks = spawn_ranks(dry_mesh_rank, DRY_MESH, arch, shape,
                        DRY_MESH_LAYERS, timeout_s=MS_TIMEOUT_S)
    want2 = est2["memory"]["peak_bytes_per_device"]
    coll = {k: int(v) for k, v in est2["collectives"]["count_by_op"].items()}
    for r, got in enumerate(ranks):
        print(f"  (c) rank {r}: peak {got['peak_bytes'] / 1e9:.3f} GB "
              f"({got['peak_bytes'] / want2:.4f}x the estimate's "
              f"{want2 / 1e9:.3f} GB), collectives {got['coll_count']} "
              f"(trace {coll}), FLOPs {got['flops']:.6e} (trace "
              f"{est2['cost']['flops_per_device']:.6e})")
        if abs(got["peak_bytes"] - want2) > DRY_MEM_RTOL * want2:
            raise AssertionError(f"(c) rank {r} peak {got['peak_bytes']} "
                                 f"bytes, the dry run estimated {want2}")
        if {k: int(v) for k, v in got["coll_count"].items()} != coll:
            raise AssertionError(f"(c) rank {r} collectives "
                                 f"{got['coll_count']}, the trace {coll}")
    t.append(time.perf_counter())
    peaks = attained_peaks(dev)
    t.append(time.perf_counter())
    secs = [b - a for a, b in zip(t, t[1:])]
    print(f"  dryrun phase: (a) {secs[0]:.1f} s, (b) {secs[1]:.1f} s, (c) "
          f"{secs[2]:.1f} s, (d) {secs[3]:.1f} s; torch {torch.__version__}; "
          f"card {card_line()}")
    out = {"cells": cells,
           "real_1x1": {"estimate_peak_bytes": want,
                        "estimate_flops": est["cost"]["flops_per_device"],
                        "roofline": rl, **real},
           "real_1x2": {"estimate_peak_bytes": want2,
                        "estimate_coll_count": coll, "ranks": ranks},
           "attained": peaks, "part_s": secs}
    print(json.dumps({"dryrun": out}))
    return out


def progressive_phase(dev) -> dict:
    """``examples/prune_progressive_torch.py --fast`` on the card (paper
    Algorithm 1: a GRU of hidden 32 over vocab 16, 8x8 blocks), then the
    best lossless round's model (the last round's where none was
    lossless) frozen to ``PaddedCSB`` and evaluated on the same batches
    through B1: its accuracy must equal the masked-dense one."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import prune_progressive_torch as ex
    from repro_torch.train.classifier import nested_params
    res = ex.main(["--fast"])
    hist, ctl = res["history"], res["controller"]
    for rate, acc, ok in hist:
        print(f"  round: rate {rate:.4f}, accuracy {acc:.4f}, "
              f"{'lossless' if ok else 'over-pruned'}")
    best = [i for i, (rate, _, ok) in enumerate(hist)
            if ok and rate == ctl.best_lossless_rate]
    pick = best[-1] if best else len(hist) - 1
    rate, acc, _ = hist[pick]
    model = res["models"][pick]
    specs = ex.pruned_specs(model, rate)
    csb = dict(model)
    for k, spec in specs.items():
        if spec is not None:
            rm, cm = csb_masks(model[k], spec)
            csb[k] = padded_csb_from_dense(model[k], spec.bm, spec.bn,
                                           row_mask=rm, col_mask=cm,
                                           device=dev)
    task = SeqClassifyTask(vocab=16, n_classes=4, seq_len=12, seed=ex.SEED)
    cells = [res["cell"]]
    dense_acc = classifier_accuracy(cells, nested_params(model), task,
                                    start=200)
    start = csb_mvm.LAUNCHES
    csb_acc = classifier_accuracy(cells, nested_params(csb), task, start=200)
    launches = csb_mvm.LAUNCHES - start
    print(f"  best lossless rate {ctl.best_lossless_rate:.4f} "
          f"({ctl.best_compression:.2f}x); frozen: round {pick} (rate "
          f"{rate:.4f}, {'lossless' if best else 'none lossless: the last'})"
          f", masked-dense accuracy {dense_acc:.4f}, through B1 "
          f"{csb_acc:.4f} ({launches} B1 launches)")
    if dense_acc != acc or csb_acc != dense_acc or launches == 0:
        raise AssertionError(f"progressive: round accuracy {acc}, masked "
                             f"dense {dense_acc}, through B1 {csb_acc} "
                             f"({launches} launches)")
    out = {"rounds": [list(h) for h in hist],
           "best_lossless_rate": ctl.best_lossless_rate,
           "baseline": res["baseline"], "frozen_round": pick,
           "csb_accuracy": csb_acc, "launches": launches}
    print(json.dumps({"progressive": out}))
    return out


def serve_examples_phase(dev) -> dict:
    """``examples/serve_batched_torch.py`` and ``serve_router_torch.py``
    through their ``main([])`` on the card: each spawns a (2, 4) ("data",
    "model") mesh of eight ranks sharing this card over gloo, runs every
    part on every rank (each asserting what the JAX example asserts) and
    holds the ranks to one another. Then serve_batched's part 5 (an LSTM
    64 -> 128, 16x16 blocks at rate 0.9, 32 frames x batch 4): each rank's
    B3 launches, counted by the rank around the part, equal to (frames +
    warm-up) x the matrices it holds rows of, B1's 0; its outputs and final
    state bit-equal to the same call through B1 on this card with no mesh
    (B3 sums each output in B1's order, whatever the batch rows a rank
    gets)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import serve_batched_torch as sb
    import serve_router_torch as sr
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    b = sb.main([])
    r = sr.main([])
    ranks, r0 = b["ranks"], b["ranks"][0]
    st = {k: r0[k]["stats"] for k in (
        "paged", "contiguous", "budget_paged", "budget_contiguous",
        "shared_base", "shared", "speculative", "traced")}
    sp = st["speculative"]["speculative"]
    out["serve_batched"] = {
        "wall_s": b["wall_s"],
        **{f"{k}_tokens_per_sec": v["tokens_per_sec"] for k, v in st.items()},
        **{f"{k}_decode_steps": v["decode_steps"] for k, v in st.items()},
        "budget_peak_active": [st["budget_paged"]["peak_active"],
                               st["budget_contiguous"]["peak_active"]],
        "prefix_hits": st["shared"]["prefix_hits"],
        "prefill_tokens": [st["shared_base"]["prefill_tokens"],
                           st["shared"]["prefill_tokens"]],
        "spec_rounds": sp["rounds"], "spec_accepted": sp["accepted"],
        "generate_s": r0["generate"]["wall_s"],
        "us_per_frame": [g["frames"]["us_per_frame"] for g in ranks],
        "traced_steady_tokens_per_sec":
            st["traced"]["steady_tokens_per_sec"]}
    # part 5: B3's launches on each rank, counted around the part
    frames, cell = b["frames"], make_cell(*sb.CELL)
    mats = {k: w for k, w in b["cell"].items()
            if not isinstance(w, torch.Tensor)}
    n_model = sb.MESH[1]
    shards = {k: partition_padded(w, n_model)[1] for k, w in mats.items()}
    calls = frames.shape[0] + SE_WARMUP
    launches = [g["frames"]["b3_launches"] for g in ranks]
    for rank, g in enumerate(ranks):
        held = sum(len(s.row_map[rank % n_model]) > 0
                   for s in shards.values())
        if (g["frames"]["b3_launches"] != calls * held
                or g["frames"]["b1_launches"] != 0):
            raise AssertionError(
                f"serve_batched part 5 on rank {rank}: B3 launches "
                f"{g['frames']['b3_launches']}, B1 {g['frames']['b1_launches']}"
                f"; expected B3 {calls} calls x {held} matrices held, B1 0")
    # the same call through B1 on this card, no mesh
    per = frames.shape[1] // sb.MESH[0]
    start = csb_mvm.LAUNCHES
    ys, state, us_one = rnn_serve_frames(cell, b["cell"], frames, device=dev)
    b1 = csb_mvm.LAUNCHES - start
    got = r0["frames"]
    pairs = [(got["outputs"], ys.cpu(), "outputs")] + [
        (got["state"][k], v.cpu(), f"state {k}") for k, v in state.items()]
    err = max(float((a - c).abs().max()) for a, c, _ in pairs)
    for a, c, what in pairs:
        if not torch.equal(a, c):
            raise AssertionError(
                f"serve_batched part 5 {what}: the mesh's B3 "
                f"{float((a - c).abs().max()):.3e} from B1 on one card, "
                f"not bit-equal")
    if b1 != calls * len(mats):
        raise AssertionError(f"B1 on one card: {b1} launches, expected "
                             f"{calls * len(mats)}")
    out["frames"] = {
        "b3_launches_per_rank": launches, "expected_per_rank":
            calls * len(mats), "max_abs_err_vs_b1": err,
        "one_card_us_per_frame": us_one}
    print(f"  serve_batched: 8 ranks on a {sb.MESH} ('data', 'model') mesh "
          f"sharing this card ({card_line()}) over gloo, not a multi-GPU "
          f"number; wall {b['wall_s']:.1f} s")
    print(f"    paged {st['paged']['tokens_per_sec']:.1f} tok/s over "
          f"{st['paged']['decode_steps']} decode steps (contiguous "
          f"{st['contiguous']['tokens_per_sec']:.1f}); budget peak_active "
          f"paged/contiguous {out['serve_batched']['budget_peak_active']}; "
          f"prefix hits {st['shared']['prefix_hits']}, prefill tokens "
          f"{out['serve_batched']['prefill_tokens']}; speculative "
          f"{sp['rounds']} rounds, {sp['accepted']} accepted; generate "
          f"{r0['generate']['wall_s']:.2f} s; traced steady "
          f"{st['traced']['steady_tokens_per_sec']:.1f} tok/s")
    print(f"    part 5: B3 at R = {n_model} (batch {per} a rank over "
          f"'data' = {sb.MESH[0]}): {launches} launches a rank "
          f"({calls} calls x {len(mats)} matrices = {calls * len(mats)}), "
          f"B1 0; us/frame a rank {out['serve_batched']['us_per_frame']} "
          f"(eight ranks time-slicing the card; realtime bar "
          f"{sb.REALTIME_US:.0f} us), one card through B1 {us_one:.1f}; "
          f"outputs and state bit-equal to B1 on one card")
    rr = r["ranks"][0]
    out["serve_router"] = {
        "wall_s": r["wall_s"],
        "handoffs": rr["disagg"]["stats"]["handoffs"],
        "handoff_pages": rr["disagg"]["stats"]["handoff_pages"],
        "prefix_hits": rr["shared_disagg"]["stats"]["prefix_hits"],
        "replica_requests": rr["routed"]["stats"]["replica_requests"],
        **{f"{k}_tokens_per_sec": rr[k]["stats"]["tokens_per_sec"]
           for k in ("single", "disagg")},
        "simulate": {p: {"ttft_p99_us": v["ttft_us"]["p99"],
                         "slo_attainment": v["slo_attainment"]}
                     for p, v in r["simulate"].items()}}
    print(f"  serve_router: 8 ranks on {sr.MESH}, wall {r['wall_s']:.1f} s; "
          f"disagg {out['serve_router']['handoffs']} handoffs, prefix hits "
          f"{out['serve_router']['prefix_hits']}, router replica requests "
          f"{out['serve_router']['replica_requests']}")
    out["launches"] = launches[0]
    print(json.dumps({"serve_examples": out}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    # before cuBLAS starts: [phase train]'s resume gate runs under
    # torch.use_deterministic_algorithms, which needs a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    ffn = build_lm_ffn(dev)
    ffn_t = phase("B1 timing at gemma-2b's FFN", ffn_timing_phase, ffn)
    sb = phase("B1 at the serving batch", serving_batch_phase, dev, ffn)
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
    pp = phase("paper", paper_phase, dev, frames, sl, ffn)
    sh = phase("sharded", sharded_phase, dev, layers, frames, ffn)
    tr = phase("train", train_phase, dev)
    phase("mesh-train", mesh_train_phase, dev,
          tr["full"]["losses"][:MESH_STEPS])
    ms = phase("mesh-serve", mesh_serve_phase, dev)
    phase("dryrun", dryrun_phase, dev)
    pg = phase("progressive", progressive_phase, dev)
    se = phase("serve-examples", serve_examples_phase, dev)
    print(f"[total {time.perf_counter() - t_start:.1f} s]")
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": (sl["launches"] + pp["launches"]
                               + tr["admm"]["b1_launches"]
                               + pg["launches"]),
        "progressive_launches": pg["launches"],
        "max_abs_err": max(max_err, pp["lm_ffn"]["max_abs_err"]),
        "train_launches": tr["admm"]["b1_launches"],
        "train_max_abs_err": tr["admm"]["max_abs_err"],
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": tm["library_ms"], "device_ms": tm["device_ms"],
        "library_device_ms": tm["library_device_ms"],
        "graph_ms": tm["graph_ms"], "library_graph_ms": tm["library_graph_ms"],
        "us_per_frame": sl["us_per_frame"], "frame_p99_us": sl["p99_us"],
        "sr1_launches": sl["launches"], "paper_launches": pp["launches"],
        # [phase B1 at the serving batch]: the batch-tiled body
        "serving_batch": sb,
        # measured only: the engine's cycle model is printed, not kept here
        "paper": {
            "gru": {k: v for k, v in pp["gru"].items()
                    if not k.startswith("eff_")},
            "sr1": {k: v for k, v in pp["sr1"].items() if k != "matrices"}},
        **{f"lm_ffn_{k}": ffn[k] for k in (
            "freeze_s", "ctas", "launch_config", "compression")},
        **{f"lm_ffn_{k}": v for k, v in pp["lm_ffn"].items()},
        **{f"lm_ffn_{d}_{k}": ffn_t[d][k] for d in ("float32", "bfloat16")
           for k in ("ms", "device_ms", "graph_ms", "plain_ms", "bound_ms",
                     "padded_bound_ms", "bound_by", "library_ms",
                     "library_device_ms", "library_graph_ms")},
    }, {
        **PAGED_KERNEL,
        "launches": (lm_launches + gen_launches + px_launches
                     + dg["launches"] + rt["launches"] + ds["launches"]
                     + ssd["launches"] + ms["launches"]),
        # [phase mesh-serve]: B2's launches on one rank of each mesh
        "mesh_launches_per_rank": ms["launches"],
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
        **{f"internvl2_{k}": pt["internvl2"][k] for k in (
            "ms", "device_ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms",
            "library_graph_ms", "gather_sdpa_graph_ms", "sdpa_backend",
            "ctas")},
        "disagg": {**{k: dg[k] for k in (
            "launches", "decode_steps", "handoffs", "handoff_pages",
            "prefix_hits", "prefill_tokens_on", "prefill_tokens_off",
            "paged_bfloat16", "disagg_bfloat16")}, "router": rt},
        "frontends": fe,
    }, {
        **SHARDED_KERNEL, "launches": sh["launches"] + se["launches"],
        # [phase serve-examples]: serve_batched's part 5 on one rank
        "serve_examples_launches": se["launches"],
        "max_abs_err": sh["max_abs_err"], "ms": sh["sr1"]["ms"],
        "plain_ms": sh["sr1"]["plain_ms"], "bound_ms": sh["sr1"]["bound_ms"],
        "bound_by": sh["sr1"]["bound_by"],
        **{k: sh["sr1"][k] for k in (
            "b1_ms", "device_ms", "device_kernels_per_call", "b1_device_ms",
            "device_vs_b1", "graph_ms", "graph_note")},
        **{f"lm_ffn_{d}_{k}": v for d, r in sh["ffn"].items()
           for k, v in r.items()},
        **{k: sh[k] for k in (
            "b1_launches", "exchange_route", "us_per_frame_2_ranks",
            "frame_p99_us_2_ranks", "events_ms_per_call_2_ranks",
            "wall_ms_per_call_2_ranks", "loop_calls")},
        "imbalance": {r: {n: v[0] for n, v in plans.items()}
                      for r, plans in sh["plans"].items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step once,
on fake ranks, allocating nothing: the port of ``repro.launch.dryrun``.

For each cell this builds the full step (the train step, prefill, the
contiguous decode step), places params, optimizer state, batch and cache
on the production mesh as the JAX package places them (``param_specs``,
``batch_specs``, ``cache_specs``, ``activation_rules``,
``shape_overrides``), and runs it once, as rank 0 of a fake process group
of 256 (16 x 16) or 512 (2 x 16 x 16) ranks, under ``FakeTensorMode``:
tensors on ``cuda`` with shapes and no storage, collectives that return
at once. It needs no card. (A PyTorch built without CUDA refuses to
index a fake ``cuda`` tensor, in its Python binding's device guard:
there the fake tensors and the mesh are on the ``cpu``, the same shapes
and the same ops but the one MoE product that casts its operands first
on the CPU; the record's ``device`` says which.)
``launch.op_cost.OpCounter`` counts the step's ops, per device, and
records:

  - ``memory``   (argument/output/temp/alias bytes and the peak: does the
                  step fit one device?)
  - ``cost``     (per-device FLOPs and bytes, for the roofline)
  - ``collectives`` by op, with their operand bytes
  - the derived three-term roofline (``launch.roofline``, an H100's)

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
      --multi-pod
  python -m repro_torch.launch.dryrun --sweep            # all runnable cells
  python -m repro_torch.launch.dryrun --list             # the 40-cell grid

Records land in build/dryrun/<arch>__<shape>__<mesh>.json. A record has
the JAX record's keys but those of XLA alone: ``lower_s`` and
``compile_s`` (``trace_s`` is the one trace's wall time),
``memory.cpu_f32_convert_bytes`` and ``memory.peak_bytes_tpu_estimate``
(XLA:CPU's hoisted f32 converts, which an eager step does not allocate),
and ``cost.xla_flops_unrolled_once``/``xla_bytes_unrolled_once`` (XLA's
own ``cost_analysis``, which counts a loop body once).

Importing this module starts no process group: ``run_cell`` starts the
fake group and destroys it when it is done, so it must not run where a
default group is already up.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import (
    ARCH_IDS, all_cells, cell_is_runnable, get_config, shape_overrides,
    sharding_policy, train_microbatches,
)
from repro_torch.dist.api import NamedSharding, plain_as_replicated, use_rules
from repro_torch.dist.rules import (
    activation_rules, batch_specs, cache_specs, param_specs,
)
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.op_cost import count
from repro_torch.launch.roofline import Roofline, model_flops, roofline
from repro_torch.launch.shardspec import to_named
from repro_torch.models import abstract_params, forward_loss, prefill
from repro_torch.models import decode_step as model_decode_step
from repro_torch.models.config import SHAPES
from repro_torch.train.loop import TrainConfig, make_train_step

RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "build", "dryrun")

# the fake tensors' device (module docstring)
FAKE_DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _local_shape(shape, mesh, placements) -> tuple:
    """This rank's part of a tensor of ``shape`` under ``placements``
    (``torch.chunk``'s split, as DTensor's ``Shard``)."""
    local = list(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            d = pl.dim % len(shape)
            n = mesh.size(i)
            chunk = -(-local[d] // n)
            start = min(coord[i] * chunk, local[d])
            local[d] = min(local[d], start + chunk) - start
    return tuple(local)


def _placed_like(meta: torch.Tensor, sh: NamedSharding, device,
                 fill: str) -> torch.Tensor:
    """A DTensor of ``meta``'s global shape and dtype on ``sh``, whose
    local part alone is made, on ``device``: a fake tensor under
    ``FakeTensorMode``, else a real one filled as ``fill`` says
    ("zero", or "normal": N(0, 0.02) floats, zero integers)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(_local_shape(meta.shape, sh.mesh, sh.placements),
                        dtype=meta.dtype, device=device)
    if fill == "normal" and local.is_floating_point():
        local.normal_(0.0, 0.02)
    else:
        local.zero_()
    stride = tuple(torch.empty(meta.shape, device="meta").stride())
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=meta.shape, stride=stride)


def _place(tree, shardings, device, fill: str):
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k], device, fill)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(v, s, device, fill) for v, s in zip(tree, shardings)]
    return _placed_like(tree, shardings, device, fill)


def build_cell(arch: str, shape_name: str, mesh, extra_over=None,
               policy=None, micro: int | None = None, accum_dtype=None,
               device=None):
    """Returns (step_fn, args, rules, cfg): ``step_fn(*args)`` is the
    cell's step, run under ``use_rules(rules)``; ``args`` are placed on
    ``mesh`` as DTensors whose local parts are made on ``device`` (the
    mesh's card when None): fake tensors under ``FakeTensorMode``, real
    ones (params N(0, 0.02), caches and tokens zero) otherwise. The JAX
    package also returns ``in_shardings`` and the donated arguments: here
    the placements are the args' own, and the steps update the optimizer
    state, params and cache in place."""
    from repro_torch._device import resolve_device

    over = shape_overrides(arch, shape_name)
    over.update(extra_over or {})
    cfg = dataclasses.replace(get_config(arch), **over)
    shp = SHAPES[shape_name]
    policy = policy or sharding_policy(arch, shape_name)
    rules = activation_rules(cfg, mesh, policy,
                             global_batch=shp.global_batch)
    dev = resolve_device(mesh.device_type) if device is None else \
        torch.device(device)

    aparams = abstract_params(cfg)
    params = _place(aparams, to_named(
        mesh, param_specs(cfg, aparams, mesh, policy)), dev, "normal")
    bspec = batch_specs(cfg, shp.kind, mesh, global_batch=shp.global_batch)
    window = cfg.window

    def named(spec):
        return to_named(mesh, spec)

    if shp.kind == "train":
        micro = micro or train_microbatches(arch)
        dp_total = 1
        for ax in ("pod", "data"):
            if ax in mesh.mesh_dim_names:
                dp_total *= mesh.size(mesh.mesh_dim_names.index(ax))
        micro = max(1, min(micro, shp.global_batch // dp_total))
        # FSDP cells accumulate grads in bf16 (halves the accumulation
        # buffer; grads are bf16 anyway)
        if accum_dtype is None:
            accum_dtype = torch.bfloat16 if policy.fsdp else torch.float32
        opt_name = "adafactor" if cfg.param_count() > 1e11 else "adamw"
        tcfg = TrainConfig(lr=3e-4, weight_decay=0.1, clip_norm=1.0,
                           optimizer=opt_name, microbatches=micro)
        step, opt = make_train_step(
            lambda p, b: forward_loss(p, b, cfg, window=window), tcfg,
            accum_dtype=accum_dtype)
        opt_state = opt.init(params)
        batch = input_specs(cfg, shp)
        batch = {k: _placed_like(v, named(bspec[k]), dev, "zero")
                 for k, v in batch.items()}
        zero = torch.zeros((), dtype=torch.int32)

        def train_step(params, opt_state, batch):
            params, opt_state, _, _, m = step(params, opt_state, None, None,
                                              batch, zero)
            return params, opt_state, m["loss"]

        return train_step, (params, opt_state, batch), rules, cfg

    if shp.kind == "prefill":
        batch = input_specs(cfg, shp)
        batch = {k: _placed_like(v, named(bspec[k]), dev, "normal")
                 for k, v in batch.items()}

        @torch.no_grad()
        def prefill_step(params, batch):
            with plain_as_replicated(True):
                return prefill(params, batch, cfg, window=window)

        return prefill_step, (params, batch), rules, cfg

    # decode: the continuous-batching serve step: (B,) per-slot
    # positions, tokens/pos/cache sharded over the data (replica) axes
    ins = input_specs(cfg, shp)
    cache = _place(ins["cache"], named(
        cache_specs(cfg, ins["cache"], mesh, policy)), dev, "zero")
    tokens = _placed_like(ins["tokens"], named(bspec["tokens"]), dev, "zero")
    pos = _placed_like(ins["pos"], named(bspec["pos"]), dev, "zero")

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        with plain_as_replicated(True):
            return model_decode_step(params, cache, tokens, pos, cfg)

    return serve_step, (params, cache, tokens, pos), rules, cfg


def trace_step(step_fn, args, rules) -> tuple:
    """Run ``step_fn(*args)`` once under ``use_rules(rules)``, counted
    (``op_cost.count``); returns (counter, seconds)."""
    t0 = time.perf_counter()
    with use_rules(rules):
        _, c = count(step_fn, *args)
    return c, time.perf_counter() - t0


def csb_partition_report(cfg, mesh, bm: int = 64) -> dict:
    """Per-device cycle-balance the CSB block partitioner achieves on
    this cell's mesh (paper §5.2 lifted to chips).

    The cell's own weights are shape-only (nothing is allocated in a dry
    run), so the block survivor grid is synthesized to the paper's skew
    profile deterministically per arch: stacked gate bands with very
    different survivor densities (pruned LSTM gates keep wildly
    different fractions — the workload variance of Fig. 7b) plus a dense
    diagonal band (§6.3.2). Reported: greedy vs naive-equal max/mean
    imbalance over the "model" axis, the quantity the sharded kernel's
    critical path follows. ``mesh`` is anything with
    ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``)."""
    from repro_torch.dist.api import axis_sizes
    from repro_torch.dist.csb_partition import (
        block_row_cycles, plan_block_rows,
    )

    n_dev = int(axis_sizes(mesh)["model"])
    d = int(cfg.d_model)
    # refine blocks until each device owns >= 4 block-rows — with fewer
    # the placement has no freedom and any policy hits the single-row
    # imbalance floor
    while bm > 8 and d // bm < 4 * n_dev:
        bm //= 2
    br = bc = max(d // bm, n_dev)
    rng = np.random.default_rng(d * 31 + bm)
    # per-row survivor fraction: 4 gate bands (dense -> heavily pruned),
    # lognormal jitter within a band
    gate = np.array([1.0, 0.45, 0.2, 0.1])[
        (np.arange(br) * 4) // br]                       # (Br,)
    frac = np.clip(gate * rng.lognormal(0.0, 0.25, br), 4 / bm, 1.0)
    m = np.clip((frac[:, None] * bm
                 * rng.uniform(0.7, 1.3, (br, bc))).astype(np.int64),
                2, bm)
    n = np.clip(rng.integers(bm // 4, bm // 2, size=(br, bc)), 2, bm)
    band = np.abs(np.arange(br)[:, None] - np.arange(bc)[None, :]) <= 1
    m = np.where(band, bm, m)
    n = np.where(band, bm, n)
    cyc = block_row_cycles((m, n))
    greedy = plan_block_rows(cyc, n_dev, policy="greedy")
    equal = plan_block_rows(cyc, n_dev, policy="equal")
    return {
        "block": bm, "grid": [int(br), int(bc)], "model_devices": n_dev,
        "greedy": greedy.as_dict(), "equal": equal.as_dict(),
        "speedup_vs_equal": round(
            max(equal.device_cycles) / max(max(greedy.device_cycles), 1),
            3),
    }


def serve_report(cfg, shp, rl: Roofline, chips: int,
                 page_size: int = 64) -> dict:
    """Continuous-batching serving projection for a decode cell.

    Occupancy comes from replaying the real admission policy
    (``serve.scheduler.simulate_admission``) over a deterministic
    mixed-length trace (3 waves of requests, generation lengths spread
    4x — the decode_32k traffic shape); tokens/sec projects the
    roofline-dominant step time onto the occupied slots.

    The ``paged`` sub-record replays the same trace through a
    ``serve.paging.PagePool`` sized to the full contiguous footprint:
    ``peak_pages`` vs ``n_pages`` is the fraction of the contiguous
    cache a right-sized pool would actually need, and
    ``internal_fragmentation`` is the token capacity wasted inside
    allocated pages.

    The ``router`` sub-record is the trace-driven multi-replica replay
    (``serve.router.simulate_replicas``): a Poisson arrival trace with
    per-request deadlines is routed over 2 replicas of this cell under
    each routing policy, using the cell's roofline step time as the
    per-step cost model — p50/p99 TTFT/latency and SLO attainment per
    policy. (Slot count is capped at 16 for the routing replay: the
    policy comparison, not the absolute slot count, is the signal.)
    """
    from repro_torch.serve.paging import PagePool, pages_for
    from repro_torch.serve.router import (
        POLICIES, make_arrival_trace, simulate_replicas,
    )
    from repro_torch.serve.scheduler import Request, simulate_admission

    slots = shp.global_batch
    rng = np.random.default_rng(slots * 7 + shp.seq_len)
    reqs = [
        Request(rid=i, tokens=np.zeros(1, np.int32),
                max_new_tokens=int(rng.integers(32, 129)),
                arrival=(i // max(slots, 1)) * 48)
        for i in range(slots * 3)
    ]
    sim = simulate_admission(slots, reqs)
    step_s = max(rl.t_compute, rl.t_memory, rl.t_collective)
    tps = (slots * sim["occupancy"] / step_s) if step_s > 0 else 0.0

    cache_len = max(r.prompt_len + r.max_new_tokens for r in reqs)
    max_pages = pages_for(cache_len, page_size)
    pool = PagePool(page_size, slots * max_pages, slots, max_pages,
                    device="cpu")
    paged_sim = simulate_admission(
        slots, [Request(rid=r.rid, tokens=r.tokens,
                        max_new_tokens=r.max_new_tokens,
                        arrival=r.arrival) for r in reqs], pool=pool)
    paging = paged_sim.pop("paging")
    peak_tokens = paging["peak_pages"] * page_size

    step_us = step_s * 1e6 if step_s > 0 else 1.0
    rslots = min(slots, 16)
    rtrace = make_arrival_trace(
        np.random.default_rng(slots * 13 + shp.seq_len), rslots * 6,
        mean_gap_steps=0.5, deadline_slack=4.0, step_time_us=step_us)
    router: dict = {"replicas": 2, "slots_per_replica": rslots,
                    "step_time_us": round(step_us, 3), "policies": {}}
    for pol in POLICIES:
        rsim = simulate_replicas(rtrace, 2, policy=pol, n_slots=rslots,
                                 step_time_us=step_us)
        router["policies"][pol] = {
            "ttft_us": rsim["ttft_us"],
            "latency_us": rsim["latency_us"],
            "slo_attainment": rsim["slo_attainment"],
        }
    return {
        **sim,
        "chips": chips,
        "roofline_step_us": round(step_s * 1e6, 3),
        "tokens_per_sec_estimate": round(tps, 1),
        "paged": {
            **paging,
            "contiguous_tokens": slots * cache_len,
            "peak_tokens": peak_tokens,
            # what a right-sized pool pins vs the contiguous cache's
            # slots*cache_len — page-padding overhead included, so the
            # win shrinks as internal fragmentation grows
            "footprint_vs_contiguous": round(
                peak_tokens / (slots * cache_len), 4),
            "page_stalls": paged_sim.get("page_stalls", 0),
        },
        "router": router,
    }


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0: its
    collectives return at once, moving nothing. Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up: the dry run "
                           "needs its own fake one")
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             extra_over=None, policy=None, save: bool = True,
             tag: str = "", mesh_shape=None) -> dict:
    """Trace one cell on the production mesh (or on ``mesh_shape``, dims
    over ("data", "model") or ("pod", "data", "model")) and return its
    record; ``save`` writes it to ``build/dryrun/``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh

    dims, axes = MESHES[multi_pod]
    if mesh_shape is not None:
        dims = tuple(mesh_shape)
        axes = MESHES[len(dims) == 3][1]
    shp = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "pod" + "x".join(map(str, dims)), "kind": shp.kind,
                 "device": FAKE_DEVICE}
    if not cell_is_runnable(arch, shape_name):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k needs sub-quadratic attention; "
                         "this arch is pure full-attention")
        if save:
            _save(rec, tag)
        return rec

    chips = math.prod(dims)
    try:
        with fake_group(chips):
            mesh = DeviceMesh(FAKE_DEVICE,
                              torch.arange(chips).reshape(dims),
                              mesh_dim_names=axes)
            with FakeTensorMode(allow_non_fake_inputs=True):
                step_fn, args, rules, cfg = build_cell(
                    arch, shape_name, mesh, extra_over, policy,
                    device=torch.device(FAKE_DEVICE, 0)
                    if FAKE_DEVICE == "cuda" else "cpu")
                c, trace_s = trace_step(step_fn, args, rules)
                del step_fn, args
            lc = c.cost
            mf = model_flops(cfg, shp, chips)
            rl = roofline(lc.flops, lc.bytes, lc.collective_total, mf)
            rec.update({
                "status": "ok",
                "chips": chips,
                "trace_s": round(trace_s, 2),
                "memory": c.memory(),
                "cost": {"flops_per_device": float(lc.flops),
                         "bytes_per_device": float(lc.bytes),
                         "dot_flops_per_device": float(lc.dot_flops),
                         "ops": c.ops},
                "collectives": {
                    "bytes_by_op": dict(lc.coll_bytes),
                    "count_by_op": dict(lc.coll_count),
                    "total_bytes": lc.collective_total,
                },
                "roofline": rl.as_dict(),
                "csb_partition": csb_partition_report(cfg, mesh),
                "params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
            })
            if shp.kind == "decode":
                rec["serve"] = serve_report(cfg, shp, rl, chips)
            if shp.kind == "train":
                # grad all-reduce traffic with/without the int8
                # error-feedback compressor (TrainConfig.compress_grads):
                # int8 codes + one fp32 scale per leaf on the wire
                leaves = _jax_leaves(abstract_params(cfg))
                fp32 = sum(math.prod(s) * 4 for s in leaves)
                int8 = sum(math.prod(s) + 4 for s in leaves)
                rec["collectives"]["grad_compress"] = {
                    "allreduce_bytes_fp32": fp32,
                    "allreduce_bytes_int8_ef": int8,
                    "ratio": round(fp32 / max(int8, 1), 3),
                    "enabled_by": "TrainConfig.compress_grads",
                }
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if save:
        _save(rec, tag)
    return rec


def _jax_leaves(params) -> list[tuple]:
    """The shapes of JAX's leaves of a port tree (a stacked leaf is
    (L, ...))."""
    from repro_torch import _tree
    return [((len(ps),) if st else ()) + tuple(ps[0].shape)
            for ps, st in _tree.walk(params)]


def _save(rec: dict, tag: str = "") -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(
        RESULTS_DIR,
        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a, s in all_cells():
            run = "RUN " if cell_is_runnable(a, s) else "SKIP"
            print(f"{run} {a:24s} {s}")
        return 0

    if args.sweep:
        ok = err = skip = 0
        for a, s in all_cells():
            for mp in ([False, True] if args.both_meshes
                       else [args.multi_pod]):
                rec = run_cell(a, s, mp)
                st = rec["status"]
                ok += st == "ok"
                err += st == "error"
                skip += st == "skipped"
                extra = ""
                if st == "ok":
                    extra = (f"trace {rec['trace_s']}s "
                             f"dom={rec['roofline']['dominant']}")
                elif st == "error":
                    extra = rec["error"][:120]
                print(f"[{st:7s}] {a} {s} "
                      f"{'multi' if mp else 'single'} {extra}",
                      flush=True)
        print(f"sweep done: {ok} ok, {skip} skipped, {err} errors")
        return 1 if err else 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --sweep/--list)")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    code = 0
    for mp in meshes:
        rec = run_cell(args.arch, args.shape, mp)
        print(json.dumps(
            {k: v for k, v in rec.items() if k != "traceback"}, indent=1))
        if rec["status"] == "error":
            print(rec.get("traceback", ""), file=sys.stderr)
            code = 1
    return code


if __name__ == "__main__":
    sys.exit(main())

"""Frame serving of a stack of RNN layers through the port's
``repro_torch.serve.engine.rnn_serve_frames``.

Per chunk the harness zeroes the state rows of the slots that start a new
utterance, gathers the chunk's frames from the feature bank, and then
makes one call per layer, each layer's outputs feeding the next and each
layer's returned state carried to its next chunk. A chunk is timed from
the call into the first layer to the return of the last layer's call,
which synchronises the device.

After the window the outputs of the compared slots (every true frame,
every layer) and their state at the window's end are held to the plain
reference (``reference/<cell>.py``), fp32 with TF32 off, replayed over
the same frames, resets and weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from portbench import devtrace, inputs, roofline, spec
from portbench.generator import Traffic

PROFILE_AT = 3          # the chunk at which a traced run's profile starts
PROFILE_ACTIVE = 3      # chunks profiled (after one chunk of warm-up)
PROFILE_TRIES = 3
WARMUP_CHUNKS = 2


# ---------------------------------------------------------------- inputs

@dataclasses.dataclass
class Model:
    """What the benchmark makes for a configuration: per layer its
    reference module, its config and its weights; the step's work; the
    feature bank."""

    layers: list[dict]
    cells: list
    weights: list[dict]
    work: roofline.StepWork
    bank: torch.Tensor


def make_model(cfg: dict, mix: dict, seed: int, device) -> Model:
    layers = cfg["layers"]
    cells = [spec.module("reference", layer["cell"]) for layer in layers]
    shapes = [c.weight_shapes(layer) for c, layer in zip(cells, layers)]
    weights = inputs.make_weights(shapes, cfg, seed, device)
    g = torch.Generator(device=device).manual_seed(
        (int(seed) + 0x5EED) % 2**63)
    bank = torch.randn((int(mix["bank_frames"]), layers[0]["n_input"]),
                       generator=g, device=device, dtype=torch.float32)
    return Model(layers, cells, weights, roofline.model_work(cells, weights),
                 bank)


# -------------------------------------------------------------- systems

class Program:
    """The system under test: the port's cells, their CSB matrices
    encoded by the port's own loader, served by ``rnn_serve_frames``."""

    out_dtype = torch.float32

    def __init__(self, cfg: dict, model: Model, device):
        from repro_torch.cells import make_cell
        from repro_torch.core.csb_format import padded_csb_from_dense
        from repro_torch.kernels import csb_mvm
        from repro_torch.serve.engine import rnn_serve_frames
        self.serve = rnn_serve_frames
        self.b1 = csb_mvm
        self.device = device
        bm, bn = cfg["block"]
        self.graphs, self.params = [], []
        for layer, cell, w in zip(model.layers, model.cells, model.weights):
            graph = make_cell(layer["cell"], layer["n_input"],
                              layer["n_hidden"], layer.get("proj"))
            want = {k: tuple(v) for k, v in cell.weight_shapes(layer).items()}
            got = {k: tuple(v) for k, v in graph.weight_shapes().items()}
            if got != want:
                raise ValueError(f"the port's {layer['cell']} has weights "
                                 f"{got}, the reference {want}")
            self.graphs.append(graph)
            self.params.append({
                k: (padded_csb_from_dense(e["dense"], bm, bn,
                                          row_mask=e["row_mask"],
                                          col_mask=e["col_mask"],
                                          device=device)
                    if "row_mask" in e else e["dense"])
                for k, e in w.items()})

    def launches(self) -> int:
        """Kernel B1's launches so far, by the program's own counter."""
        return self.b1.LAUNCHES

    def chunk(self, frames: torch.Tensor, states: list[dict]):
        x, ys, new = frames, [], []
        for graph, params, st in zip(self.graphs, self.params, states):
            y, st, _ = self.serve(graph, params, x, state=st, warmup=0,
                                  collect_frame_times=False,
                                  device=self.device)
            ys.append(y)
            new.append(st)
            x = y
        return ys, new


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to TF32's 10-bit mantissa, to nearest even."""
    u = t.contiguous().view(torch.int32)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & ~0x1FFF
    return u.view(torch.float32)


PRECISIONS = {
    # fp32 products (TF32 off, as the configuration states)
    "fp32": (lambda w: w.contiguous(), lambda a, w: a @ w),
    # the control: every product's operands rounded to TF32
    "tf32": (tf32, lambda a, w: tf32(a) @ w),
    # a witness for the reference's own rounding: everything in fp64
    "fp64": (lambda w: w.double(), lambda a, w: a.double() @ w),
}


class Reference:
    """The plain reference as a system: the layers' equations over dense
    pruned weights, a frame at a time, in the given precision."""

    def __init__(self, model: Model, precision: str = "fp32"):
        as_operand, self.mm = PRECISIONS[precision]
        self.out_dtype = (torch.float64 if precision == "fp64"
                          else torch.float32)
        self.cells = model.cells
        self.prep = [c.prepare({k: e["dense"] for k, e in w.items()},
                               as_operand)
                     for c, w in zip(model.cells, model.weights)]

    def launches(self) -> int:
        return 0

    def chunk(self, frames: torch.Tensor, states: list[dict]):
        x, ys, new = frames, [], []
        for cell, p, st in zip(self.cells, self.prep, states):
            outs = []
            for t in range(x.shape[0]):
                y, st = cell.step(p, x[t], st, self.mm)
                outs.append(y)
            x = torch.stack(outs)
            ys.append(x)
            new.append(st)
        return ys, new


def zero_states(model: Model, rows: int, device) -> list[dict]:
    return [{k: torch.zeros((rows, n), dtype=torch.float32, device=device)
             for k, n in c.state_widths(layer).items()}
            for c, layer in zip(model.cells, model.layers)]


# --------------------------------------------------------------- window

def frames_for(bank: torch.Tensor, start: torch.Tensor, valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """(k, rows, in) frames: row r's ``valid[r]`` frames from
    ``bank[start[r]:]`` (wrapping), then zeros."""
    t = torch.arange(k, device=bank.device)[:, None]
    frames = bank[(start[None, :] + t) % bank.shape[0]]
    return frames * (t < valid[None, :]).unsqueeze(-1).to(frames.dtype)


@dataclasses.dataclass
class Window:
    """What the measured window recorded."""

    chunk_ms: list = dataclasses.field(default_factory=list)
    late_ms: list = dataclasses.field(default_factory=list)
    true_frames: int = 0
    chunks: int = 0
    seconds: float = 0.0
    slice: devtrace.Slice | None = None
    # device memory: the peak since the window's feeder was made, less the
    # harness's record of the compared outputs, and that record's bytes
    program_peak: int = 0
    record_bytes: int = 0
    # per group: per chunk (start, valid, reset) of the compared slots and
    # their outputs per layer; their states at the window's end
    checks: dict = dataclasses.field(default_factory=dict)
    end_states: dict = dataclasses.field(default_factory=dict)


class Record:
    """The compared slots' outputs of one group's chunks, per layer, in
    blocks of device memory allocated before the window: a record that
    grew inside the window would make the allocator call cudaMalloc
    there, and so would host copies."""

    def __init__(self, widths: list[int], k: int, rows: int, chunks: int,
                 device, dtype=torch.float32):
        self.shape = (chunks, k, rows)
        self.widths = widths
        self.device = device
        self.dtype = dtype
        self.blocks: list[list[torch.Tensor]] = []
        self.n = 0
        self._grow()

    def _grow(self):
        self.blocks.append([torch.empty((*self.shape, wd), device=self.device,
                                        dtype=self.dtype)
                            for wd in self.widths])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for blk in self.blocks
                   for t in blk)

    def add(self, ys: list[torch.Tensor], sel: torch.Tensor) -> list:
        b, i = divmod(self.n, self.shape[0])
        if b == len(self.blocks):
            self._grow()
        self.n += 1
        out = []
        for y, buf in zip(ys, self.blocks[b]):
            torch.index_select(y, 1, sel, out=buf[i])
            out.append(buf[i])
        return out


class Feeder:
    """The chunks of a traffic, each with its device inputs and states,
    and the record of the compared slots' outputs (room for ``chunks``
    chunks before it grows, in the system's ``out_dtype``)."""

    def __init__(self, model: Model, traffic: Traffic, device, chunks: int,
                 out_dtype=torch.float32):
        self.model = model
        self.traffic = traffic
        self.device = device
        self.k = traffic.k
        self.states = [zero_states(model, traffic.per_group, device)
                       for _ in range(traffic.groups)]
        self.keep = [traffic.check_in_group(g) for g in range(traffic.groups)]
        self.check = [torch.as_tensor(k, device=device) for k in self.keep]
        widths = [c.out_width(layer)
                  for c, layer in zip(model.cells, model.layers)]
        per_group = -(-chunks // traffic.groups) + 1
        self.records = [Record(widths, self.k, sel.numel(), per_group, device,
                               out_dtype)
                        for sel in self.check]
        # the chunk's starts, true frames and resets, copied to the card
        # from one pinned buffer
        pin = device.type == "cuda"
        self.host = torch.empty((3, traffic.per_group), dtype=torch.int64,
                                pin_memory=pin)
        self.packed = torch.empty((3, traffic.per_group), dtype=torch.int64,
                                  device=device)
        # the last copy out of ``host``: a system that does not synchronise
        # (the reference in the program's place) would otherwise let the
        # next chunk rewrite the buffer before the copy has read it
        self.copied = torch.cuda.Event() if pin else None

    def next(self):
        ch = self.traffic.next()
        if self.copied is not None:
            self.copied.synchronize()
        self.host.numpy()[:] = (ch.start, ch.valid, ch.reset)
        self.packed.copy_(self.host, non_blocking=True)
        if self.copied is not None:
            self.copied.record()
        start, valid = self.packed[0], self.packed[1]
        reset = self.packed[2].bool()
        st = self.states[ch.group]
        for layer in st:
            for v in layer.values():
                v.masked_fill_(reset[:, None], 0.0)
        frames = frames_for(self.model.bank, start, valid, self.k)
        return ch, frames, st


def _maybe(name: str, on: bool):
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def least_chunks(traffic: Traffic) -> int:
    """Enough chunks for every slot to start a new utterance once."""
    longest = int(traffic.mix["utterance_frames"]["max"])
    return traffic.groups * (-(-longest // traffic.k) + 1)


def run_window(system, model: Model, traffic: Traffic, seconds: float,
               trace: bool, device, chunks: int | None = None,
               room: int = 0) -> Window:
    """Chunks until ``seconds`` have passed, every slot has started a new
    utterance at least once (so the check crosses a refill everywhere)
    and, traced, a profile holds every launch of kernel B1 that the
    program counted in it. ``chunks`` instead runs that many chunks (the
    warm-up). ``room``: the chunks the record holds before it grows."""
    from torch.profiler import ProfilerActivity, schedule
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    need = least_chunks(traffic)
    if chunks is not None:
        seconds, need = 0.0, chunks
    feed = Feeder(model, traffic, device, max(room, need), system.out_dtype)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    w = Window()
    prof, prof_at, tries, prof_t0, prof_steps = None, PROFILE_AT, 0, 0.0, []
    prof_launches = []
    excluded = 0.0
    sync()
    t_open = time.perf_counter()
    while True:
        i = w.chunks
        if trace and w.slice is None and prof is None and i >= prof_at:
            sync()
            prof_t0 = time.perf_counter()
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=acts, schedule=schedule(
                    wait=0, warmup=1, active=PROFILE_ACTIVE, repeat=1))
            prof.__enter__()
            prof_steps, prof_launches = [], []
        ch, frames, st = feed.next()
        if ch.due_s is not None:
            while time.perf_counter() - t_open < ch.due_s:
                time.sleep(min(1e-3, max(0.0, ch.due_s - (time.perf_counter()
                                                           - t_open))))
        if prof is not None:
            sync()
        t0 = time.perf_counter()
        with _maybe(devtrace.SERVE, prof is not None):
            ys, new = system.chunk(frames, st)
        t1 = time.perf_counter()
        feed.states[ch.group] = new
        sel, keep = feed.check[ch.group], feed.keep[ch.group]
        if sel.numel():
            w.checks.setdefault(ch.group, []).append(
                (ch.start[keep], ch.valid[keep], ch.reset[keep],
                 feed.records[ch.group].add(ys, sel)))
        if prof is not None:
            sync()
            prof_steps.append(int(ch.valid.sum()))
            prof_launches.append(system.launches())
            prof.step()
            if len(prof_steps) == 1 + PROFILE_ACTIVE:
                prof.__exit__(None, None, None)
                sl = devtrace.read(devtrace.chrome_events(prof))
                sl.steps = PROFILE_ACTIVE * traffic.k
                sl.true_rows = sum(prof_steps[1:])
                tries += 1
                # the profiler can miss launches: the slice must hold
                # every B1 launch the program counted in its active chunks
                counted = prof_launches[-1] - prof_launches[0]
                if (len(sl.b1_kernels()) == counted or not cuda
                        or tries == PROFILE_TRIES):
                    w.slice = sl
                else:
                    prof_at = i + 3
                prof = None
                excluded += time.perf_counter() - prof_t0
            continue
        w.chunk_ms.append((t1 - t0) * 1e3)
        if ch.due_s is not None:
            w.late_ms.append((t0 - t_open - ch.due_s) * 1e3)
            w.chunk_ms[-1] = (t1 - t_open - ch.due_s) * 1e3
        w.true_frames += int(ch.valid.sum())
        w.chunks += 1
        if (t1 - t_open - excluded >= seconds and traffic.issued >= need
                and (not trace or w.slice is not None)):
            break
    w.seconds = time.perf_counter() - t_open - excluded
    w.record_bytes = sum(rec.nbytes() for rec in feed.records)
    if cuda:
        w.program_peak = (torch.cuda.max_memory_allocated(device)
                          - w.record_bytes)
    for g, sel in enumerate(feed.check):
        if sel.numel():
            w.end_states[g] = [{k: v.index_select(0, sel)
                                for k, v in layer.items()}
                               for layer in feed.states[g]]
    return w


# ---------------------------------------------------------------- check

def check(model: Model, traffic: Traffic, w: Window, device) -> dict:
    """The gaps between the run's compared outputs and end states and the
    reference's, fp32 with TF32 off, replayed from zero state over the
    same frames and resets: the widest over every compared output
    (``out_gap``), the median over chunks of each chunk's widest
    (``out_gap_median``), and the widest over the end states
    (``state_gap``)."""
    ref = Reference(model, "fp32")
    chunk_gaps = []
    state_gap = torch.zeros((), device=device)
    compared = 0
    k = traffic.k
    t = torch.arange(k, device=device)[:, None]
    for g, recs in w.checks.items():
        rows = recs[0][0].size
        st = zero_states(model, rows, device)
        for start, valid, reset, outs in recs:
            keep = torch.as_tensor(~reset, device=device)[:, None]
            st = [{n: v * keep for n, v in layer.items()} for layer in st]
            vt = torch.as_tensor(valid, device=device)
            frames = frames_for(model.bank, torch.as_tensor(start,
                                                            device=device),
                                vt, k)
            ys, st = ref.chunk(frames, st)
            live = (t < vt[None, :]).unsqueeze(-1)
            chunk_gaps.append(torch.stack([
                torch.where(live, (y - o).abs(), 0.0).amax()
                for y, o in zip(ys, outs)]).amax())
            compared += int(valid.sum()) * len(ys)
        for mine, theirs in zip(w.end_states[g], st):
            for n in theirs:
                state_gap = torch.maximum(
                    state_gap, (mine[n] - theirs[n]).abs().amax())
    gaps = torch.stack(chunk_gaps).double().cpu()
    return {"out_gap": float(gaps.max()),
            "out_gap_median": float(gaps.median()),
            "state_gap": float(state_gap), "compared": compared}


# ------------------------------------------------------------------ run

def device_info(device, setup_peak: int, windows: list[Window]) -> dict:
    """The device's record. ``memory_peak_bytes`` is the program's peak:
    the set-up's, and each window's less the harness's record of the
    compared outputs (allocated before the window, so that the window
    makes no allocation of its own); ``memory_peak_all_bytes`` counts the
    record too."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(max(
                [setup_peak] + [w.program_peak for w in windows])),
            "memory_peak_all_bytes": int(max(
                [setup_peak] + [w.program_peak + w.record_bytes
                                for w in windows])),
            "record_bytes": int(windows[-1].record_bytes)}


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, system: str = "program") -> dict:
    """One run of a cell: set-up, the window, then the check. Returns the
    end-to-end values, the window, the checks, the device's record and
    the set-up's phases. ``system`` puts the reference (a key of
    ``PRECISIONS``) in the program's place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    phases = {"before": time.perf_counter() - t_start}
    with torch.inference_mode():
        t = time.perf_counter()
        model = make_model(cfg, mix, seed, device)
        sync()
        phases["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        sut = (Program(cfg, model, device) if system == "program"
               else Reference(model, system))
        phases["system"] = time.perf_counter() - t
        t = time.perf_counter()
        setup_peak = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
        warm = run_window(sut, model, Traffic(mix, seed), 0.0, False, device,
                          chunks=WARMUP_CHUNKS)
        traffic = Traffic(mix, seed)
        # room for twice the chunks the warm-up's pace fits in the window
        room = (least_chunks(traffic) + PROFILE_TRIES * (1 + PROFILE_ACTIVE)
                + 2 * int(seconds * 1e3 / min(warm.chunk_ms)) + 4)
        # the warm-up's record goes; its peak stays
        warm.checks.clear()
        warm.end_states.clear()
        sync()
        phases["warm_up"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start
        w = run_window(sut, model, traffic, seconds, trace, device,
                       room=room)
        dev = device_info(device, setup_peak, [warm, w])
        del sut, warm
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = check(model, traffic, w, device)
    e2e = {
        "frames_per_s": w.true_frames / w.seconds,
        "chunk_p95_ms": float(np.percentile(w.chunk_ms, 95)),
        "setup_s": setup_s,
    }
    return {"e2e": e2e, "window": w, "checks": checks, "device": dev,
            "model": model, "attempted": w.chunks, "failed": 0,
            "setup_phases": phases}

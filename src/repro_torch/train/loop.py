"""The training loop, the port of ``repro.train.loop``: microbatched
grad accumulation, ADMM-CSB hooks, checkpoint/auto-resume, step-time
straggler telemetry.

``make_train_step`` builds one step:
  grads = mean over microbatches of d(loss + admm_penalty)/d(params)
  grads = compress->decompress(grads)   (optional int8 error feedback)
  grads = clip(grads)
  params, opt = optimizer.update(...)
Autograd gives the gradients (``torch.autograd.grad`` over the params'
tensors); the optimizer updates params and its state in place
(``optim.optimizers``). With ``TrainConfig.compress_grads`` the int8
error-feedback compressor (``dist.compress``) sits where the DP
all-reduce runs: the optimizer only ever sees the dequantized wire
gradient, and the per-JAX-leaf quantization residual rides in the step's
state so the transmitted sum tracks the true sum (EF-SGD).

JAX jits and donates the step; here it runs eagerly, one kernel an op,
and ``float(loss)`` blocks until the step's work is done, so a step's
wall time is true (as in JAX).

On a mesh (params as DTensors, ``dist.api``; the batch as DTensors split
over the data axes, ``data.sharded_batches``) the step is the same code:
the loss is the global mean, and each gradient comes back from autograd
partial over the ranks that shared its work and is reduced onto its
param's placements (the DP all-reduce, and the tensor-parallel sums),
as GSPMD's gradients are. Compression then runs on the reduced gradient,
where JAX runs it. With microbatches each rank splits its own part of
the batch. Plain tensors that meet a DTensor in the step (constants,
masks) count as replicated.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core import admm_finalize, admm_init, admm_penalty, \
    admm_update
from repro_torch.dist.api import is_dtensor, plain_as_replicated, whole
from repro_torch.dist.compress import compress, compress_init, decompress
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace
from repro_torch.optim import clip_by_global_norm, get_optimizer
from . import checkpoint as ckpt

PyTree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    optimizer: str = "adamw"
    microbatches: int = 1
    steps: int = 100
    log_every: int = 10
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    keep_ckpts: int = 3
    # ADMM-CSB pruning
    admm_rho: float = 1e-3
    admm_every: int = 0          # 0 = disabled; else projection period
    # int8 error-feedback gradient compression on the DP all-reduce
    compress_grads: bool = False


def _tensors(tree: PyTree) -> list:
    return [p for parts in _tree.leaves(tree) for p in parts]


def _on(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (numpy goes over, as
    jit takes numpy arguments); DTensors stay where they are."""
    return {k: v if is_dtensor(v) else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


def _micro(v, n: int, i: int):
    """Microbatch ``i`` of ``n`` of the batch array ``v``: on a mesh, the
    i-th of n slices of this rank's own part of the batch."""
    if not is_dtensor(v):
        return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    from torch.distributed.tensor import DTensor
    loc = v.to_local()
    loc = loc.reshape(n, loc.shape[0] // n, *loc.shape[1:])[i]
    return DTensor.from_local(loc, v.device_mesh, v.placements,
                              run_check=False)


def _reduced(g, p):
    """The gradient ``g`` on its param's placements (a DTensor gradient
    arrives partial where ranks shared the work: reduced here)."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _mesh_scope(params):
    """Plain tensors meet DTensors in a mesh step (constants, masks, the
    learning rate): there they count as replicated."""
    leaves = next(iter(_tree.leaves(params)), [None])
    return plain_as_replicated(is_dtensor(leaves[0]))


def make_train_step(
    loss_fn: Callable[[PyTree, dict], torch.Tensor],
    tcfg: TrainConfig,
    lr_schedule: Callable | None = None,
    csb_specs: PyTree | None = None,
    accum_dtype: torch.dtype = F32,
):
    """Returns (step_fn, opt) where
    step_fn(params, opt_state, admm_state, residual, batch, step) ->
        (params, opt_state, admm_state, residual, metrics).

    ``params`` and ``opt_state`` are updated in place and returned.
    ``residual`` is the error-feedback carry for ``tcfg.compress_grads``
    (init with ``dist.compress.compress_init(params)``); pass None when
    compression is off: the step then never touches it. Gradients are
    in the params' dtype with one microbatch; with several they
    accumulate into zeros of ``accum_dtype`` (fp32 as in JAX's loop; the
    dry run's FSDP cells take bf16) and stay in it."""
    opt = get_optimizer(tcfg.optimizer)
    sched = lr_schedule or (lambda s: torch.tensor(tcfg.lr, dtype=F32))

    def total_loss(params, batch, admm_state):
        loss = loss_fn(params, batch)
        if csb_specs is not None and admm_state is not None:
            loss = loss + admm_penalty(params, admm_state, csb_specs)
        return loss

    def value_and_grad(params, batch, admm_state):
        leaves = _tensors(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = total_loss(params, batch, admm_state)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else _reduced(g, p)
                 for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def step_fn(params, opt_state, admm_state, residual, batch, step):
        with _mesh_scope(params):
            return _step(params, opt_state, admm_state, residual, batch,
                         step)

    def _step(params, opt_state, admm_state, residual, batch, step):
        leaves = _tensors(params)
        batch = _on(batch, leaves[0].device)
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            gsum = [torch.zeros_like(p, dtype=accum_dtype) for p in leaves]
            lsum = torch.zeros((), dtype=F32, device=leaves[0].device)
            for i in range(n):
                mb = {k: _micro(v, n, i) for k, v in batch.items()}
                l, g = value_and_grad(params, mb, admm_state)
                for a, b in zip(gsum, g):
                    a.add_(b.to(accum_dtype))
                lsum = lsum + l
                del g
            flat = [g / n for g in gsum]
            loss = lsum / n
        else:
            loss, flat = value_and_grad(params, batch, admm_state)
        grads = _tree.rebuild(params, iter(_regroup(params, flat)))
        del flat

        if residual is not None:
            # the wire stage of the DP all-reduce: quantize to int8 on a
            # per-leaf grid, carry the round-off into the next step
            comp, residual = compress(grads, residual)
            grads = decompress(comp)
            del comp

        if tcfg.clip_norm:
            grads = clip_by_global_norm(grads, tcfg.clip_norm)
        lr = sched(step)
        params, opt_state = opt.update(grads, opt_state, params, lr,
                                       tcfg.weight_decay)
        metrics = {"loss": loss, "lr": lr}
        return params, opt_state, admm_state, residual, metrics

    return step_fn, opt


def _regroup(tree: PyTree, flat: list) -> list:
    """The flat per-tensor list of ``tree``'s order as one list of parts
    per JAX leaf (what ``_tree.rebuild`` takes)."""
    it = iter(flat)
    return [[next(it) for _ in parts] for parts in _tree.leaves(tree)]


@dataclasses.dataclass
class StepTimer:
    """Straggler telemetry: wall-time quantiles over a sliding window."""

    window: int = 100

    def __post_init__(self):
        self.times: list[float] = []

    def record(self, dt: float):
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)

    def quantiles(self):
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "p99": float(np.percentile(a, 99))}

    def is_straggling(self, dt: float, factor: float = 3.0) -> bool:
        q = self.quantiles()
        return bool(q) and dt > factor * q["p50"]


def train(
    loss_fn: Callable,
    params: PyTree,
    batches,                     # iterator of (step, batch)
    tcfg: TrainConfig,
    lr_schedule=None,
    csb_specs: PyTree | None = None,
    eval_fn: Callable | None = None,
    log: Callable[[str], None] = print,
):
    """Run the loop with auto-resume + periodic checkpoints.

    Returns (params, history). ``params`` is updated in place (a resumed
    run replaces it with the checkpoint's tensors); the returned tree is
    the trained one."""
    step_fn, opt = make_train_step(loss_fn, tcfg, lr_schedule, csb_specs)
    opt_state = opt.init(params)
    admm_state = (admm_init(params, csb_specs, tcfg.admm_rho)
                  if csb_specs is not None else None)
    residual = compress_init(params) if tcfg.compress_grads else None
    start = 0

    def _ckpt_tree():
        # the EF residual is train state: dropping it on resume would
        # break the transmitted-sum-tracks-true-sum guarantee right at
        # the restart boundary
        tree = {"params": params, "opt": opt_state}
        if residual is not None:
            tree["residual"] = residual
        return tree

    if tcfg.ckpt_dir:
        try:
            got = ckpt.restore_latest(tcfg.ckpt_dir, _ckpt_tree())
        except ValueError:
            if residual is None:
                raise
            # checkpoints predate compress_grads being switched on:
            # restore what exists and start the EF carry from zero
            got = ckpt.restore_latest(
                tcfg.ckpt_dir, {"params": params, "opt": opt_state})
            log("[resume] checkpoint has no EF residual; starting the "
                "compression carry from zero")
        if got is not None:
            start, tree, extra = got
            params, opt_state = tree["params"], tree["opt"]
            residual = tree.get("residual", residual)
            log(f"[resume] restored step {start} from {tcfg.ckpt_dir}")

    timer = StepTimer()
    history = []
    for step, batch in batches:
        if step < start:
            continue
        if step >= tcfg.steps:
            break
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        params, opt_state, admm_state, residual, metrics = step_fn(
            params, opt_state, admm_state, residual, batch,
            torch.tensor(step, dtype=torch.int32))
        if (csb_specs is not None and tcfg.admm_every
                and (step + 1) % tcfg.admm_every == 0):
            with _mesh_scope(params):
                admm_state = admm_update(params, admm_state, csb_specs)
        loss = float(whole(metrics["loss"]))  # blocks: the step's true wall
        dt = time.perf_counter() - t0
        timer.record(dt)
        tr = obs_trace.get()
        if tr is not None:
            tr.complete("train/step", t0_ns, int(dt * 1e9),
                        track="train", args={"step": step, "loss": loss})
        reg = obs_metrics.get()
        if reg is not None:
            reg.histogram("train/step/wall_us").observe(dt * 1e6)
            reg.gauge("train/step/loss").set(loss)
        history.append({"step": step, "loss": loss, "dt": dt})
        if step % tcfg.log_every == 0:
            q = timer.quantiles()
            log(f"step {step:5d} loss {loss:.4f} "
                f"dt {dt*1e3:.1f}ms p95 {q.get('p95', 0)*1e3:.1f}ms"
                + (" STRAGGLER" if timer.is_straggling(dt) else ""))
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            ckpt.save(tcfg.ckpt_dir, step + 1, _ckpt_tree())
            ckpt.keep_last(tcfg.ckpt_dir, tcfg.keep_ckpts)

    if csb_specs is not None:
        params = admm_finalize(params, csb_specs)
    return params, history

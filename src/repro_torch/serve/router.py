"""Front-end router over N serve-engine replicas, ported from
``repro.serve.router``.

One engine replica is a fixed set of decode slots; serving at scale runs
N of them behind a router that decides, per request, which replica
admits it. The decision layer is modelless host numpy, copied from the
JAX package:

* :func:`route` — assign a request trace to replicas under a policy.
  ``least_loaded`` is load-aware admission built on
  :func:`repro_torch.serve.scheduler.simulate_admission`: for each
  candidate replica it replays the replica's already-assigned trace plus
  the new request and takes the projected makespan (``final_step``),
  weighted by the replica's per-step cost (heterogeneous replicas route
  proportionally slower). ``round_robin`` is the baseline.
* :func:`simulate_replicas` — the trace-driven multi-replica dryrun:
  route, replay each replica, merge per-request TTFT/latency into
  fleet-wide p50/p99 and SLO attainment (requests carrying
  ``Request.deadline_us``).
* :class:`Router` — the executing front-end: partitions the trace and
  runs a real engine (``serve_continuous`` or ``serve_disaggregated``)
  per replica under one :class:`~.config.EngineConfig`. Greedy decoding
  makes per-request tokens independent of which replica ran them, so a
  routed run is token for token identical to one engine serving the
  whole trace.

The router is judged on per-request deadline attainment (p99), not
blended throughput.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics, trace as obs_trace

from .config import EngineConfig, resolve_config
from .scheduler import Request, simulate_admission

POLICIES = ("round_robin", "least_loaded")

__all__ = ["POLICIES", "Router", "RouterResult", "make_arrival_trace",
           "route", "simulate_replicas"]


def _step_times(step_time_us, n_replicas: int) -> list[float]:
    """Scalar -> uniform fleet; sequence -> per-replica cost model."""
    if isinstance(step_time_us, (int, float)):
        return [float(step_time_us)] * n_replicas
    times = [float(t) for t in step_time_us]
    if len(times) != n_replicas:
        raise ValueError(
            f"step_time_us has {len(times)} entries for "
            f"{n_replicas} replicas")
    return times


def route(requests: list[Request], n_replicas: int, *,
          policy: str = "least_loaded", n_slots: int = 4,
          step_time_us: float | Sequence[float] = 1.0
          ) -> list[list[Request]]:
    """Partition ``requests`` over ``n_replicas`` replica queues.

    ``round_robin``: arrival order, modulo. ``least_loaded``: each
    request goes to the replica whose projected completion time
    (simulated makespan x per-step cost) grows least when it takes the
    request — ties break to the lowest replica index, so the assignment
    is deterministic for a fixed trace.
    """
    if n_replicas < 1:
        raise ValueError("need at least one replica")
    if policy not in POLICIES:
        raise ValueError(f"unknown routing policy {policy!r}; "
                         f"one of {POLICIES}")
    ordered = sorted(requests, key=lambda r: (r.arrival, r.rid))
    out: list[list[Request]] = [[] for _ in range(n_replicas)]
    if policy == "round_robin":
        for i, r in enumerate(ordered):
            out[i % n_replicas].append(r)
        return out
    times = _step_times(step_time_us, n_replicas)
    # simulate_admission is pure host replay: cheap enough to re-run per
    # (request, candidate replica) at routing scale
    for r in ordered:
        best, best_cost = 0, None
        for i in range(n_replicas):
            sim = simulate_admission(n_slots, out[i] + [r])
            cost = sim["final_step"] * times[i]
            if best_cost is None or cost < best_cost:
                best, best_cost = i, cost
        out[best].append(r)
    return out


def simulate_replicas(requests: list[Request], n_replicas: int, *,
                      policy: str = "least_loaded", n_slots: int = 4,
                      step_time_us: float | Sequence[float] = 1.0
                      ) -> dict:
    """Trace-driven multi-replica dryrun: route, replay every replica
    through :func:`simulate_admission`, and merge the per-request SLO
    records into fleet-wide percentiles.

    Returns ``ttft_us``/``latency_us`` p50 and p99, ``slo_attainment``
    (None when no request carries a deadline), per-replica
    occupancy/load, and the per-replica SLO summaries.
    """
    times = _step_times(step_time_us, n_replicas)
    assignment = route(requests, n_replicas, policy=policy,
                       n_slots=n_slots, step_time_us=times)
    per_replica, ttft, lat = [], [], []
    met = deadlines = 0
    for i, sub in enumerate(assignment):
        stats = simulate_admission(n_slots, sub, step_time_us=times[i])
        slo = stats["slo"]
        for rec in slo["per_request"].values():
            ttft.append(rec["ttft_us"])
            lat.append(rec["latency_us"])
            if rec["met"] is not None:
                deadlines += 1
                met += rec["met"]
        per_replica.append({
            "requests": stats["requests"],
            "occupancy": stats["occupancy"],
            "final_step": stats["final_step"],
            "step_time_us": times[i],
            "slo": {k: v for k, v in slo.items()
                    if k != "per_request"},
        })

    def pct(a, q):
        return round(float(np.percentile(a, q)), 3) if a else 0.0

    return {
        "policy": policy,
        "replicas": n_replicas,
        "slots_per_replica": n_slots,
        "requests": len(lat),
        "ttft_us": {"p50": pct(ttft, 50), "p99": pct(ttft, 99)},
        "latency_us": {"p50": pct(lat, 50), "p99": pct(lat, 99)},
        "deadlines": deadlines,
        "slo_attainment": (round(met / deadlines, 4)
                           if deadlines else None),
        "per_replica": per_replica,
    }


def make_arrival_trace(rng: np.random.Generator, n_requests: int, *,
                       vocab: int = 256, prompt_lo: int = 4,
                       prompt_hi: int = 24, new_lo: int = 8,
                       new_hi: int = 33, mean_gap_steps: float = 1.0,
                       deadline_slack: float | None = None,
                       step_time_us: float = 1.0) -> list[Request]:
    """A Poisson-arrival mixed-length trace for router dryruns.

    ``mean_gap_steps`` sets the arrival rate (exponential inter-arrival
    gaps in decode steps — smaller = heavier load). With
    ``deadline_slack`` each request carries
    ``deadline_us = slack * (max_new_tokens + 1) * step_time_us`` — a
    per-request realtime budget proportional to its own ideal service
    time, so attainment measures queueing and routing, not trace skew.
    """
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += float(rng.exponential(mean_gap_steps))
        plen = int(rng.integers(prompt_lo, prompt_hi))
        mnt = int(rng.integers(new_lo, new_hi))
        deadline = (deadline_slack * (mnt + 1) * step_time_us
                    if deadline_slack is not None else None)
        reqs.append(Request(
            rid=i, tokens=rng.integers(0, vocab, size=plen,
                                       dtype=np.int64).astype(np.int32),
            max_new_tokens=mnt, arrival=int(t), deadline_us=deadline))
    return reqs


@dataclasses.dataclass
class RouterResult:
    """Outcome of a routed multi-replica run."""

    tokens: dict[int, list[int]]      # rid -> generated tokens (merged)
    stats: dict                       # router + per-replica stats
    wall_s: float
    per_replica: list                 # the underlying ServeResults


class Router:
    """Executing front-end over N engine replicas.

    ``engine`` picks the per-replica engine: ``"continuous"``
    (``serve_continuous``) or ``"disagg"`` (``serve_disaggregated``:
    prefill and decode tiers inside each replica). All replicas share one
    :class:`EngineConfig`. In one process the replicas run one after the
    other on the same card: the router's value here is the assignment
    (and its simulation); a deployment gives each replica its own card.
    """

    def __init__(self, n_replicas: int,
                 config: EngineConfig | None = None, *,
                 policy: str = "least_loaded",
                 step_time_us: float | Sequence[float] = 1.0,
                 engine: str = "continuous"):
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"one of {POLICIES}")
        if engine not in ("continuous", "disagg"):
            raise ValueError(
                f"engine must be 'continuous' or 'disagg', got {engine!r}")
        self.n_replicas = n_replicas
        self.config = resolve_config(config, caller="Router")
        self.policy = policy
        self.step_time_us = _step_times(step_time_us, n_replicas)
        self.engine = engine

    def assign(self, requests: list[Request]) -> list[list[Request]]:
        return route(requests, self.n_replicas, policy=self.policy,
                     n_slots=self.config.n_slots,
                     step_time_us=self.step_time_us)

    def simulate(self, requests: list[Request]) -> dict:
        return simulate_replicas(requests, self.n_replicas,
                                 policy=self.policy,
                                 n_slots=self.config.n_slots,
                                 step_time_us=self.step_time_us)

    def serve(self, params, cfg, requests: list[Request], *, mesh=None,
              policy=None, generator: torch.Generator | None = None,
              device=None) -> RouterResult:
        """Route, then run the engine per replica on ``device`` (``None``
        means the card); merge the results.

        Per-request tokens are identical to one engine serving the whole
        trace (greedy decoding does not depend on the replica). At
        ``temperature > 0`` every replica draws from a generator in
        ``generator``'s starting state (JAX hands every replica the same
        key), which is left as it was. ``mesh=`` and ``policy=`` pass
        through to every replica's engine, as JAX's do (each replica then
        runs on that mesh, one after the other)."""
        from .disagg import serve_disaggregated
        from .engine import serve_continuous

        engine_fn = (serve_disaggregated if self.engine == "disagg"
                     else serve_continuous)
        state = generator.get_state() if generator is not None else None
        assignment = self.assign(requests)
        reg = obs_metrics.get()
        tr = obs_trace.get()
        per: list = []
        t0 = time.perf_counter()
        for ridx, sub in enumerate(assignment):
            if reg is not None:
                reg.gauge(f"serve/router/replica{ridx}/load").set(
                    len(sub))
            gen = None
            if state is not None:
                gen = torch.Generator(device=generator.device)
                gen.set_state(state)
            t_r = time.perf_counter_ns()
            res = engine_fn(params, cfg, sub, self.config, mesh=mesh,
                            policy=policy, generator=gen, device=device)
            if tr is not None:
                tr.complete("serve/router/replica", t_r,
                            time.perf_counter_ns() - t_r,
                            track="router",
                            args={"replica": ridx,
                                  "requests": len(sub),
                                  "tokens": res.stats[
                                      "generated_tokens"]})
            per.append(res)
        wall = time.perf_counter() - t0
        tokens: dict[int, list[int]] = {}
        for res in per:
            tokens.update(res.tokens)
        stats = {
            "policy": self.policy,
            "engine": self.engine,
            "replicas": self.n_replicas,
            "requests": sum(r.stats["requests"] for r in per),
            "generated_tokens": sum(
                r.stats["generated_tokens"] for r in per),
            "replica_requests": [len(a) for a in assignment],
            "per_replica": [r.stats for r in per],
        }
        stats["tokens_per_sec"] = round(
            stats["generated_tokens"] / wall, 3) if wall > 0 else 0.0
        return RouterResult(tokens, stats, wall, per)

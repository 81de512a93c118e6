"""Disaggregated prefill/decode serving and multi-replica routing on the
PyTorch port: the counterpart of ``examples/serve_router.py``, with the
same model, traces, seeds and engine config.

Parts 1 and 2 run on a (2, 4) ("data", "model") mesh of eight ranks, one
process a rank (``repro_torch.dist.launch.spawn_ranks``: gloo ranks on the
CPU with ``--cpu``; on the card by default, the eight ranks sharing it over
gloo). Every rank runs both parts on the same params and traces and
asserts what the JAX example asserts; rank 0 prints; the parent holds the
ranks to one another.

1. Disaggregation: the mixed-length trace through ``serve_disaggregated``
   (a prefill tier handing each request's KV pages to a fixed-slot decode
   tier) gives ``serve_continuous``' tokens; with ``prefix_cache=True``
   the handoffs stay refcount-correct across trie-shared pages, and the
   trie is hit.
2. Routing: ``Router(2, policy="least_loaded", engine="disagg")`` spreads
   the trace over two replicas; the fleet's tokens are one engine's.
3. The trace-driven dry run: ``simulate_replicas`` replays a Poisson
   trace with per-request deadlines under both routing policies (host
   only: run once, in the parent).

Run:  PYTHONPATH=src python examples/serve_router_torch.py [--cpu]
      (the card unless --cpu)
"""
import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.dist.launch import spawn_ranks
from repro_torch.models import ModelConfig, init_params
from repro_torch.serve import (
    EngineConfig, Request, Router, make_arrival_trace, serve_continuous,
    serve_disaggregated, simulate_replicas,
)

MESH = (2, 4)                  # ("data", "model"): JAX's 8 host devices
CFG = dict(name="router-demo", mixer="attn", ffn="swiglu", n_layers=2,
           d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
           vocab=256, dtype="float32", remat=False)
ECONF = EngineConfig(n_slots=4, paged=True, page_size=8)
POLICIES = ("round_robin", "least_loaded")
TIMEOUT_S = 1200.0             # the ranks' deadline once they have joined


def request_traces(vocab: int) -> dict:
    """The JAX example's traces, drawn in its order from
    ``np.random.default_rng(11)``: ten mixed requests, then six sharing
    a 17-token system prompt."""
    rng = np.random.default_rng(11)
    mixed = [Request(rid=i, tokens=rng.integers(0, vocab,
                                                size=int(rng.integers(5, 18))),
                     max_new_tokens=int(rng.integers(6, 14)),
                     arrival=(i // 3) * 5) for i in range(10)]
    sys_p = rng.integers(0, vocab, size=17)
    shared = [Request(rid=50 + i, tokens=np.concatenate(
        [sys_p, rng.integers(0, vocab, size=int(rng.integers(2, 6)))]),
        max_new_tokens=int(rng.integers(5, 10)), arrival=(i // 2) * 3)
        for i in range(6)]
    return {"mixed": mixed, "shared": shared}


def arrival_trace(vocab: int) -> list:
    """Part 3's 24 Poisson arrivals (``np.random.default_rng(3)``)."""
    return make_arrival_trace(np.random.default_rng(3), 24, vocab=vocab,
                              mean_gap_steps=0.5, deadline_slack=4.0,
                              step_time_us=1.0)


def _run(res) -> dict:
    return {"tokens": res.tokens, "stats": res.stats}


def router_rank(mesh, params) -> dict:
    """Parts 1 and 2 on this rank of ``mesh``, asserting what the JAX
    example asserts; rank 0 prints. Returns each run's tokens and stats."""
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    dev = mesh.device_type
    cfg = ModelConfig(**CFG)
    reqs = request_traces(cfg.vocab)
    kw = dict(mesh=mesh, device=dev)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
        f"{mesh.size()} ranks ({dev})")

    # -- 1. disaggregated prefill/decode tiers -----------------------------
    single = serve_continuous(params, cfg, reqs["mixed"], ECONF, **kw)
    dis = serve_disaggregated(params, cfg, reqs["mixed"], ECONF, **kw)
    assert dis.tokens == single.tokens, \
        "disaggregation must not change a single output token"
    say(f"\ndisagg: {dis.stats['handoffs']} handoffs moved "
        f"{dis.stats['handoff_pages']} pages prefill->decode, "
        f"{dis.stats['prefill_tokens']} prefill tokens, "
        f"{dis.stats['generated_tokens']} generated "
        f"(sharded={dis.stats['sharded']}) — tokens == single engine")

    # shared system prompt: handoffs remap trie-shared pages refcount-safely
    pconf = ECONF.replace(prefix_cache=True)
    sh_single = serve_continuous(params, cfg, reqs["shared"], pconf, **kw)
    sh_dis = serve_disaggregated(params, cfg, reqs["shared"], pconf, **kw)
    assert sh_dis.tokens == sh_single.tokens
    assert sh_dis.stats["prefix_hits"] > 0
    say(f"prefix-shared disagg: {sh_dis.stats['prefix_hits']} trie hits, "
        f"{sh_dis.stats['prefill_tokens']} prefill tokens "
        f"(vs {dis.stats['prefill_tokens']} unshared trace) — parity held")

    # -- 2. routed fleet: 2 replicas, load-aware admission -----------------
    router = Router(2, ECONF, policy="least_loaded", engine="disagg")
    routed = router.serve(params, cfg, reqs["mixed"], **kw)
    assert routed.tokens == single.tokens, \
        "routing must not change any request's tokens"
    say(f"\nrouter: {routed.stats['replicas']} replicas took "
        f"{routed.stats['replica_requests']} requests "
        f"(policy={routed.stats['policy']}, engine={routed.stats['engine']})"
        f" — fleet tokens == single engine")
    return {"single": _run(single), "disagg": _run(dis),
            "shared_single": _run(sh_single), "shared_disagg": _run(sh_dis),
            "routed": _run(routed)}


def simulate(vocab: int) -> dict:
    """Part 3: ``simulate_replicas`` over the Poisson trace, 2 replicas x
    4 slots, under each policy; printed and returned."""
    trace = arrival_trace(vocab)
    print(f"\n{len(trace)} Poisson arrivals, per-request deadlines "
          f"(slack 4x ideal service time), 2 replicas x 4 slots:")
    out = {}
    for pol in POLICIES:
        s = out[pol] = simulate_replicas(trace, 2, policy=pol, n_slots=4,
                                         step_time_us=1.0)
        print(f"  {pol:<12} ttft p50/p99 = {s['ttft_us']['p50']:.0f}/"
              f"{s['ttft_us']['p99']:.0f} us, latency p50/p99 = "
              f"{s['latency_us']['p50']:.0f}/{s['latency_us']['p99']:.0f} us,"
              f" SLO attainment {s['slo_attainment']:.0%}")
    return out


def main(argv=None, *, params=None) -> dict:
    """Spawn the mesh's ranks for parts 1 and 2, hold the ranks to one
    another, then run part 3 on the host. ``params``: the LM's (default:
    drawn from a generator seeded 0). Returns the ranks' results (rank
    order), part 3's numbers and the wall time of the mesh parts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    cfg = ModelConfig(**CFG)
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    t0 = time.perf_counter()
    ranks = spawn_ranks(router_rank, MESH, params, device=dev,
                        timeout_s=TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r, got in enumerate(ranks[1:], start=1):
        for run, res in got.items():
            assert res["tokens"] == ranks[0][run]["tokens"], (r, run)
    print(f"\n{len(ranks)} ranks agree on every run's tokens; wall "
          f"{wall:.1f} s")
    sims = simulate(cfg.vocab)
    print("done")
    return {"ranks": ranks, "simulate": sims, "wall_s": wall}


if __name__ == "__main__":
    main()

"""End-to-end serving demo on the PyTorch port: the counterpart of
``examples/serve_batched.py``, with the same model, traces, seeds and
engine configs.

The mesh parts run on a (2, 4) ("data", "model") mesh of eight ranks, one
process a rank (``repro_torch.dist.launch.spawn_ranks``: gloo ranks on the
CPU with ``--cpu``; on the card by default, the eight ranks sharing it over
gloo). Every rank runs every part on the same params and traces, and
asserts what the JAX example asserts; rank 0 prints and exports the trace;
the parent then holds the ranks to one another.

1. Continuous batching through the paged cache: nine mixed-length
   requests arriving over time, four slots; tokens equal to the
   contiguous engine's.
2. The paging win: under a 96-token budget the paged pool runs more
   requests at once than the contiguous engine's two worst-case slots,
   with equal tokens.
3. Prefix sharing: a shared 21-token system prompt; every request past
   the first hits the trie, prefill work falls, tokens are equal.
3b. Speculative decoding: a CSB-pruned self-draft (rate 0.5) proposes
   4 tokens a round; part 1's tokens.
4. Fixed-batch ``generate``: 8 prompts of 16 tokens, 16 new tokens.
5. CSB-RNN frames: an LSTM 64 -> 128 with 16x16 blocks at rate 0.9, 32
   frames x batch 4, through ``rnn_serve_frames(mesh=)``: the 8 matrices
   are partitioned over "model" (kernel B3 at R = 4 on the card, its
   plain version on the CPU) and the batch over "data"; us/frame against
   the paper's 500 us realtime bar (on the card, eight ranks time-slicing
   one card: not a multi-GPU number).
6. Request-lifecycle tracing: part 1 again with ``repro_torch.obs`` on;
   tokens unchanged; rank 0 exports ``serve_trace.json`` (Chrome trace
   format) and prints the latency breakdown.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py [--cpu]
      (the card unless --cpu)
"""
import argparse
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.cells import init_params as cell_init, make_cell
from repro_torch.core import (
    CSBSpec, csb_masks, csb_project, padded_csb_from_dense,
)
from repro_torch.dist.launch import spawn_ranks
from repro_torch.kernels import csb_mvm, csb_sharded
from repro_torch.models import ModelConfig, init_params
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.summary import report
from repro_torch.serve import (
    EngineConfig, Request, generate, rnn_serve_frames, serve_continuous,
)

MESH = (2, 4)                  # ("data", "model"): JAX's 8 host devices
CFG = dict(name="serve-demo", mixer="attn", ffn="swiglu", n_layers=4,
           d_model=128, n_heads=4, n_kv=2, head_dim=32, d_ff=256,
           vocab=512, dtype="float32", remat=False)
PAGED = EngineConfig(n_slots=4, paged=True, page_size=8)
CACHE_LEN = 48                 # part 2: the long request's whole length
BUDGET = 2 * CACHE_LEN         # part 2: 96 tokens
SPEC = PAGED.replace(speculative=True, spec_k=4, draft_prune_rate=0.5)
GEN_SHAPE, GEN_NEW = (8, 16), 16
CELL = ("lstm", 64, 128)
CELL_SPEC = CSBSpec(bm=16, bn=16, prune_rate=0.9)     # 10x compression
FRAMES = (32, 4, 64)           # (frames, batch, in)
REALTIME_US = 500.0
TIMEOUT_S = 1200.0             # the ranks' deadline once they have joined


def serve_on_mesh(mesh, params, cfg, requests, config):
    """``serve_continuous`` on one rank of ``mesh`` (on the mesh's device
    type): the rank's {rid: tokens}, every rank's the same."""
    return serve_continuous(params, cfg, requests, config, mesh=mesh,
                            device=mesh.device_type).tokens


def request_traces(vocab: int) -> dict:
    """The JAX example's traces, drawn in its order from
    ``np.random.default_rng(7)``: part 1's nine mixed requests, part 2's
    long request and four short ones, part 3's shared-prompt requests."""
    rng = np.random.default_rng(7)
    mixed = [Request(rid=i, tokens=rng.integers(0, vocab,
                                                size=int(rng.integers(6, 20))),
                     max_new_tokens=int(rng.integers(8, 17)),
                     arrival=(i // 3) * 6) for i in range(9)]
    long_req = Request(rid=100, tokens=rng.integers(0, vocab, size=16),
                       max_new_tokens=32)
    shorts = [Request(rid=101 + i, tokens=rng.integers(0, vocab, size=8),
                      max_new_tokens=8) for i in range(4)]
    sys_prompt = rng.integers(0, vocab, size=21)    # 2 whole pages + 5
    shared = [Request(rid=200 + i, tokens=np.concatenate(
        [sys_prompt, rng.integers(0, vocab, size=int(rng.integers(2, 7)))]),
        max_new_tokens=int(rng.integers(6, 13)), arrival=(i // 3) * 4)
        for i in range(9)]
    return {"mixed": mixed, "budget": [long_req] + shorts,
            "shared": shared, "sys_prompt_len": len(sys_prompt)}


def cell_weights(seed: int = 2) -> tuple[dict, dict]:
    """Part 5's LSTM: dense weights from a seeded generator and their CSB
    form (``PaddedCSB`` for every matrix, on the host)."""
    cell = make_cell(*CELL)
    dense = cell_init(cell, torch.Generator().manual_seed(seed),
                      device="cpu")
    packed = {}
    for k, w in dense.items():
        if w.ndim == 2:
            rm, cm = csb_masks(w, CELL_SPEC)
            packed[k] = padded_csb_from_dense(
                csb_project(w, CELL_SPEC), CELL_SPEC.bm, CELL_SPEC.bn,
                row_mask=rm, col_mask=cm, device="cpu")
        else:
            packed[k] = w
    return dense, packed


def make_job(params=None, trace_path: str = "serve_trace.json") -> dict:
    """Everything the ranks need, drawn once on the host: the params
    (``init_params`` from a generator seeded 0 unless given, e.g. the JAX
    package's converted), the traces, part 4's prompts (seed 1), part 5's
    cell (seed 2) and frames (seed 3)."""
    cfg = ModelConfig(**CFG)
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    dense, packed = cell_weights()
    return {
        "params": params, "requests": request_traces(cfg.vocab),
        "prompts": torch.randint(0, cfg.vocab, GEN_SHAPE,
                                 generator=torch.Generator().manual_seed(1)),
        "cell_dense": dense, "cell": packed,
        "frames": torch.randn(FRAMES, generator=torch.Generator()
                              .manual_seed(3)),
        "trace_path": trace_path,
    }


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name()}, power limit not read"


def _run(res) -> dict:
    return {"tokens": res.tokens, "stats": res.stats, "wall_s": res.wall_s}


def batched_rank(mesh, job: dict) -> dict:
    """Every part on this rank of ``mesh``, asserting what the JAX example
    asserts; rank 0 prints and exports the trace. Returns each part's
    tokens and stats, part 5's outputs, final state, us/frame and the B3
    and B1 launches it made on this rank."""
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    dev = mesh.device_type
    cfg = ModelConfig(**CFG)
    params, reqs = job["params"], job["requests"]
    out = {}

    def serve(trace, config):
        return serve_continuous(params, cfg, trace, config, mesh=mesh,
                                device=dev)

    # -- 1. continuous batching: mixed lengths, arriving over time -------
    mixed = reqs["mixed"]
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
        f"{mesh.size()} ranks ({dev})")
    say(f"\n{len(mixed)} requests, prompt lens "
        f"{[r.prompt_len for r in mixed]}, arrivals "
        f"{[r.arrival for r in mixed]}, 4 slots, PAGED cache")
    res = serve(mixed, PAGED)
    st, pg = res.stats, res.stats["paging"]
    say(f"paged serve: {st['requests']} requests, "
        f"{st['generated_tokens']} tokens in {res.wall_s:.2f}s "
        f"({st['tokens_per_sec']:.1f} tok/s, occupancy "
        f"{st['occupancy']:.0%}, {st['prefills']} prefills over "
        f"{st['decode_steps']} decode steps, sharded={st['sharded']}, "
        f"bucketed_prefill={st['bucketed_prefill']})")
    say(f"  pages: peak {pg['peak_pages']}/{pg['n_pages']} x "
        f"{pg['page_size']} tokens, internal fragmentation "
        f"{pg['internal_fragmentation']:.1%}")
    contig = serve(mixed, EngineConfig(n_slots=4))
    assert res.tokens == contig.tokens, \
        "paged and contiguous engines must emit identical tokens"
    say("  paged tokens == contiguous tokens: verified")
    out["paged"], out["contiguous"] = _run(res), _run(contig)

    # -- 2. the paging win: same token budget, more concurrency ----------
    paged2 = serve(reqs["budget"], EngineConfig(
        n_slots=4, paged=True, page_size=8, cache_len=CACHE_LEN,
        pool_pages=BUDGET // 8))
    contig2 = serve(reqs["budget"], EngineConfig(
        n_slots=BUDGET // CACHE_LEN, cache_len=CACHE_LEN))
    assert paged2.tokens == contig2.tokens
    assert paged2.stats["peak_active"] > contig2.stats["peak_active"]
    say(f"\nsame {BUDGET}-token budget: contiguous fits "
        f"{contig2.stats['peak_active']} concurrent requests "
        f"({contig2.stats['decode_steps']} decode steps), paged fits "
        f"{paged2.stats['peak_active']} ({paged2.stats['decode_steps']} "
        f"steps) — identical outputs")
    out["budget_paged"], out["budget_contiguous"] = (_run(paged2),
                                                     _run(contig2))

    # -- 3. prefix sharing: a common system prompt across every request --
    shared_reqs = reqs["shared"]
    base = serve(shared_reqs, PAGED)
    shared = serve(shared_reqs, PAGED.replace(prefix_cache=True))
    assert shared.tokens == base.tokens, \
        "prefix sharing must not change a single output token"
    # every request past the first matches the system prompt in the trie
    assert shared.stats["prefix_hits"] == len(shared_reqs) - 1, shared.stats
    assert shared.stats["prefill_tokens"] < base.stats["prefill_tokens"]
    saved = base.stats["prefill_tokens"] - shared.stats["prefill_tokens"]
    say(f"\nshared {reqs['sys_prompt_len']}-token system prompt x "
        f"{len(shared_reqs)} requests, prefix_cache=True: "
        f"{shared.stats['prefix_hits']} trie hits, "
        f"{shared.stats['shared_pages']} pages mapped shared, "
        f"{shared.stats['paging']['cow_copies']} CoW copies")
    say(f"  prefill compute: {base.stats['prefill_tokens']} tokens without "
        f"sharing -> {shared.stats['prefill_tokens']} with "
        f"({saved} saved) — identical outputs")
    out["shared_base"], out["shared"] = _run(base), _run(shared)

    # -- 3b. speculative decoding: CSB-pruned self-draft + k-token verify
    spec = serve(mixed, SPEC)
    assert spec.tokens == res.tokens, \
        "speculative decoding must not change a single output token at T=0"
    sp = spec.stats["speculative"]
    say(f"\nspeculative decode (k={sp['spec_k']}, draft = target CSB-pruned "
        f"at {sp['draft_prune_rate']:.0%}): {sp['rounds']} verify rounds, "
        f"{sp['proposed']} drafted, {sp['accepted']} accepted "
        f"(acceptance {sp['acceptance_rate']:.0%}), "
        f"{spec.stats['generated_tokens'] / max(sp['rounds'], 1):.2f} "
        f"tokens per target step — identical outputs")
    out["speculative"] = _run(spec)

    # -- 4. fixed-batch LM serving ---------------------------------------
    prompts = job["prompts"]
    t0 = time.perf_counter()
    toks = generate(params, cfg, prompts, EngineConfig(max_new_tokens=GEN_NEW),
                    mesh=mesh, device=dev).cpu()
    dt = time.perf_counter() - t0
    assert toks.shape == (GEN_SHAPE[0], GEN_SHAPE[1] + GEN_NEW)
    assert torch.equal(toks[:, :GEN_SHAPE[1]], prompts)
    new_tokens = GEN_SHAPE[0] * GEN_NEW
    say(f"\nbatched generate: {toks.shape[0]} seqs x {toks.shape[1]} tokens "
        f"({new_tokens} new) in {dt:.2f}s -> {dt / new_tokens * 1e3:.1f} "
        f"ms/token ({dev})")
    out["generate"] = {"tokens": toks.numpy(), "wall_s": dt}

    # -- 5. CSB-RNN frame serving: B3 over "model", the batch over "data"
    cell = make_cell(*CELL)
    b3, b1 = csb_sharded.LAUNCHES, csb_mvm.LAUNCHES
    ys, state, us = rnn_serve_frames(cell, job["cell"], job["frames"],
                                     mesh=mesh, device=dev)
    ys = ys.cpu()
    b3, b1 = csb_sharded.LAUNCHES - b3, csb_mvm.LAUNCHES - b1
    assert ys.shape == (FRAMES[0], FRAMES[1], CELL[2])
    assert torch.isfinite(ys).all()
    where = ("the plain version on the CPU" if dev == "cpu" else
             f"eight ranks time-slicing one {card_line()}, not a multi-GPU "
             f"number" if dist.get_rank() == 0 else "")
    say(f"\nCSB-RNN frames (sharded mesh, {where}): {FRAMES[0]} frames x "
        f"batch {FRAMES[1]} -> {us:.1f} us/frame (realtime bar: "
        f"{REALTIME_US:.0f} us); B3 launches on rank 0: {b3}")
    out["frames"] = {"outputs": ys, "state": {k: v.cpu()
                                              for k, v in state.items()},
                     "us_per_frame": us, "b3_launches": b3,
                     "b1_launches": b1}

    # -- 6. request-lifecycle tracing ------------------------------------
    obs.enable_all()
    try:
        traced = serve(mixed, PAGED)
        path = (obs_trace.export_chrome(job["trace_path"])
                if dist.get_rank() == 0 else None)
    finally:
        obs.disable_all()
    assert traced.tokens == res.tokens          # tracing changes nothing
    st = traced.stats
    say(f"\ntraced re-run: compile {st['compile_time_s']:.2f}s (warm), "
        f"steady {st['steady_tokens_per_sec']:.1f} tok/s "
        f"(blended {st['tokens_per_sec']:.1f})")
    if path is not None:
        say(report(path))
        say(f"\nopen {path} in https://ui.perfetto.dev to see the "
            f"engine + per-request tracks")
    out["traced"] = _run(traced)
    out["trace_path"] = path
    return out


def main(argv=None, *, params=None) -> dict:
    """Spawn the mesh's ranks, run every part on each, hold the ranks to
    one another. ``params``: the LM's (default: drawn from a generator
    seeded 0). Returns the ranks' results (rank order), the job's
    prompts, part 5's dense and CSB cell weights and frames, and the wall
    time of the spawn."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    job = make_job(params)
    t0 = time.perf_counter()
    ranks = spawn_ranks(batched_rank, MESH, job, device=dev,
                        timeout_s=TIMEOUT_S)
    wall = time.perf_counter() - t0
    first = ranks[0]
    for r, got in enumerate(ranks[1:], start=1):
        for part in ("paged", "budget_paged", "shared", "speculative",
                     "traced"):
            assert got[part]["tokens"] == first[part]["tokens"], (r, part)
        assert np.array_equal(got["generate"]["tokens"],
                              first["generate"]["tokens"]), r
        assert torch.equal(got["frames"]["outputs"],
                           first["frames"]["outputs"]), r
    print(f"\n{len(ranks)} ranks agree on every part's tokens and frames; "
          f"wall {wall:.1f} s")
    print("done")
    return {"ranks": ranks, "prompts": job["prompts"],
            "cell_dense": job["cell_dense"], "cell": job["cell"],
            "frames": job["frames"], "wall_s": wall}


if __name__ == "__main__":
    main()

"""Rank programs of the mesh serving tests (tests/test_torch_serve_mesh*.py).

The spawned ranks import this module (numpy, torch and repro_torch only:
the test modules' parents alone import JAX). The configs and traces are
the JAX package's own mesh tests': tests/test_serve_paged.py,
test_serve_scheduler.py, test_speculative.py, test_disagg.py,
test_serve_prefix.py and test_paged_attn.py. A trace is a list of
``(rid, tokens, max_new_tokens, arrival)`` tuples, which each package
turns into its own ``Request``.

``serve_cases`` runs every case of a mesh on the rank, with the params
the parent carried across from JAX, and returns each case's tokens (and
stats) with the placements the run gave its pools and weights.
"""
import numpy as np
import torch

# the reference tests' configs (ModelConfig kwargs; the names do not
# change the numbers)
CFG = dict(name="tiny", mixer="attn", ffn="swiglu", n_layers=2, d_model=32,
           n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=50,
           dtype="float32", logit_chunk=16, remat=False)
ATTN = dict(CFG, name="tiny-pa-attn", n_heads=4)
MLA = dict(CFG, name="tiny-pa-mla", mixer="mla", kv_lora=16, q_lora=16,
           rope_head_dim=8)
HYB = dict(CFG, name="tiny-pa-hyb", family="hybrid", mixer="hybrid",
           d_state=8, ssd_headdim=16, ssd_chunk=4, ssd_expand=2, conv_k=4)
CONFIGS = {"cfg": CFG, "attn": ATTN, "mla": MLA, "hyb": HYB}

PAGED = dict(n_slots=2, paged=True, page_size=4)


def _fixed(seed, sizes, max_new, arrivals, vocab=50):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=n), m, a)
            for i, (n, m, a) in enumerate(zip(sizes, max_new, arrivals))]


def spec_trace(seed=3, n=6):
    """tests/test_speculative.py's ``_trace``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, 50, size=int(rng.integers(4, 12)))
        out.append((i, toks, int(rng.integers(3, 9)), (i // 2) * 2))
    return out


def skewed_trace(seed=5, n=8):
    """tests/test_disagg.py's ``_skewed_trace``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = (int(rng.integers(9, 14)) if i % 3 == 0
                else int(rng.integers(4, 8)))
        toks = rng.integers(0, 50, size=plen)
        out.append((i, toks, int(rng.integers(3, 7)), (i // 2) * 3))
    return out


def shared_trace(seed=7, n=6):
    """tests/test_serve_prefix.py's ``_shared_trace``."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, 50, size=9)
    out = []
    for i in range(n):
        tail = rng.integers(0, 50, size=int(rng.integers(1, 5)))
        out.append((i, np.concatenate([sys_p, tail]), 4, (i // 3) * 2))
    return out


def cases(mesh_shape) -> dict:
    """{name: dict(cfg, run, engine config kwargs, trace or prompt)} of
    one mesh. ``run``: "serve" (``serve_continuous``), "disagg",
    "router" (``Router(2)``), "generate" or "vecpos" (one paged decode
    step at a (B,) position). The "*-split" cases give the pool an odd
    page count, so that with the scratch page it splits over a "data"
    axis of 2 (the divisibility guard replicates the others)."""
    paged_trace = _fixed(6, (5, 9, 6, 7), [5, 4, 6, 5], [0, 0, 2, 4])
    kern_trace = _fixed(6, (5, 9, 6), [5, 4, 6], [0, 0, 2])
    out = {
        # test_serve_paged.py::test_paged_sharded_matches_unsharded
        "paged": dict(cfg="cfg", run="serve", ecfg=PAGED, trace=paged_trace),
        "paged-split": dict(cfg="cfg", run="serve",
                            ecfg=dict(PAGED, pool_pages=9),
                            trace=paged_trace),
        # test_serve_scheduler.py::test_continuous_sharded_matches_unsharded
        "contiguous": dict(cfg="cfg", run="serve", ecfg=dict(n_slots=2),
                           trace=paged_trace),
        # test_serve_scheduler.py::test_generate_sharded_matches_unsharded
        "generate": dict(cfg="cfg", run="generate",
                         ecfg=dict(max_new_tokens=5)),
        "generate-spec": dict(cfg="cfg", run="generate",
                              ecfg=dict(max_new_tokens=5, speculative=True,
                                        spec_k=3, draft_prune_rate=0.3)),
        # test_serve_paged.py::test_paged_vector_pos_matches_scalar
        "vecpos": dict(cfg="cfg", run="vecpos"),
        # test_speculative.py::test_serve_spec_sharded_matches_unsharded
        "spec": dict(cfg="cfg", run="serve",
                     ecfg=dict(PAGED, speculative=True, spec_k=3,
                               draft_prune_rate=0.3),
                     trace=spec_trace(seed=6)),
        # test_disagg.py::test_disagg_sharded_matches_unsharded
        "disagg": dict(cfg="cfg", run="disagg", ecfg=PAGED,
                       trace=skewed_trace(seed=6, n=6)),
        # test_disagg.py::test_router_parity_sharded_2x4
        "router": dict(cfg="cfg", run="router", ecfg=PAGED,
                       trace=skewed_trace(seed=11, n=6)),
        # test_paged_attn.py::test_serve_kernel_sharded_matches_unsharded
        "kernel-attn": dict(cfg="attn", run="serve",
                            ecfg=dict(PAGED, use_kernel=True),
                            trace=kern_trace),
        "kernel-attn-split": dict(cfg="attn", run="serve",
                                  ecfg=dict(PAGED, use_kernel=True,
                                            pool_pages=9),
                                  trace=kern_trace),
        # test_paged_attn.py::test_serve_kernel_sharded_mla_matches_...
        "kernel-mla": dict(cfg="mla", run="serve",
                           ecfg=dict(PAGED, use_kernel=True),
                           trace=_fixed(8, (5, 9, 6), [5, 4, 6],
                                        [0, 0, 2])),
        "gather-mla": dict(cfg="mla", run="serve", ecfg=PAGED,
                           trace=_fixed(8, (5, 9, 6), [5, 4, 6], [0, 0, 2])),
    }
    # test_serve_prefix.py::test_prefix_parity_sharded
    for mixer in ("cfg", "mla"):
        for on in (False, True):
            out[f"prefix-{mixer}-{'on' if on else 'off'}"] = dict(
                cfg=mixer, run="serve",
                ecfg=dict(PAGED, prefix_cache=on), trace=shared_trace())
    if mesh_shape == (2, 2):
        # test_paged_attn.py::test_hybrid_sharded_decode_drift_2x4
        out["hybrid-generate"] = dict(cfg="hyb", run="generate",
                                      ecfg=dict(max_new_tokens=12))
    return out


def vecpos_inputs():
    """The inputs of test_serve_paged.py's vector-position case beside
    JAX's (built by the parent): 3 slots, pages of 4, 6 pages."""
    return dict(n_slots=3, psz=4, n_pages=6, pos=4)


def _requests(trace):
    from repro_torch.serve import Request
    return [Request(rid=i, tokens=np.asarray(t), max_new_tokens=m,
                    arrival=a) for i, t, m, a in trace]


def _placements(tree) -> list:
    """The placements of every DTensor leaf, in the tree's order."""
    from repro_torch.dist.api import is_dtensor
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif is_dtensor(t):
            out.append(tuple(t.placements))
    walk(tree)
    return out


def serve_case(mesh, case: dict, params_np: dict, extra: dict) -> dict:
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import ModelConfig
    from repro_torch.serve import (
        EngineConfig, Router, generate, serve_continuous,
        serve_disaggregated,
    )
    from repro_torch.serve import engine as eng

    cfg = ModelConfig(**CONFIGS[case["cfg"]])
    params = lm_params_from_numpy(params_np, device="cpu")
    run = case["run"]
    if run == "vecpos":
        return vecpos_case(mesh, cfg, params, extra)
    ecfg = EngineConfig(**case["ecfg"])
    # the placements the run gives its caches and weights
    seen = {"pools": [], "weights": None}
    place_cache = eng._Runner.place_cache

    def spy(self, cache, paged=False):
        out = place_cache(self, cache, paged=paged)
        if paged:
            seen["pools"].extend(_placements(out))
        if seen["weights"] is None:
            seen["weights"] = _placements(self.params["layers"][0])
        return out

    eng._Runner.place_cache = spy
    try:
        if run == "generate":
            out = generate(params, cfg, extra["prompt"], ecfg, mesh=mesh,
                           device="cpu")
            res = {"tokens": out.cpu().numpy()}
        else:
            reqs = _requests(case["trace"])
            if run == "serve":
                r = serve_continuous(params, cfg, reqs, ecfg, mesh=mesh,
                                     device="cpu")
            elif run == "disagg":
                r = serve_disaggregated(params, cfg, reqs, ecfg, mesh=mesh,
                                        device="cpu")
            else:
                r = Router(2, ecfg).serve(params, cfg, reqs, mesh=mesh,
                                          device="cpu")
            res = {"tokens": {k: list(map(int, v))
                              for k, v in r.tokens.items()},
                   "stats": _plain_stats(r.stats)}
    finally:
        eng._Runner.place_cache = place_cache
    res["pools"] = seen["pools"]
    res["weights"] = seen["weights"]
    return res


def _plain_stats(stats: dict) -> dict:
    keep = ("sharded", "paged", "prefix_hits", "shared_pages",
            "prefill_tokens", "handoffs", "replicas", "replica_requests")
    out = {k: stats[k] for k in keep if k in stats}
    if "per_replica" in stats:
        out["per_replica_sharded"] = [s["sharded"]
                                      for s in stats["per_replica"]]
    if "speculative" in stats:
        out["accepted"] = stats["speculative"]["accepted"]
    return out


def vecpos_case(mesh, cfg, params, extra: dict) -> dict:
    """One paged decode step at the (B,) position vector on the mesh,
    from the pools, table and tokens JAX's scalar-position step took."""
    from repro_torch.dist.api import whole
    from repro_torch.serve.engine import _Runner
    runner = _Runner(params, cfg, mesh)
    cache = runner.place_cache(
        {k: torch.as_tensor(v) for k, v in extra["cache"].items()},
        paged=True)
    pools = _placements(cache)
    toks = torch.as_tensor(extra["tokens"])
    n = toks.shape[0]
    with torch.no_grad():
        lg, cache = runner.step_paged(
            cache, toks, torch.full((n,), extra["pos"], dtype=torch.int64),
            torch.as_tensor(extra["table"]))
    return {"logits": lg.numpy(),
            "cache": {k: whole(v).numpy() for k, v in cache.items()},
            "pools": pools}


def prefill_placements(mesh, params_np: dict, tokens) -> dict:
    """The prompt pass's cache placements on the mesh (the "kv_cache" and
    "mla_cache" tags), for CFG and MLA: the whole prompt's (``name``) and
    a partial prefill's of its last half against the first half
    (``name-partial``)."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.dist.api import is_dtensor
    from repro_torch.models import ModelConfig
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import _Runner
    out, attn = {}, L.context_attention
    for name in ("cfg", "mla"):
        cfg = ModelConfig(**CONFIGS[name])
        runner = _Runner(lm_params_from_numpy(params_np[name],
                                              device="cpu"), cfg, mesh)
        toks = torch.as_tensor(tokens)[None]
        half = toks.shape[1] // 2
        with torch.no_grad():
            _, cache = runner.prefill(toks)
            ctx = {k: v[:, :, :half]
                   for k, v in runner.place_slot_cache(cache).items()}
            seen = []

            def spy(*a, **kw):
                o = attn(*a, **kw)
                if is_dtensor(a[0]):       # the call on the mesh's tensors
                    seen.append(tuple(o.placements))
                return o
            L.context_attention = spy
            try:
                _, part = runner.prefill_partial(toks[:, half:], ctx, half,
                                                 toks.shape[1] - half - 1)
            finally:
                L.context_attention = attn
        out[name] = {k: tuple(v.placements) for k, v in cache.items()}
        out[f"{name}-context-attention"] = seen
        out[f"{name}-partial"] = {k: tuple(v.placements)
                                  for k, v in part.items()}
    return out


def decode_pins(mesh, params_np: dict, hyb_np: dict, tokens) -> dict:
    """The placements of the attention output entering the out-projection
    in one contiguous and one paged (B2) decode step of ATTN on the mesh:
    JAX's "residual" pin (``fallback="replicate"``) before ``wo``."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.dist.api import is_dtensor
    from repro_torch.models import ModelConfig
    from repro_torch.models import layers as L
    from repro_torch.serve import EngineConfig, serve_continuous
    from repro_torch.serve.engine import _Runner
    cfg = ModelConfig(**ATTN)
    runner = _Runner(lm_params_from_numpy(params_np, device="cpu"), cfg,
                     mesh)
    wo = {id(lp["mixer"]["wo"]) for lp in runner.params["layers"]}
    seen, dense = {"contiguous": [], "paged": []}, L.dense
    where = ["contiguous"]

    def spy(x, w):
        if id(w) in wo and x.shape[1] == 1:     # a decode step's, no prompt's
            seen[where[0]].append(tuple(x.placements) if is_dtensor(x)
                                  else None)
        return dense(x, w)

    L.dense = spy
    try:
        toks = torch.as_tensor(tokens)[None]
        with torch.no_grad():
            _, cache = runner.prefill(toks)
            cache = runner.place_cache(runner.place_slot_cache(cache))
            # the last prompt position written again: a step's layout
            runner.step(cache, toks[:, -1:], toks.shape[1] - 1)
        where[0] = "paged"
        serve_continuous(runner.params, cfg, _requests(
            [(0, np.asarray(tokens), 2, 0)]),
            EngineConfig(**dict(PAGED, use_kernel=True)), mesh=mesh,
            device="cpu")
    finally:
        L.dense = dense
    seen["ssm"] = ssm_pin(mesh, hyb_np, tokens)
    return seen


def ssm_pin(mesh, params_np: dict, tokens) -> list:
    """HYB's SSD decode step on the mesh: the placements of the SSM
    state it returns (JAX's ``replicated(ssm_state)``: the heads whole)
    beside those of the cache's state (heads over "model")."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import ModelConfig
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import _Runner
    cfg = ModelConfig(**HYB)
    runner = _Runner(lm_params_from_numpy(params_np, device="cpu"), cfg,
                     mesh)
    seen, block = [], L.ssd_block_apply

    def spy(p, x, cfg, conv_state=None, ssm_state=None, decode=False):
        out = block(p, x, cfg, conv_state, ssm_state, decode)
        if decode:
            seen.append((tuple(ssm_state.placements),
                         tuple(out[2].placements)))
        return out

    L.ssd_block_apply = spy
    try:
        toks = torch.as_tensor(tokens)[None]
        with torch.no_grad():
            _, cache = runner.prefill(toks)
            cache = runner.place_cache(runner.place_slot_cache(cache))
            runner.step(cache, toks[:, -1:], toks.shape[1] - 1)
    finally:
        L.ssd_block_apply = block
    return seen


def pool_part_ops(mesh) -> dict:
    """``take_whole`` and ``write_parts`` on a pool (L, N, P, KV, D) split
    over "data" on its pages and over "model" on its heads at once,
    against ``index_select`` and an indexed write of the whole pool
    (taken before the write): {"take": max abs gap, "write": max abs
    gap, "placements": the pool's}."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.dist.api import take_whole, write_parts
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 3, 4, 5, generator=g)
    dx = distribute_tensor(x.clone(), mesh, (Shard(1), Shard(3)))
    idx = torch.tensor([6, 1, 3, 6])
    took = take_whole(dx, 1, idx)
    value = torch.randn(2, 2, 3, 4, 5, generator=g)
    write_parts(dx, (torch.tensor([0, 5]),), value, first=1)
    x[:, [0, 5]] = value
    want = x.index_select(1, idx)
    return {"take": (float((took - want).abs().max())
                     if took.shape == want.shape else float("inf")),
            "write": float((dx.full_tensor() - x).abs().max()),
            "placements": tuple(dx.placements)}


def serve_cases(mesh, mesh_shape, params_np: dict, extras: dict) -> dict:
    """Every case of ``cases(mesh_shape)`` on this rank, one intra-op
    thread: {name: result}, and the prompt pass's placements."""
    torch.set_num_threads(1)      # the test workers share the host's cores
    out = {}
    for name, case in cases(mesh_shape).items():
        out[name] = serve_case(mesh, case, params_np[case["cfg"]],
                               extras.get(name, {}))
    out["prefill-placements"] = prefill_placements(
        mesh, params_np, extras["prefill-tokens"])
    out["pool-part-ops"] = pool_part_ops(mesh)
    out["decode-pins"] = decode_pins(mesh, params_np["attn"],
                                     params_np["hyb"],
                                     extras["prefill-tokens"])
    return out


"""``examples/serve_router_torch.py`` on a (2, 4) ("data", "model") mesh of
eight gloo ranks against the JAX package's unsharded run of the same parts
(the mesh paths are held to JAX's one-device run, as the reference's own
mesh tests hold them).

One spawn of the example's rank function runs parts 1 and 2 on every
rank, in a module fixture, one intra-op thread a rank, on JAX's
``init_params(PRNGKey(0), cfg)`` converted; JAX runs the same parts in the
parent meanwhile. Every run's tokens on every rank equal JAX's, and so do
its handoffs, prefix hits, prefill tokens and the router's requests per
replica; part 3 (``simulate_replicas``, host only) gives JAX's numbers.
The last test runs the script end to end on the CPU. The ranks import the
example, never this module's JAX.
"""
import concurrent.futures
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist.launch import spawn_ranks

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import serve_router_torch as ex  # noqa: E402

RUNS = ("single", "disagg", "shared_single", "shared_disagg", "routed")
STATS = ("handoffs", "handoff_pages", "prefix_hits", "prefill_tokens",
         "generated_tokens", "replicas", "replica_requests")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank(mesh, params: dict) -> dict:
    """The example's rank function on one intra-op thread (the test
    workers share the host's cores)."""
    torch.set_num_threads(1)
    return ex.router_rank(mesh, params)


def _jax_side(params_np: dict) -> dict:
    """JAX's unsharded run of parts 1 and 2 on the example's traces."""
    import jax
    import jax.numpy as jnp
    from repro.models import ModelConfig
    from repro.serve import (
        EngineConfig, Request, Router, serve_continuous, serve_disaggregated,
    )
    cfg = ModelConfig(**ex.CFG)
    params = jax.tree.map(jnp.asarray, params_np)
    traces = {k: [Request(rid=r.rid, tokens=np.asarray(r.tokens),
                          max_new_tokens=r.max_new_tokens, arrival=r.arrival)
                  for r in v]
              for k, v in ex.request_traces(cfg.vocab).items()}
    econf = EngineConfig(n_slots=4, paged=True, page_size=8)
    pconf = econf.replace(prefix_cache=True)
    runs = {
        "single": serve_continuous(params, cfg, traces["mixed"], econf),
        "disagg": serve_disaggregated(params, cfg, traces["mixed"], econf),
        "shared_single": serve_continuous(params, cfg, traces["shared"],
                                          pconf),
        "shared_disagg": serve_disaggregated(params, cfg, traces["shared"],
                                             pconf),
        "routed": Router(2, econf, policy="least_loaded",
                         engine="disagg").serve(params, cfg,
                                                traces["mixed"]),
    }
    return {k: {"tokens": v.tokens, "stats": v.stats}
            for k, v in runs.items()}


@pytest.fixture(scope="module")
def runs():
    import jax
    from repro.models import ModelConfig, init_params

    from repro_torch.convert import lm_params_from_numpy
    params_np = jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), ModelConfig(**ex.CFG)))
    params = lm_params_from_numpy(params_np, device="cpu")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, _rank, ex.MESH, params,
                          device="cpu", timeout_s=600)
        want = _jax_side(params_np)
        ranks = fut.result()
    return {"ranks": ranks, "jax": want}


@pytest.mark.parametrize("name", RUNS)
def test_tokens_match_jax(runs, name):
    want = runs["jax"][name]["tokens"]
    for r, got in enumerate(runs["ranks"]):
        assert got[name]["tokens"] == want, f"rank {r} {name}"


@pytest.mark.parametrize("name", RUNS)
def test_stats_match_jax(runs, name):
    want = runs["jax"][name]["stats"]
    for r, got in enumerate(runs["ranks"]):
        st = got[name]["stats"]
        assert {k: st.get(k) for k in STATS} == {
            k: want.get(k) for k in STATS}, f"rank {r} {name}"
        sharded = (st["sharded"] if "sharded" in st
                   else all(s["sharded"] for s in st["per_replica"]))
        assert sharded, name


def test_asserted_claims(runs):
    """The example's claims, on JAX's run and every rank's: the prefix
    cache is hit through the tiers, and the router used both replicas."""
    for res in (runs["jax"], *runs["ranks"]):
        assert res["shared_disagg"]["stats"]["prefix_hits"] > 0
        assert res["disagg"]["stats"]["handoffs"] == len(
            res["disagg"]["tokens"])
        assert all(n > 0 for n in res["routed"]["stats"]["replica_requests"])


@pytest.mark.parametrize("policy", ex.POLICIES)
def test_simulate_replicas_matches_jax(policy):
    from repro.serve import make_arrival_trace, simulate_replicas
    trace = make_arrival_trace(np.random.default_rng(3), 24,
                               vocab=ex.CFG["vocab"], mean_gap_steps=0.5,
                               deadline_slack=4.0, step_time_us=1.0)
    mine = ex.arrival_trace(ex.CFG["vocab"])
    assert [(r.rid, list(r.tokens), r.max_new_tokens, r.arrival,
             r.deadline_us) for r in mine] == [
        (r.rid, list(r.tokens), r.max_new_tokens, r.arrival, r.deadline_us)
        for r in trace]
    want = simulate_replicas(trace, 2, policy=policy, n_slots=4,
                             step_time_us=1.0)
    assert ex.simulate(ex.CFG["vocab"])[policy] == want


def test_script_runs_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_router_torch.py"),
         "--cpu"], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "done", out.stdout[-2000:]
    assert "8 ranks agree" in out.stdout

"""``examples/serve_batched_torch.py`` on a (2, 4) ("data", "model") mesh of
eight gloo ranks against the JAX package's unsharded run of the same parts
(the mesh paths are held to JAX's one-device run, as the reference's own
mesh tests hold them).

One spawn of the example's rank function runs every part on every rank,
in a module fixture, one intra-op thread a rank, on JAX's
``init_params(PRNGKey(0), cfg)`` converted; JAX runs its parts in the
parent meanwhile, on the example's traces, prompts, cell weights and
frames. Every part's tokens on every rank equal JAX's, and so do the
stats the example asserts on; part 5's outputs and final state (the
sharded CSB path's plain version over "model" = 4, the batch over
"data" = 2) are within tests/test_torch_csb_sharded.py's 1e-5 of JAX's
unsharded ``rnn_serve_frames``. The ranks import the example, never this
module's JAX.
"""
import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist.launch import spawn_ranks

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import serve_batched_torch as ex  # noqa: E402

FRAME_TOL = 1e-5               # tests/test_torch_csb_sharded.py's bound
# the serve runs, each part's (the traced re-run is part 1's trace again)
RUNS = {"paged": ("mixed", ex.PAGED),
        "contiguous": ("mixed", ex.EngineConfig(n_slots=4)),
        "budget_paged": ("budget", ex.EngineConfig(
            n_slots=4, paged=True, page_size=8, cache_len=ex.CACHE_LEN,
            pool_pages=ex.BUDGET // 8)),
        "budget_contiguous": ("budget", ex.EngineConfig(
            n_slots=ex.BUDGET // ex.CACHE_LEN, cache_len=ex.CACHE_LEN)),
        "shared_base": ("shared", ex.PAGED),
        "shared": ("shared", ex.PAGED.replace(prefix_cache=True)),
        "speculative": ("mixed", ex.SPEC),
        "traced": ("mixed", ex.PAGED)}
STATS = ("peak_active", "prefix_hits", "prefill_tokens", "generated_tokens",
         "decode_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank(mesh, job: dict) -> dict:
    """The example's rank function on one intra-op thread (the test
    workers share the host's cores)."""
    torch.set_num_threads(1)
    return ex.batched_rank(mesh, job)


def _jax_side(params_np: dict, job: dict) -> dict:
    """JAX's unsharded run of every part on the job's inputs."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.cells import make_cell
    from repro.core import (
        CSBSpec, csb_masks, csb_project, padded_csb_from_dense,
    )
    from repro.models import ModelConfig
    from repro.serve import (
        EngineConfig, Request, generate, rnn_serve_frames, serve_continuous,
    )
    cfg = ModelConfig(**ex.CFG)
    params = jax.tree.map(jnp.asarray, params_np)
    out = {}
    for name, (trace, conf) in RUNS.items():
        reqs = [Request(rid=r.rid, tokens=np.asarray(r.tokens),
                        max_new_tokens=r.max_new_tokens, arrival=r.arrival)
                for r in job["requests"][trace]]
        res = serve_continuous(params, cfg, reqs,
                               EngineConfig(**dataclasses.asdict(conf)))
        out[name] = {"tokens": res.tokens, "stats": res.stats}
    out["generate"] = np.asarray(generate(
        params, cfg, jnp.asarray(job["prompts"].numpy()),
        EngineConfig(max_new_tokens=ex.GEN_NEW)))
    spec = CSBSpec(bm=ex.CELL_SPEC.bm, bn=ex.CELL_SPEC.bn,
                   prune_rate=ex.CELL_SPEC.prune_rate)
    csb = {}
    for k, w in job["cell_dense"].items():
        w = jnp.asarray(w.numpy())
        if w.ndim == 2:
            rm, cm = csb_masks(w, spec)
            csb[k] = padded_csb_from_dense(
                np.asarray(csb_project(w, spec)), spec.bm, spec.bn,
                row_mask=np.asarray(rm), col_mask=np.asarray(cm))
        else:
            csb[k] = w
    ys, st, _ = rnn_serve_frames(make_cell(*ex.CELL), csb,
                                 jnp.asarray(job["frames"].numpy()))
    out["frames"] = {"outputs": np.asarray(ys),
                     "state": {k: np.asarray(v) for k, v in st.items()}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.models import ModelConfig, init_params

    from repro_torch.convert import lm_params_from_numpy
    params_np = jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), ModelConfig(**ex.CFG)))
    trace = tmp_path_factory.mktemp("serve_batched") / "serve_trace.json"
    job = ex.make_job(lm_params_from_numpy(params_np, device="cpu"),
                      str(trace))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, _rank, ex.MESH, job, device="cpu",
                          timeout_s=900)
        want = _jax_side(params_np, job)
        ranks = fut.result()
    return {"ranks": ranks, "jax": want, "trace": trace}


@pytest.mark.parametrize("name", tuple(RUNS))
def test_tokens_match_jax(runs, name):
    want = runs["jax"][name]["tokens"]
    for r, got in enumerate(runs["ranks"]):
        assert got[name]["tokens"] == want, f"rank {r} {name}"
        assert got[name]["stats"]["sharded"], name


@pytest.mark.parametrize("name", tuple(RUNS))
def test_stats_match_jax(runs, name):
    want = runs["jax"][name]["stats"]
    keys = [k for k in STATS if k in want]
    assert "peak_active" in keys and "prefill_tokens" in keys, keys
    for r, got in enumerate(runs["ranks"]):
        st = got[name]["stats"]
        assert {k: st.get(k) for k in STATS} == {
            k: want.get(k) for k in STATS}, f"rank {r} {name}"


def test_paging_prefix_and_speculative_claims(runs):
    """What the example asserts, read from JAX's run too: the paged pool
    runs more requests under the budget, every request past the first
    hits the trie, and prefill work falls."""
    for res in (runs["jax"], *runs["ranks"]):
        assert (res["budget_paged"]["stats"]["peak_active"]
                > res["budget_contiguous"]["stats"]["peak_active"])
        n = len(res["shared"]["tokens"])
        assert res["shared"]["stats"]["prefix_hits"] == n - 1
        assert (res["shared"]["stats"]["prefill_tokens"]
                < res["shared_base"]["stats"]["prefill_tokens"])
    want = runs["jax"]["speculative"]["stats"]["speculative"]
    for got in runs["ranks"]:
        sp = got["speculative"]["stats"]["speculative"]
        assert {k: sp[k] for k in ("rounds", "proposed", "accepted")} == \
            {k: want[k] for k in ("rounds", "proposed", "accepted")}


def test_generate_matches_jax(runs):
    for r, got in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(got["generate"]["tokens"],
                                      runs["jax"]["generate"],
                                      err_msg=f"rank {r}")


def test_frames_match_jax(runs):
    want = runs["jax"]["frames"]
    for r, got in enumerate(runs["ranks"]):
        fr = got["frames"]
        np.testing.assert_allclose(fr["outputs"].numpy(), want["outputs"],
                                   rtol=FRAME_TOL, atol=FRAME_TOL,
                                   err_msg=f"rank {r} outputs")
        assert fr["state"].keys() == want["state"].keys()
        for k, v in want["state"].items():
            np.testing.assert_allclose(fr["state"][k].numpy(), v,
                                       rtol=FRAME_TOL, atol=FRAME_TOL,
                                       err_msg=f"rank {r} state {k}")
        # the plain version on the CPU: no kernel launched
        assert fr["b3_launches"] == fr["b1_launches"] == 0
        assert fr["us_per_frame"] > 0


def test_trace_exported_by_rank_zero_alone(runs):
    import json
    paths = [got["trace_path"] for got in runs["ranks"]]
    assert paths[0] == str(runs["trace"]) and not any(paths[1:]), paths
    events = json.loads(runs["trace"].read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"serve/decode_step", "serve/req/ttft"} <= names, names

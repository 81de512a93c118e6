"""The JAX package's unsharded runs of the mesh serving cases
(tests/_torch_serve_mesh_jobs.py), and the checks that hold the ranks'
results to them, for tests/test_torch_serve_mesh*.py.

Imported by the test modules' parents only: the spawned ranks never
import this module (it imports JAX inside its functions).
"""
import numpy as np

import _torch_serve_mesh_jobs as jobs


def params_np() -> dict:
    """Each config's ``PRNGKey(0)`` params (the reference tests' seed), as
    numpy trees in JAX's layout."""
    import jax
    from repro.models import ModelConfig
    from repro.models import init_params as lm_init
    return {name: jax.tree.map(np.asarray, lm_init(jax.random.PRNGKey(0),
                                                   ModelConfig(**kw)))
            for name, kw in jobs.CONFIGS.items()}


def extras() -> dict:
    """The inputs that JAX draws for the port's cases: the prompts of the
    generate cases (test_serve_scheduler.py's ``PRNGKey(7)`` batch and
    test_paged_attn.py's hybrid prompt), the vector-position case's pools,
    table and tokens, and a prompt for the prompt-pass placements."""
    import jax
    import jax.numpy as jnp
    from repro.models import ModelConfig, init_paged_cache
    from repro.serve import PagePool
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (4, 6),
                                           0, 50))
    hyb = np.random.default_rng(13).integers(0, 50, size=7)[None]
    v = jobs.vecpos_inputs()
    pool = PagePool(v["psz"], v["n_pages"], v["n_slots"], 2)
    for s in range(v["n_slots"]):
        pool.reserve(s, 8)
        pool.ensure(s, 5)
    cache = init_paged_cache(ModelConfig(**jobs.CFG), v["n_pages"], v["psz"],
                             v["n_slots"], jnp.float32)
    cache = jax.tree.map(
        lambda a: jax.random.normal(
            jax.random.PRNGKey(a.size % 97), a.shape).astype(a.dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, cache)
    toks = jax.random.randint(jax.random.PRNGKey(2), (v["n_slots"], 1), 0,
                              50)
    return {
        "generate": {"prompt": prompt},
        "generate-spec": {"prompt": prompt},
        "hybrid-generate": {"prompt": hyb},
        "vecpos": {"cache": jax.tree.map(np.asarray, cache),
                   "table": np.asarray(pool.device_table()),
                   "tokens": np.asarray(toks), "pos": v["pos"]},
        "prefill-tokens": np.random.default_rng(4).integers(0, 50, size=8),
    }


def _requests(trace):
    from repro.serve import Request
    return [Request(rid=i, tokens=np.asarray(t), max_new_tokens=m,
                    arrival=a) for i, t, m, a in trace]


def run(name: str, case: dict, params: dict, extra: dict):
    """JAX's unsharded result of one case: generated tokens ({rid:
    list} or the (B, S + new) array), or the vector case's
    scalar-position logits and pools. ``params``: numpy trees per
    config."""
    import jax
    import jax.numpy as jnp
    from repro.models import ModelConfig, decode_step_paged
    from repro.serve import (
        EngineConfig, generate, serve_continuous, serve_disaggregated,
    )
    cfg = ModelConfig(**jobs.CONFIGS[case["cfg"]])
    p = jax.tree.map(jnp.asarray, params[case["cfg"]])
    if case["run"] == "vecpos":
        cache = jax.tree.map(jnp.asarray, extra["cache"])
        lg, c = decode_step_paged(p, cache, jnp.asarray(extra["tokens"]),
                                  extra["pos"], jnp.asarray(extra["table"]),
                                  cfg)
        return {"logits": np.asarray(lg),
                "cache": jax.tree.map(np.asarray, c)}
    ecfg = EngineConfig(**case["ecfg"])
    if case["run"] == "generate":
        return np.asarray(generate(p, cfg, jnp.asarray(extra["prompt"]),
                                   ecfg))
    reqs = _requests(case["trace"])
    # the router's tokens are one engine's over the whole trace
    fn = serve_disaggregated if case["run"] == "disagg" else serve_continuous
    res = fn(p, cfg, reqs, ecfg)
    return {k: list(map(int, v)) for k, v in res.tokens.items()}


def run_all(mesh_shape, params: dict, extra: dict) -> dict:
    return {name: run(name, case, params, extra.get(name, {}))
            for name, case in jobs.cases(mesh_shape).items()}


def check_case(runs, mesh, name):
    """Every rank's result of ``name`` against JAX's, and alike."""
    res = runs["ranks"][mesh]
    got, want = res[0][name], runs["jax"][name]
    if name == "vecpos":
        for r in res:
            np.testing.assert_allclose(r[name]["logits"], want["logits"],
                                       rtol=2e-5, atol=2e-5)
            for k in want["cache"]:
                np.testing.assert_allclose(r[name]["cache"][k],
                                           want["cache"][k], rtol=2e-5,
                                           atol=2e-5)
        return got
    for r in res:
        if isinstance(want, dict):
            assert r[name]["tokens"] == want, f"mesh {mesh} {name}"
        else:
            np.testing.assert_array_equal(r[name]["tokens"], want,
                                          err_msg=f"mesh {mesh} {name}")
    if "stats" in got:
        st = got["stats"]
        assert st.get("sharded", all(st.get("per_replica_sharded", [])))
    return got


def check_pool_part_ops(runs, mesh):
    """``take_whole`` and ``write_parts`` on a pool split over pages and
    heads give the whole pool's answers exactly, on every rank."""
    from torch.distributed.tensor import Shard
    for r in runs["ranks"][mesh]:
        got = r["pool-part-ops"]
        assert got["placements"] == (Shard(1), Shard(3)), got
        assert got["take"] == 0.0 and got["write"] == 0.0, got


def check_placements(runs, mesh):
    """A split pool where "data" is 2, split weights where "model" is 2;
    the prompt pass's cache tags."""
    from torch.distributed.tensor import Replicate, Shard
    data, model = mesh
    for r in runs["ranks"][mesh]:
        for name in ("paged-split", "kernel-attn-split"):
            pools = r[name]["pools"]
            assert pools, name
            want = Shard(1) if data == 2 else Replicate()
            assert all(p[0] == want for p in pools), (name, pools)
        # layer 0's weights: split over "model" where it is 2 (the
        # norms stay whole), over nothing else
        weights = r["paged"]["weights"]
        assert all(p[0] == Replicate() for p in weights)
        split = [p[1] for p in weights if p[1] != Replicate()]
        assert len(split) == (len(weights) - 2 if model == 2 else 0), weights
        pre = r["prefill-placements"]
        time_split = Shard(2) if model == 2 else Replicate()
        for what in ("", "-partial"):
            assert pre["cfg" + what]["k"][1] == time_split, what
            assert pre["cfg" + what]["v"][1] == time_split, what
            assert pre["mla" + what]["c_kv"][1] == time_split, what
        # the partial prefill's attention on operands made whole, its
        # result replicated (JAX's replicated concat operands)
        for name in ("cfg", "mla"):
            seen = pre[f"{name}-context-attention"]
            assert seen and all(p == (Replicate(),) * 2 for p in seen), seen
        # the decode attention's output pinned to the "residual" layout
        # (a DTensor, batch over "data" where the batch divides, whole
        # over "model") before the out-projection, on both decode paths
        pins = dict(r["decode-pins"])
        ssm = pins.pop("ssm")
        for path, seen in pins.items():
            assert seen and all(p is not None and p[1] == Replicate()
                                for p in seen), (path, seen)
        # SSD's decode step returns the SSM state with its heads whole
        # (JAX's replicated(ssm_state)); the cache splits them over
        # "model" where it is 2
        assert ssm and all(new[1] == Replicate() for _, new in ssm), ssm
        assert all(old[1] == (Shard(1) if model == 2 else Replicate())
                   for old, _ in ssm), ssm

"""The router (``serve/router.py``) against the JAX package's.

Its host half — ``route``, ``simulate_replicas``, ``make_arrival_trace``
— is numpy on the port's own ``Request`` and ``simulate_admission``: on
the same inputs it gives JAX's outputs exactly. ``Router(2)`` over
``serve_continuous`` and over ``serve_disaggregated`` gives, greedy,
JAX's single-engine tokens on tests/test_disagg.py's trace, with JAX's
``PRNGKey(0)`` parameters carried across. Also: the validation errors,
each replica's generator restarted from the caller's state (JAX hands
every replica the same key), and ``repro_torch.serve`` exporting JAX's
names."""
import jax
import numpy as np
import pytest
import torch

import repro.serve as J
import repro_torch.serve as T
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro.serve import router as j_router
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ModelConfig
from repro_torch.serve import (
    EngineConfig, Request, Router, make_arrival_trace, route,
    serve_continuous, simulate_replicas,
)

CFG = dict(name="tiny-disagg", mixer="attn", ffn="swiglu", n_layers=2,
           d_model=32, n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=50,
           dtype="float32", logit_chunk=16, remat=False)
PAGED = dict(n_slots=2, paged=True, page_size=4)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JModelConfig(**CFG), ModelConfig(**CFG)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _skewed_trace(make, seed=5, n=8):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(9, 14)) if i % 3 == 0 else \
            int(rng.integers(4, 8))
        reqs.append(make(rid=i, tokens=rng.integers(0, 50, size=plen),
                         max_new_tokens=int(rng.integers(3, 7)),
                         arrival=(i // 2) * 3))
    return reqs


def _both_traces(seed, n, **kw):
    """The same arrival trace as JAX's and as the port's Requests."""
    return (j_router.make_arrival_trace(np.random.default_rng(seed), n,
                                        **kw),
            make_arrival_trace(np.random.default_rng(seed), n, **kw))


def _rids(assignment):
    return [[r.rid for r in a] for a in assignment]


# ---------------------------------------------------------------------------
# the host half, against JAX's outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(mean_gap_steps=0.5, deadline_slack=2.0, step_time_us=2.0),
    dict(vocab=50, prompt_lo=2, prompt_hi=40, new_lo=1, new_hi=5,
         mean_gap_steps=3.0),
], ids=["defaults", "deadlines", "wide"])
def test_make_arrival_trace_matches_jax(kw):
    jt, tt = _both_traces(11, 12, **kw)
    assert len(jt) == len(tt) == 12
    for a, b in zip(jt, tt):
        assert (a.rid, a.max_new_tokens, a.arrival, a.deadline_us) == (
            b.rid, b.max_new_tokens, b.arrival, b.deadline_us)
        assert a.tokens.dtype == b.tokens.dtype
        assert np.array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
@pytest.mark.parametrize("n_replicas,n_slots,step", [
    (2, 2, 1.0), (3, 1, 1.0), (2, 2, [1.0, 10.0]), (4, 3, [1, 2, 3, 4]),
], ids=["2x2", "3x1", "slow-replica", "4-hetero"])
def test_route_matches_jax(policy, n_replicas, n_slots, step):
    jt, tt = _both_traces(3, 20, mean_gap_steps=0.5)
    want = J.route(jt, n_replicas, policy=policy, n_slots=n_slots,
                   step_time_us=step)
    got = route(tt, n_replicas, policy=policy, n_slots=n_slots,
                step_time_us=step)
    assert _rids(got) == _rids(want)


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
@pytest.mark.parametrize("deadlines", [False, True])
def test_simulate_replicas_matches_jax(policy, deadlines):
    kw = dict(mean_gap_steps=0.25, step_time_us=2.0,
              deadline_slack=2.0 if deadlines else None)
    jt, tt = _both_traces(5, 16, **kw)
    for step in (2.0, [1.0, 5.0]):
        want = J.simulate_replicas(jt, 2, policy=policy, n_slots=2,
                                   step_time_us=step)
        got = simulate_replicas(tt, 2, policy=policy, n_slots=2,
                                step_time_us=step)
        assert got == want
    assert (got["slo_attainment"] is None) == (not deadlines)


def test_least_loaded_avoids_slow_replica():
    """A 10x slower replica receives fewer requests (as in JAX's test)."""
    reqs = [Request(rid=i, tokens=np.zeros(4, np.int64), max_new_tokens=8,
                    arrival=0) for i in range(8)]
    out = route(reqs, 2, policy="least_loaded", n_slots=2,
                step_time_us=[1.0, 10.0])
    assert len(out[0]) > len(out[1])


def test_route_and_router_validation():
    reqs = [Request(rid=i, tokens=np.zeros(4, np.int64), max_new_tokens=4,
                    arrival=i) for i in range(6)]
    assert [len(a) for a in route(reqs, 3, policy="round_robin")] == [2] * 3
    with pytest.raises(ValueError, match="policy"):
        route(reqs, 2, policy="weighted")
    with pytest.raises(ValueError, match="replica"):
        route(reqs, 0)
    with pytest.raises(ValueError, match="entries"):
        route(reqs, 2, step_time_us=[1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="policy"):
        Router(2, policy="weighted")
    with pytest.raises(ValueError, match="engine"):
        Router(2, engine="sharded")
    with pytest.raises(ValueError, match="entries"):
        Router(2, step_time_us=[1.0])


def test_router_assign_and_simulate_match_jax():
    jt, tt = _both_traces(8, 10, mean_gap_steps=0.5, deadline_slack=3.0)
    kw = dict(policy="least_loaded", step_time_us=[1.0, 3.0])
    jr = J.Router(2, J.EngineConfig(**PAGED), **kw)
    tr = Router(2, EngineConfig(**PAGED), **kw)
    assert _rids(tr.assign(tt)) == _rids(jr.assign(jt))
    assert tr.simulate(tt) == jr.simulate(jt)


# ---------------------------------------------------------------------------
# the executing router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["continuous", "disagg"])
def test_router_two_replicas_matches_single_engine(tiny, engine):
    """Greedy: every rid's tokens equal JAX's single engine's, and JAX's
    router's; both replicas take requests."""
    jcfg, tcfg, jp, tp = tiny
    single = J.serve_continuous(jp, jcfg, _skewed_trace(J.Request),
                                J.EngineConfig(**PAGED))
    jres = J.Router(2, J.EngineConfig(**PAGED), engine=engine).serve(
        jp, jcfg, _skewed_trace(J.Request))
    res = Router(2, EngineConfig(**PAGED), engine=engine).serve(
        tp, tcfg, _skewed_trace(Request), device="cpu")
    assert res.tokens == {k: list(v) for k, v in single.tokens.items()}
    assert res.stats["replicas"] == 2 and res.stats["engine"] == engine
    assert res.stats["replica_requests"] == jres.stats["replica_requests"]
    assert sum(res.stats["replica_requests"]) == 8
    assert all(n > 0 for n in res.stats["replica_requests"])
    assert res.stats["generated_tokens"] == jres.stats["generated_tokens"]
    assert len(res.per_replica) == 2


@pytest.mark.parametrize("engine", ["continuous", "disagg"])
def test_router_restarts_the_generator_per_replica(tiny, engine):
    """Temperature > 0: each replica draws from a generator in the
    caller's starting state, as if it ran alone with it; the caller's
    generator is left as it was."""
    _, tcfg, _, tp = tiny
    cfg = EngineConfig(temperature=0.9, **PAGED)
    router = Router(2, cfg, engine=engine)
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    res = router.serve(tp, tcfg, _skewed_trace(Request), generator=gen,
                       device="cpu")
    assert torch.equal(gen.get_state(), state)
    fn = T.serve_disaggregated if engine == "disagg" else serve_continuous
    for sub in router.assign(_skewed_trace(Request)):
        alone = fn(tp, tcfg, sub, cfg, device="cpu",
                   generator=torch.Generator().manual_seed(7))
        assert {r.rid: res.tokens[r.rid] for r in sub} == alone.tokens


def test_router_mesh_raises(tiny):
    """``mesh=`` passes through to each replica's engine, which takes a
    DeviceMesh (tests/test_torch_serve_mesh*.py route on one); anything
    else raises."""
    _, tcfg, _, tp = tiny
    with pytest.raises(TypeError, match="DeviceMesh"):
        Router(2, EngineConfig(**PAGED)).serve(tp, tcfg, [], mesh=object(),
                                               device="cpu")


def test_serve_exports_match_jax():
    """``repro_torch.serve`` exports JAX's names, all of them bound
    (``shard_cell_params`` among them)."""
    assert set(T.__all__) == set(J.__all__)
    assert len(T.__all__) == len(set(T.__all__))
    for name in T.__all__:
        assert getattr(T, name) is not None
    assert T.POLICIES == J.POLICIES

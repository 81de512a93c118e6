"""The port's optimizers, schedules, global-norm clipping and int8
gradient compression (``repro_torch.optim``, ``repro_torch.dist.compress``)
against the JAX package's on the same inputs, on the CPU.

The trees hold a decoder's stacked layers as JAX holds them ((L, d)
norms, (L, d_in, d_out) weights); the port gets them as its per-layer
list (``convert.lm_params_from_numpy``) and is compared restacked
(``convert.params_to_numpy``)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro_torch import optim as TO
from repro_torch.convert import (
    lm_params_from_numpy, opt_state_from_numpy, opt_state_to_numpy,
    params_to_numpy,
)
from repro_torch.dist import compress as TC

# repro.dist exports a function named compress: import the module itself
JC = importlib.import_module("repro.dist.compress")

L, D, DIN, DOUT, V = 3, 8, 6, 10, 12
OPTIMIZERS = [("sgd", {}), ("sgd", {"nesterov": True}), ("adamw", {}),
              ("adafactor", {})]
# SGD is the same fp32 ops in the same order: equal. AdamW: the fp32
# sqrt/division of XLA and of torch may round an ulp apart (|p| <= ~5, so
# 1e-6 is a few ulps). Adafactor: its row/column means sum in another
# order, and the rsqrt of the factored estimate moves the update by up to
# ~1e-7 relative: 1e-6 absolute after three steps.
TOL = {"sgd": 0.0, "adamw": 1e-6, "adafactor": 1e-6}


def _tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": f(V, D), "final_norm": f(D),
            "layers": {"norm1": f(L, D), "ffn": {"w_up": f(L, DIN, DOUT)}}}


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _port(t):
    return lm_params_from_numpy(t, device="cpu")


def _close(a_tree, b_tree, tol):
    a, b = jax.tree.leaves(a_tree), jax.tree.leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.shape(x) == np.shape(y)
        np.testing.assert_allclose(np.asarray(y, np.float64),
                                   np.asarray(x, np.float64), rtol=0,
                                   atol=tol)


def _run(name, kw, wd, steps=3, lr=0.05):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    jo, to = JO.get_optimizer(name, **kw), TO.get_optimizer(name, **kw)
    jp, tp = _jax(p0), _port(p0)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(_jax(g), js, jp, lr, wd)
        tp, ts = to.update(_port(g), ts, tp, lr, wd)
    return jp, js, tp, ts


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=["sgd", "sgd_nesterov", "adamw", "adafactor"])
def test_update_matches_jax_over_three_steps(name, kw, wd):
    jp, js, tp, ts = _run(name, kw, wd)
    _close(jax.tree.map(np.asarray, jp), params_to_numpy(tp), TOL[name])
    st = opt_state_to_numpy(ts)
    _close(jax.tree.map(np.asarray, js.inner), st["inner"], TOL[name])
    assert int(st["step"]) == int(js.step) == 3


def test_adafactor_statistics_run_over_the_stacked_leaf():
    """A layer's (d,) norm is an (L, d) leaf in JAX: factored, its column
    statistic a mean over the layers, its update clipped by the RMS of
    the whole stack. Given the same layers as separate (d,) and
    (d_in, d_out) leaves, Adafactor computes another update."""
    jp, js, tp, ts = _run("adafactor", {}, 0.0)
    assert set(js.inner["layers"]["norm1"]) == {"r", "c"}
    assert ts.inner["layers"]["norm1"]["r"].shape == (L,)
    assert ts.inner["layers"]["norm1"]["c"].shape == (D,)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]

    def split(t):   # each layer a leaf of its own: what the port must not do
        return {**{k: torch.from_numpy(v) for k, v in t.items()
                   if k != "layers"},
                **{f"l{i}": {"norm1": torch.from_numpy(
                    t["layers"]["norm1"][i].copy()),
                    "w_up": torch.from_numpy(
                        t["layers"]["ffn"]["w_up"][i].copy())}
                   for i in range(L)}}

    to = TO.adafactor()
    sp = split(p0)
    ss = to.init(sp)
    for g in grads:
        sp, ss = to.update(split(g), ss, sp, 0.05)
    want = np.asarray(jp["layers"]["norm1"])
    per_layer = np.stack([sp[f"l{i}"]["norm1"].numpy() for i in range(L)])
    assert np.abs(per_layer - want).max() > 1e-3
    np.testing.assert_allclose(params_to_numpy(tp)["layers"]["norm1"], want,
                               rtol=0, atol=TOL["adafactor"])


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=["sgd", "sgd_nesterov", "adamw", "adafactor"])
def test_state_converts_both_ways(name, kw):
    """JAX's OptState after three steps -> the port's (the moments' layers
    split into the port's list; Adafactor's kept stacked) -> back."""
    jp, js, tp, _ = _run(name, kw, 0.0)
    to = TO.get_optimizer(name, **kw)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), to.init(tp),
                              device="cpu")
    if name == "adamw":
        assert isinstance(ts.inner["m"]["layers"], list)
    back = opt_state_to_numpy(ts)
    _close(jax.tree.map(np.asarray, js.inner), back["inner"], 0.0)
    assert int(back["step"]) == 3
    # one more step from the converted state, in both packages
    g = _tree(np.random.default_rng(5))
    jp2, _ = JO.get_optimizer(name, **kw).update(_jax(g), js, jp, 0.05)
    tp2, _ = to.update(_port(g), ts, tp, 0.05)
    _close(jax.tree.map(np.asarray, jp2), params_to_numpy(tp2), TOL[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_params_round_once(dtype):
    """A bf16 weight steps in fp32 and rounds once to bf16, as in JAX."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal((4, 6)).astype(np.float32)
    g = rng.standard_normal((4, 6)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jo, to = JO.adamw(), TO.adamw()
    jp = {"w": jnp.asarray(p, jd)}
    tp = {"w": torch.from_numpy(p).to(getattr(torch, dtype))}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):
        jp, js = jo.update({"w": jnp.asarray(g, jd)}, js, jp, 0.01)
        tp, ts = to.update({"w": torch.from_numpy(g).to(tp["w"].dtype)},
                           ts, tp, 0.01)
    assert tp["w"].dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tp["w"].float().numpy(),
                               np.asarray(jp["w"], np.float32), rtol=0,
                               atol=1e-6 if dtype == "float32" else 0)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    t = _tree(rng)
    jn = float(JO.optimizers.global_norm(_jax(t)))
    tn = float(TO.global_norm(_port(t)))
    # fp32 sums of ~400 squares in another order
    assert abs(tn - jn) <= 1e-6 * jn
    for max_norm in (0.5, 1e3):
        jc = JO.clip_by_global_norm(_jax(t), max_norm)
        tc = TO.clip_by_global_norm(_port(t), max_norm)
        _close(jax.tree.map(np.asarray, jc), params_to_numpy(tc), 1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    c = TO.clip_by_global_norm(g, 1.0)
    assert abs(float(torch.linalg.norm(c["a"])) - 1.0) < 1e-5


@pytest.mark.parametrize("opt_fn", [TO.sgd, TO.adamw, TO.adafactor])
def test_optimizers_reduce_quadratic(opt_fn):
    opt = opt_fn()
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = opt.init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, state = opt.update(g, state, params, 0.05)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


@pytest.mark.parametrize("which", ["constant", "cosine_decay",
                                   "linear_warmup_cosine"])
def test_schedules_match_jax(which):
    """float32 throughout, as JAX computes them: within 2 ulps at every
    step (XLA's and torch's fp32 cos may round an ulp or two apart near
    its zero; the rest is the same fp32 ops; constant and warm-up steps
    are equal)."""
    args = {"constant": (3e-4,), "cosine_decay": (1e-3, 17, 0.1),
            "linear_warmup_cosine": (1e-3, 5, 23, 0.05)}[which]
    jf = getattr(JO, which)(*args)
    tf = getattr(TO, which)(*args)
    for step in range(30):
        want = np.float32(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_array_max_ulp(np.float32(got), want, 2)
        if which == "constant" or (which == "linear_warmup_cosine"
                                   and step < 5):
            assert np.float32(got) == want
        assert np.float32(tf(step)) == np.float32(got)


def test_compress_matches_jax():
    """The int8 codes are equal, the scales and residuals within 1 ulp;
    a stacked leaf has one scale over all its layers."""
    rng = np.random.default_rng(3)
    g1, g2 = _tree(rng), _tree(rng)
    jr = JC.compress_init(_jax(g1))
    tr = TC.compress_init(_port(g1))
    for g in (g1, g2):
        jcmp, jr = JC.compress(_jax(g), jr)
        tcmp, tr = TC.compress(_port(g), tr)
    jl = jax.tree.leaves(jcmp, is_leaf=lambda x: isinstance(x, JC.Compressed))
    layers = tcmp["layers"]
    tl = [tcmp["embed"], tcmp["final_norm"]] + [
        [layers[i]["ffn"]["w_up"] for i in range(L)],
        [layers[i]["norm1"] for i in range(L)]]
    for j, t in zip(jl, tl):
        if isinstance(t, list):
            assert len({float(c.scale) for c in t}) == 1
            q = np.stack([c.q.numpy() for c in t])
            scale = t[0].scale
        else:
            q, scale = t.q.numpy(), t.scale
        assert q.dtype == np.int8
        np.testing.assert_array_equal(q, np.asarray(j.q))
        np.testing.assert_array_max_ulp(np.float32(scale),
                                        np.asarray(j.scale), 1)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jr)),
                    jax.tree.leaves(params_to_numpy(tr))):
        np.testing.assert_array_max_ulp(b, a, 1)
    jd = JC.decompress(jcmp)
    td = TC.decompress(tcmp)
    _close(jax.tree.map(np.asarray, jd), params_to_numpy(td), 0.0)
    assert TC.compression_ratio(_port(g1)) == pytest.approx(
        JC.compression_ratio(_jax(g1)))


def test_compress_refuses_a_mismatched_residual():
    g = {"w": torch.zeros(3), "b": torch.zeros(2)}
    with pytest.raises(ValueError, match="compress_init"):
        TC.compress(g, {"w": torch.zeros(3)})


def test_error_feedback_is_unbiased_over_steps():
    gen = torch.Generator().manual_seed(1)
    res = TC.compress_init({"w": torch.zeros(32)})
    total_true, total_sent = torch.zeros(32), torch.zeros(32)
    for _ in range(50):
        g = {"w": torch.randn(32, generator=gen) * 0.01}
        comp, res = TC.compress(g, res)
        total_true += g["w"]
        total_sent += TC.decompress(comp)["w"]
    torch.testing.assert_close(total_sent + res["w"], total_true, rtol=1e-4,
                               atol=1e-5)


def test_compress_round_half_to_even():
    """``torch.round`` rounds half to even, as ``jnp.round``: 0.5 -> 0,
    1.5 -> 2, -2.5 -> -2 on a grid where the max maps to 127."""
    e = torch.tensor([0.5, 1.5, -2.5, 127.0])
    comp, res = TC.compress({"w": e}, TC.compress_init({"w": e}))
    assert comp["w"].q.tolist() == [0, 2, -2, 127]
    assert res["w"].tolist() == [0.5, -0.5, -0.5, 0.0]

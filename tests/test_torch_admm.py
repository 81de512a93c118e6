"""Port of core/admm.py, core/progressive.py and the pruning baselines of
core/pruning.py: the same trees go through both packages. fp32 states
and penalties agree within 1e-6 with equal masks; bf16 ``admm_init`` and
``admm_finalize`` are bit-equal to the JAX package's (jitted) projection,
as tests/test_torch_pruning.py's C1 case holds it; the baselines are
equal; ``ProgressivePruner`` takes JAX's sequence of rates on
tests/test_admm.py's three scenarios; and the port meets
tests/test_admm.py's own bounds on its convergence case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro_torch import core as T

TOL = 1e-6
SHAPES = {"w": (32, 32), "b": (16,), "blk": {"v": (24, 40), "u": (16, 48)},
          "cells": [(40, 24), (8,)]}


def _specs(pkg):
    s = pkg.CSBSpec
    return {"w": s(8, 8, 0.5), "b": None,
            "blk": {"v": s(8, 8, 0.75), "u": None},
            "cells": [s(16, 8, 0.6), None]}


def _trees(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def make(shape):
        if isinstance(shape, dict):
            return {k: make(v) for k, v in shape.items()}
        if isinstance(shape, list):
            return [make(v) for v in shape]
        return (rng.normal(size=shape) / 4).astype(dtype)

    host = make(SHAPES)
    return (jax.tree.map(jnp.asarray, host),
            _map(torch.from_numpy, host))


def _map(fn, t):
    if isinstance(t, dict):
        return {k: _map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_map(fn, v) for v in t]
    return None if t is None else fn(t)


def _assert_close(got, want, tol=TOL, masks=True):
    """Port tree vs JAX tree (None where JAX has None)."""
    gl = jax.tree.leaves(_map(lambda t: t.float().numpy(), got))
    wl = jax.tree.leaves(jax.tree.map(
        lambda a: np.asarray(a, np.float32), want))
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if tol:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(g, w)
        if masks:
            np.testing.assert_array_equal(g != 0, w != 0)


def _step(tp, jp, seed):
    """The same perturbation of both trees' pruned leaves."""
    rng = np.random.default_rng(seed)
    d = {"w": rng.normal(size=(32, 32)), "v": rng.normal(size=(24, 40)),
         "c": rng.normal(size=(40, 24))}
    d = {k: (v / 8).astype(np.float32) for k, v in d.items()}
    jp = {**jp, "w": jp["w"] + d["w"],
          "blk": {**jp["blk"], "v": jp["blk"]["v"] + d["v"]},
          "cells": [jp["cells"][0] + d["c"], jp["cells"][1]]}
    tp = {**tp, "w": tp["w"] + torch.from_numpy(d["w"]),
          "blk": {**tp["blk"], "v": tp["blk"]["v"] + torch.from_numpy(d["v"])},
          "cells": [tp["cells"][0] + torch.from_numpy(d["c"]),
                    tp["cells"][1]]}
    return tp, jp


def test_admm_cycle_matches_jax():
    """init, penalty, two updates, residual and finalize on a nested tree
    of dicts and a list, unpruned leaves among them."""
    jp, tp = _trees(0)
    js, ts = _specs(J), _specs(T)
    jst, tst = J.admm_init(jp, js, rho=0.02), T.admm_init(tp, ts, rho=0.02)
    assert tst.rho == 0.02 and tst.z["b"] is None and tst.u["blk"]["u"] is None
    _assert_close(tst.z, jst.z)
    _assert_close(tst.u, jst.u, masks=False)
    for k in range(2):
        tp, jp = _step(tp, jp, k)
        for a, b in ((T.admm_penalty(tp, tst, ts),
                      J.admm_penalty(jp, jst, js)),
                     (T.residual_norm(tp, tst, ts),
                      J.residual_norm(jp, jst, js))):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(float(a), float(b), rtol=TOL)
        jst, tst = J.admm_update(jp, jst, js), T.admm_update(tp, tst, ts)
        _assert_close(tst.z, jst.z)
        _assert_close(tst.u, jst.u, masks=False)
        np.testing.assert_allclose(float(T.residual_norm(tp, tst, ts)),
                                   float(J.residual_norm(jp, jst, js)),
                                   rtol=TOL)
    jf, tf = J.admm_finalize(jp, js), T.admm_finalize(tp, ts)
    _assert_close(tf, jf)
    assert tf["b"] is tp["b"] and tf["cells"][1] is tp["cells"][1]


def test_penalty_gradient_matches_jax_and_leaves_the_state_constant():
    """Z and U are constants of the penalty, as under jax.grad."""
    jp, tp = _trees(1)
    js, ts = _specs(J), _specs(T)
    tp = _map(lambda t: t.requires_grad_(), tp)
    tst = T.admm_init(tp, ts, rho=0.5)
    assert not any(t.requires_grad for t in jax.tree.leaves(
        _map(lambda t: t, tst.z)) + jax.tree.leaves(_map(lambda t: t, tst.u)))
    tp2, jp2 = _step(tp, jp, 5)
    jst = J.admm_update(jp2, J.admm_init(jp, js, rho=0.5), js)
    tst = T.admm_update(tp2, tst, ts)
    assert not tst.z["w"].requires_grad and not tst.u["w"].requires_grad
    T.admm_penalty(tp2, tst, ts).backward()
    g = jax.grad(lambda p: J.admm_penalty(p, jst, js))(jp2)
    # unpruned leaves are outside the penalty's graph; JAX gives zeros
    _assert_close(_map(lambda t: torch.zeros_like(t) if t.grad is None
                       else t.grad, tp), g, masks=False)
    assert tp["b"].grad is None


@pytest.mark.parametrize("shape,rate", [((64, 96), 0.5), ((96, 64), 0.9),
                                        ((128, 256), 0.3)])
def test_bf16_init_and_finalize_equal_jax_jitted(shape, rate):
    """bf16 weights keep their dtype through init and finalize, and the
    projection equals JAX's jitted one bit for bit (the C1 lesson)."""
    w = np.random.default_rng(sum(shape)).normal(size=shape) / 8
    wj = jnp.asarray(w, jnp.bfloat16)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(
        torch.bfloat16)
    js, ts = {"w": J.CSBSpec(32, 32, rate)}, {"w": T.CSBSpec(32, 32, rate)}
    jst, tst = J.admm_init({"w": wj}, js), T.admm_init({"w": wt}, ts)
    assert tst.z["w"].dtype == tst.u["w"].dtype == torch.bfloat16
    _assert_close(tst.z, jst.z, tol=0)
    jf, tf = J.admm_finalize({"w": wj}, js), T.admm_finalize({"w": wt}, ts)
    assert tf["w"].dtype == torch.bfloat16
    _assert_close(tf, jf, tol=0)
    # the first update widens to fp32, as JAX's does
    tu = T.admm_update({"w": wt}, tst, ts)
    ju = J.admm_update({"w": wj}, jst, js)
    assert tu.z["w"].dtype == tu.u["w"].dtype == torch.float32
    _assert_close(tu.z, ju.z, tol=0)


BASELINES = {
    "magnitude (40, 50) 0.9": ("magnitude_project", (40, 50), (0.9,)),
    "magnitude (37, 23) 0.5": ("magnitude_project", (37, 23), (0.5,)),
    "bank (8, 128) 0.75 bank 64": ("bank_balanced_project", (8, 128),
                                   (0.75, 64)),
    "bank (8, 100) 0.6 bank 32": ("bank_balanced_project", (8, 100),
                                  (0.6, 32)),
    "row-column (32, 32) 0.5": ("row_column_project", (32, 32), (0.5,)),
    "row-column (48, 20) 0.7": ("row_column_project", (48, 20), (0.7,)),
}


@pytest.mark.parametrize("case", BASELINES)
def test_baselines_equal_jax(case):
    name, shape, args = BASELINES[case]
    w = np.random.default_rng(len(case)).normal(size=shape).astype(
        np.float32)
    want = np.asarray(getattr(J, name)(jnp.asarray(w), *args))
    got = getattr(T, name)(torch.from_numpy(w), *args)
    np.testing.assert_array_equal(got.numpy(), want)


def test_magnitude_ties_keep_jax_entries():
    """Equal magnitudes: the stable sort keeps the entries JAX keeps."""
    w = np.tile(np.array([1.0, -1.0, 2.0, 0.0], np.float32), (4, 3))
    for rate in (0.25, 0.5, 0.8):
        np.testing.assert_array_equal(
            T.magnitude_project(torch.from_numpy(w), rate).numpy(),
            np.asarray(J.magnitude_project(jnp.asarray(w), rate)))


def _trajectory(pkg, threshold, limit=60):
    ctl = pkg.ProgressivePruner(init_pr=0.25, init_step=0.25)
    out = []
    while not ctl.done and len(out) < limit:
        s = ctl.state
        out.append((s.prune_rate, s.step, s.flag, s.best_lossless_rate))
        ctl.update(ctl.prune_rate <= threshold + 1e-9)
    return out, ctl.done, ctl.best_lossless_rate, ctl.best_compression


@pytest.mark.parametrize("threshold", [0.8125, 0.55, 0.15])
def test_progressive_sequence_equals_jax(threshold):
    """tests/test_admm.py's three scenarios of Algorithm 1's outer loop."""
    got = _trajectory(T, threshold)
    assert got == _trajectory(J, threshold)
    assert len(got[0]) > 2
    with pytest.raises(ValueError):
        T.ProgressivePruner(init_pr=1.0)


def test_admm_drives_weights_to_pattern():
    """tests/test_admm.py's convergence case, run through the port with
    autograd, held to that test's bounds."""
    target = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (32, 32))))
    spec = T.CSBSpec(bm=8, bn=8, prune_rate=0.5)
    specs = {"w": spec}
    w = torch.zeros(32, 32, requires_grad=True)
    state = T.admm_init({"w": w}, specs, rho=2.0)
    res_early = None
    for epoch in range(80):
        for _ in range(10):
            loss = (torch.sum((w - target) ** 2)
                    + T.admm_penalty({"w": w}, state, specs))
            (g,) = torch.autograd.grad(loss, [w])
            with torch.no_grad():
                w -= 0.05 * g
        state = T.admm_update({"w": w}, state, specs)
        if epoch == 9:
            res_early = float(T.residual_norm({"w": w}, state, specs))
    res = float(T.residual_norm({"w": w}, state, specs))
    assert res <= res_early * 1.02, (res_early, res)
    final = T.admm_finalize({"w": w}, specs)["w"]
    assert float(T.density(final)) <= 0.55
    assert torch.equal(T.csb_project(final, spec), final)
    f_admm = float(torch.sum((final - target) ** 2))
    f_opt = float(torch.sum((T.csb_project(target, spec) - target) ** 2))
    assert f_admm <= 1.35 * f_opt, (f_admm, f_opt)


def test_spec_tree_map_refuses_an_unknown_node():
    with pytest.raises(TypeError, match="spec tree node"):
        T.spec_tree_map(lambda s, w: w, {"w": 3}, {"w": torch.ones(2)})

"""Port of cells/: the same graphs, and ``cell_apply``/``rnn_scan`` on
identical weights match the JAX package for all four cell kinds, dense
and CSB, at 2e-5 (the bound of tests/test_cells.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cells as J
from repro.core import CSBSpec, csb_masks, csb_project, padded_csb_from_dense
from repro.core.csb_format import PaddedCSB as JPaddedCSB
from repro_torch import cells as T
from repro_torch.convert import cell_params_from_numpy
from repro_torch.core import PaddedCSB

KINDS = ["lstm", "gru", "lstmp", "ligru"]


def to_numpy(params):
    """JAX cell params -> the converter's numpy form."""
    out = {}
    for k, w in params.items():
        if isinstance(w, JPaddedCSB):
            out[k] = {**{a: np.asarray(getattr(w, a)) for a in
                         ("vals", "row_idx", "col_idx", "m", "n")},
                      "shape": w.shape, "grid": w.grid, "block": w.block}
        else:
            out[k] = np.asarray(w)
    return out


def csb_params(params, bm=8, bn=8, rate=0.5):
    spec = CSBSpec(bm=bm, bn=bn, prune_rate=rate)
    out = {}
    for k, w in params.items():
        if w.ndim == 2:
            rm, cm = csb_masks(w, spec)
            out[k] = padded_csb_from_dense(
                np.asarray(csb_project(w, spec)), bm, bn,
                row_mask=np.asarray(rm), col_mask=np.asarray(cm))
        else:
            out[k] = w
    return out


def jax_params(cell, seed, csb):
    params = J.init_params(cell, jax.random.PRNGKey(seed))
    # nonzero biases, so the bias op is exercised
    params = {k: (w + 0.1 if w.ndim == 1 else w) for k, w in params.items()}
    return csb_params(params) if csb else params


@pytest.mark.parametrize("kind", KINDS)
def test_graphs_equal(kind):
    cj = J.make_cell(kind, 12, 24, proj_dim=16)
    ct = T.make_cell(kind, 12, 24, proj_dim=16)
    assert [(o.name, o.kind, o.inputs, o.shape) for o in ct.ops] == \
        [(o.name, o.kind, o.inputs, o.shape) for o in cj.ops]
    assert (ct.state_vars, ct.next_state, ct.output) == \
        (cj.state_vars, cj.next_state, cj.output)
    assert ct.param_count() == cj.param_count()


@pytest.mark.parametrize("csb", [False, True], ids=["dense", "csb"])
@pytest.mark.parametrize("kind", KINDS)
def test_cell_apply_matches_jax(kind, csb):
    cj = J.make_cell(kind, 16, 32, proj_dim=24)
    ct = T.make_cell(kind, 16, 32, proj_dim=24)
    pj = jax_params(cj, 2, csb)
    pt = cell_params_from_numpy(to_numpy(pj), device="cpu")
    assert any(isinstance(w, PaddedCSB) for w in pt.values()) == csb
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16)).astype(np.float32)
    stj = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
           for k, v in J.init_state(cj, (2,)).items()}
    stt = {k: torch.from_numpy(np.array(v)) for k, v in stj.items()}
    yj, nj = J.cell_apply(cj, pj, jnp.asarray(x), stj)
    yt, nt = T.cell_apply(ct, pt, torch.from_numpy(x), stt)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5,
                               atol=2e-5)
    assert nt.keys() == nj.keys()
    for k in nj:
        np.testing.assert_allclose(nt[k].numpy(), np.asarray(nj[k]),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_rnn_scan_matches_jax(kind):
    cj = J.make_cell(kind, 12, 24, proj_dim=16)
    ct = T.make_cell(kind, 12, 24, proj_dim=16)
    pj = jax_params(cj, 4, csb=True)
    pt = cell_params_from_numpy(to_numpy(pj), device="cpu")
    xs = np.random.default_rng(5).normal(size=(4, 2, 12)).astype(np.float32)
    ysj, fj = J.rnn_scan(cj, pj, jnp.asarray(xs))
    yst, ft = T.rnn_scan(ct, pt, torch.from_numpy(xs))
    assert yst.shape == ysj.shape == (4, 2, 16 if kind == "lstmp" else 24)
    np.testing.assert_allclose(yst.numpy(), np.asarray(ysj), rtol=2e-5,
                               atol=2e-5)
    for k in fj:
        np.testing.assert_allclose(ft[k].numpy(), np.asarray(fj[k]),
                                   rtol=2e-5, atol=2e-5)


def test_init_state_lstmp_h_takes_projection_width():
    st = T.init_state(T.make_cell("lstmp", 12, 24, proj_dim=16), (3,),
                      device="cpu")
    assert st["h"].shape == (3, 16) and st["c"].shape == (3, 24)
    jst = J.init_state(J.make_cell("lstmp", 12, 24, proj_dim=16), (3,))
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in jst.items()}


def test_init_params_seeded_shapes():
    cell = T.make_cell("gru", 8, 16)
    a = T.init_params(cell, torch.Generator().manual_seed(0), device="cpu")
    b = T.init_params(cell, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == cell.weight_shapes()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert float(a["W_z"].std()) == pytest.approx(1 / np.sqrt(8), rel=0.3)
    assert not a["b_z"].any()

"""The slice as a whole: ``repro_torch.serve.rnn_serve_frames`` on the CPU
matches ``repro.serve.rnn_serve_frames`` on outputs and final state at
1e-5, for LSTM and LSTMP with CSB weights (the setting of
tests/test_serve.py::test_rnn_serve_frames_csb); and its obs wiring."""
import jax
import numpy as np
import pytest
import torch

from repro.cells import init_params, make_cell
from repro.core import CSBSpec, csb_masks, csb_project, padded_csb_from_dense
from repro.core.csb_format import PaddedCSB as JPaddedCSB
from repro.serve import rnn_serve_frames as j_serve
from repro_torch import obs
from repro_torch.cells import make_cell as t_make_cell
from repro_torch.convert import cell_params_from_numpy
from repro_torch.serve import EngineConfig, rnn_serve_frames


def _csb_cell(kind, seed):
    cell = make_cell(kind, 16, 32, proj_dim=24)
    params = init_params(cell, jax.random.PRNGKey(seed))
    spec = CSBSpec(bm=8, bn=8, prune_rate=0.5)
    out = {}
    for k, w in params.items():
        if w.ndim == 2:
            rm, cm = csb_masks(w, spec)
            out[k] = padded_csb_from_dense(
                np.asarray(csb_project(w, spec)), 8, 8,
                row_mask=np.asarray(rm), col_mask=np.asarray(cm))
        else:
            out[k] = w + 0.05
    host = {}
    for k, w in out.items():
        host[k] = ({**{a: np.asarray(getattr(w, a)) for a in
                       ("vals", "row_idx", "col_idx", "m", "n")},
                    "shape": w.shape, "grid": w.grid, "block": w.block}
                   if isinstance(w, JPaddedCSB) else np.asarray(w))
    return cell, out, host


@pytest.mark.parametrize("kind", ["lstm", "lstmp"])
def test_matches_jax_rnn_serve_frames(kind):
    cell, pj, host = _csb_cell(kind, 5)
    frames = np.random.default_rng(6).normal(size=(5, 2, 16)).astype(
        np.float32)
    oj, sj, usj = j_serve(cell, pj, frames, warmup=1)
    tcell = t_make_cell(kind, 16, 32, proj_dim=24)
    ot, st, ust, fus = rnn_serve_frames(
        tcell, cell_params_from_numpy(host, device="cpu"), frames,
        config=EngineConfig(frame_warmup=1, collect_frame_times=True),
        device="cpu")
    assert ot.shape == oj.shape == (5, 2, 24 if kind == "lstmp" else 32)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    assert st.keys() == sj.keys()
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                   rtol=1e-5, atol=1e-5)
    assert ust > 0 and fus.shape == (5,) and (fus > 0).all()


def _tiny():
    cell = t_make_cell("gru", 4, 8)
    from repro_torch.cells import init_params as t_init
    return cell, t_init(cell, torch.Generator().manual_seed(0), device="cpu")


def test_obs_spans_and_histogram():
    cell, params = _tiny()
    frames = torch.zeros(3, 1, 4)
    tr, reg = obs.enable_all()
    try:
        *_, fus = rnn_serve_frames(cell, params, frames, warmup=0,
                                   collect_frame_times=True, device="cpu")
    finally:
        obs.disable_all()
    spans = [e for e in tr.to_chrome()["traceEvents"]
             if e.get("name") == "serve/frame"]
    assert [e["args"]["frame"] for e in spans] == [0, 1, 2]
    h = reg.to_dict()["histograms"]["serve/frames/wall_us"]
    assert h["count"] == 3 and h["max"] == pytest.approx(fus.max())
    assert obs.summary.summarize(tr.to_chrome()["traceEvents"])[0][
        "name"] == "serve/frame"


def test_obs_off_and_three_tuple():
    cell, params = _tiny()
    out = rnn_serve_frames(cell, params, np.zeros((2, 3, 4), np.float64),
                           device="cpu")
    assert len(out) == 3 and out[0].dtype == torch.float32
    assert out[0].shape == (2, 3, 8)
    assert obs.trace.get() is None and obs.metrics.get() is None


def test_mesh_must_be_a_device_mesh():
    """The sharded path takes a ``DeviceMesh`` (tests/test_torch_csb_sharded
    .py serves over real ones); any other object is refused."""
    cell, params = _tiny()
    with pytest.raises(TypeError, match="DeviceMesh, got object"):
        rnn_serve_frames(cell, params, torch.zeros(1, 1, 4), mesh=object(),
                         device="cpu")


def test_config_type_checked():
    cell, params = _tiny()
    with pytest.raises(TypeError, match="rnn_serve_frames"):
        rnn_serve_frames(cell, params, torch.zeros(1, 1, 4), config={},
                         device="cpu")

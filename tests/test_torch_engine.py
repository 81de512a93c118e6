"""Port of engine/ (isa.py, schedule.py, simulator.py): the same cells and
the same CSB matrices go through both packages. Macro programs,
schedules (micro-instructions, per-iteration cycles, totals) and
simulation results are equal, field for field; the cycle model is host
numpy in both, so there is no tolerance. The z3 cases skip without z3,
as tests/test_engine.py's do."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.cells import make_cell as j_make_cell
from repro.core import CSBMatrix as JCSBMatrix
from repro.core import CSBSpec as JSpec
from repro.core import csb_masks as j_masks
from repro.core import csb_project as j_project
from repro_torch import core as T
from repro_torch import engine as TE
from repro_torch.cells import make_cell

MODES = ("none", "vertical", "horizontal", "2d")
# (shape, block, rate, seed): tests/test_engine.py's matrices
MATRICES = {
    "256x256 16x16 0.8": ((256, 256), 16, 0.8, 0),
    "256x192 16x16 0.8": ((256, 192), 16, 0.8, 1),
    "64x64 16x16 0.5": ((64, 64), 16, 0.5, 2),
    "1024x153 32x32 12/13": ((1024, 153), 32, 1 - 1 / 13, 3),
}
CONFIGS = {"4x4x4x4": (4, 4, 4, 4), "2x2x4x4": (2, 2, 4, 4),
           "3x2x2x8": (3, 2, 2, 8)}


def _pair(case):
    shape, b, rate, seed = MATRICES[case]
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    js = JSpec(bm=b, bn=b, prune_rate=rate)
    jz = np.asarray(j_project(jnp.asarray(w), js))
    jrm, jcm = (np.asarray(a) for a in j_masks(jnp.asarray(w), js))
    ts = T.CSBSpec(bm=b, bn=b, prune_rate=rate)
    wt = torch.from_numpy(w)
    trm, tcm = T.csb_masks(wt, ts)
    return (JCSBMatrix.from_dense(jz, b, b, jrm, jcm),
            T.CSBMatrix.from_dense(T.csb_project(wt, ts).numpy(), b, b,
                                   trm.numpy(), tcm.numpy()))


def _as_tuples(xs):
    return [dataclasses.astuple(x) for x in xs]


@pytest.mark.parametrize("kind", ["lstm", "gru", "lstmp", "ligru"])
def test_compile_macro_equals_jax(kind):
    want = JE.compile_macro(j_make_cell(kind, 64, 128, proj_dim=64))
    got = TE.compile_macro(make_cell(kind, 64, 128, proj_dim=64))
    assert got.graph_name == want.graph_name
    assert [{u: dataclasses.astuple(s) for u, s in w.items()}
            for w in got.words] == [
        {u: dataclasses.astuple(s) for u, s in w.items()} for w in want.words]
    assert got.occupancy() == want.occupancy()
    assert got.occupancy()["CSB-Engine"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", MATRICES)
def test_schedules_equal_jax(case, mode):
    jc, tc = _pair(case)
    np.testing.assert_array_equal(tc.m, jc.m)
    np.testing.assert_array_equal(tc.n, jc.n)
    args = (tc.m.astype(np.int64), tc.n.astype(np.int64), 4, 4, 4, 4)
    if mode == "none":
        want, got = (JE.no_sharing_schedule(*args),
                     TE.no_sharing_schedule(*args))
    else:
        want, got = (JE.greedy_schedule(*args, mode=mode),
                     TE.greedy_schedule(*args, mode=mode))
    assert (got.mode, got.total_cycles, got.solver_rounds) == (
        want.mode, want.total_cycles, want.solver_rounds)
    assert len(got.iter_cycles) == len(want.iter_cycles)
    for a, b in zip(got.iter_cycles, want.iter_cycles):
        np.testing.assert_array_equal(a, b)
    assert _as_tuples(got.micro) == _as_tuples(want.micro)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("case", MATRICES)
def test_simulation_equals_jax(case, config):
    jc, tc = _pair(case)
    je, te = JE.EngineConfig(*CONFIGS[config]), TE.EngineConfig(
        *CONFIGS[config])
    assert dataclasses.astuple(te) == dataclasses.astuple(je)
    for mode in ("none", "horizontal", "vertical", "2d"):
        assert dataclasses.asdict(TE.simulate_matrix(tc, te, mode)) \
            == dataclasses.asdict(JE.simulate_matrix(jc, je, mode)), mode
    layer = [tc, tc]
    assert dataclasses.asdict(TE.simulate_model_layer(layer, te)) \
        == dataclasses.asdict(JE.simulate_model_layer([jc, jc], je))
    assert TE.dense_latency_us(tc.shape, te) \
        == JE.dense_latency_us(jc.shape, je)


def test_sharing_ladder_on_the_port():
    """tests/test_engine.py's utilization claims, on the port's matrix."""
    _, tc = _pair("256x256 16x16 0.8")
    e = TE.EngineConfig(K=4, L=4, P=4, Q=4)
    eff = {m: TE.simulate_matrix(tc, e, m).efficiency
           for m in ("none", "horizontal", "2d")}
    assert eff["none"] < eff["horizontal"] <= eff["2d"] + 1e-9
    assert eff["2d"] > max(0.60, eff["none"] + 0.1)


def test_smt_schedule_equals_jax():
    pytest.importorskip("z3")
    m = np.array([[4, 8], [2, 16]])
    got = TE.smt_schedule(m, m, 2, 2, 4, 4, mode="2d")
    want = JE.smt_schedule(m, m, 2, 2, 4, 4, mode="2d")
    assert got.total_cycles == want.total_cycles < 16
    assert got.solver_rounds == want.solver_rounds


def test_smt_make_schedule_equals_jax():
    pytest.importorskip("z3")
    jc, tc = _pair("64x64 16x16 0.5")
    got = TE.make_schedule(tc, TE.EngineConfig(2, 2, 4, 4), solver="smt")
    want = JE.make_schedule(jc, JE.EngineConfig(2, 2, 4, 4), solver="smt")
    assert got.total_cycles == want.total_cycles

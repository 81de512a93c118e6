"""Kernel B3 and the sharded serving path on the CPU, over gloo ranks.

Each mesh runs once, as spawned processes (``repro_torch.dist.launch.
spawn_ranks``, a deadline of 120 s): a (1, 2), a (1, 4) and a (2, 2)
("data", "model") mesh. The ranks run the port's ``csb_matvec_sharded``
(B1's plain version on each rank's shard, the same chunked gathers and
unpermute) for ``overlap`` 1 to 3, ``cell_apply`` with sharded weights,
``CSBLinear`` routed through the mesh and ``rnn_serve_frames(mesh=...)``
on a reduced SR1 (its two LSTMP layers at narrow widths, its 13x rate).
The parent holds the results against the JAX package on the same inputs:
its unsharded ``csb_matvec`` (Pallas in interpret mode) at
tests/test_csb_sharded.py's rtol = atol = 1e-5 and the dense product at
1e-4, its unsharded ``cell_apply``/``CSBLinear``/``rnn_serve_frames`` at
1e-5, and its own ``csb_matvec_sharded``, run in a subprocess on four
forced host devices, at 1e-5. On the CPU the port densifies each chunk of
a shard, so B3 is not asked to be bit-equal to B1 here (the card's
[phase sharded] is). The ranks import this module; JAX is imported in the
parent alone.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.cells import cell_apply as t_cell_apply
from repro_torch.cells.dataflow import _apply_mvm
from repro_torch.cells import make_cell as t_make_cell
from repro_torch.convert import cell_params_from_numpy
from repro_torch.core import CSBLinear, CSBSpec as TSpec
from repro_torch.dist import Rules, partition_padded, use_rules
from repro_torch.dist.launch import spawn_ranks
from repro_torch.kernels import csb_sharded
from repro_torch.kernels.csb_sharded import csb_matvec_sharded
from repro_torch.models.layers import csb_dense
from repro_torch.serve import EngineConfig, rnn_serve_frames

ROOT = Path(__file__).resolve().parents[1]
OVERLAPS = (1, 2, 3)
ARRAYS = ("vals", "row_idx", "col_idx", "m", "n")
SR1_RATE = 1 - 1 / 13
SR1_LAYERS = ((16, 64, 32), (32, 64, 32))     # (in, hidden, proj), reduced
LIN_SHAPE = (160, 64)

# (shape, bm, bn, rate, seed) per matrix; B3 runs each on the meshes named
MATS = {
    "uneven 11 rows": ((176, 96), 16, 16, 0.5, 0),
    "3 rows": ((48, 64), 16, 16, 0.5, 1),
    "pad-lane heavy": ((128, 128), 16, 32, 0.9, 2),
    "padded grid": ((40, 24), 8, 8, 0.3, 3),
    "6 rows": ((96, 64), 16, 16, 0.5, 4),
    "skewed": None,
}
MESH_CASES = {
    (1, 2): {"uneven 11 rows": (5,), "skewed": (5,), "pad-lane heavy": (5,),
             "padded grid": (5,), "6 rows": ((), (3,), (2, 5))},
    (1, 4): {"3 rows": (5,), "uneven 11 rows": (6,), "skewed": (3,)},
    (2, 2): {"6 rows": (1, 5, 16), "uneven 11 rows": (6,)},
}


# ---------------------------------------------------------------------------
# rank programs (run in the spawned ranks: torch and repro_torch only)
# ---------------------------------------------------------------------------

def _padded(host):
    return cell_params_from_numpy({"w": host}, device="cpu")["w"]


def _local_rows(mesh, x):
    """This rank's rows of the global batch x (split over "data")."""
    n_data = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    i = mesh.get_local_rank("data")
    per = -(-x.shape[0] // n_data)
    return x[i * per:(i + 1) * per]


def _b3_cases(mesh, cases):
    """B3 on every (matrix, x) for every overlap: this rank's rows of y."""
    n_model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    rank = mesh.get_local_rank("model")
    out = {}
    for name, (host, xs) in cases.items():
        plan, s = partition_padded(_padded(host), n_model)
        s = s.local(rank)
        for i, x in enumerate(xs):
            x = torch.from_numpy(x)
            if x.ndim == 2:
                x = _local_rows(mesh, x)
            for ov in OVERLAPS:
                out[(name, i, ov)] = csb_matvec_sharded(
                    s, x, mesh=mesh, overlap=ov).numpy()
        out[(name, "plan")] = plan.assignment
    return out


def _errors(mesh, host):
    """What B3 and cell_apply refuse, as the messages they raise."""
    p = _padded(host)
    x = torch.ones(2, p.shape[1])
    calls = {
        "width": lambda: csb_matvec_sharded(partition_padded(p, 4)[1], x,
                                            mesh=mesh),
        "axis": lambda: csb_matvec_sharded(partition_padded(p, 2)[1], x,
                                           mesh=mesh, axis_name="tensor"),
        "overlap": lambda: csb_matvec_sharded(partition_padded(p, 2)[1], x,
                                              mesh=mesh, overlap=0),
        "no mesh": lambda: _apply_mvm(partition_padded(p, 2)[1], x),
    }
    out = {}
    for k, call in calls.items():
        try:
            call()
            out[k] = None
        except ValueError as e:
            out[k] = str(e)
    return out


def _cell(mesh, host, x, state):
    """A GRU step with sharded weights under the mesh's Rules."""
    cell = t_make_cell("gru", 16, 32)
    params = cell_params_from_numpy(host, device="cpu")
    n_model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    rank = mesh.get_local_rank("model")
    sharded = {k: (partition_padded(w, n_model)[1].local(rank)
                   if not isinstance(w, torch.Tensor) else w)
               for k, w in params.items()}
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    with use_rules(Rules(mesh=mesh)):
        y, _ = t_cell_apply(cell, sharded, torch.from_numpy(x), st)
    return y.numpy()


def _linear(mesh, w1, w2, x):
    """CSBLinear in csb mode through the mesh: under Rules, through the
    layer, by keyword, and after a re-freeze."""
    spec = TSpec(bm=16, bn=16, prune_rate=0.5)
    x = torch.from_numpy(x)
    lin1 = CSBLinear(torch.from_numpy(w1), spec).freeze()
    y_local = lin1(x)
    with use_rules(Rules(mesh=mesh)):
        y_mesh = lin1(x)
        y_layer = csb_dense(x, lin1)
        lin2 = CSBLinear(torch.from_numpy(w2), spec).freeze()
        fresh = not lin2._shards
        y2 = lin2(x)
    y_kw = lin1(x, mesh=mesh)
    return {"local": y_local.numpy(), "mesh": y_mesh.numpy(),
            "layer": y_layer.numpy(), "keyword": y_kw.numpy(),
            "refrozen": y2.numpy(), "refrozen_local": lin2(x).numpy(),
            "keys": sorted(lin1._shards), "fresh": fresh,
            "distinct": lin2._shards is not lin1._shards}


def _serve(mesh, layers, frames):
    """Reduced SR1 through rnn_serve_frames(mesh=...), layer by layer;
    the B3 calls made on the way counted by one rank-local counter."""
    cfg = EngineConfig(frame_warmup=1, collect_frame_times=True)
    calls = []
    real = csb_sharded._matvec

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    csb_sharded._matvec = counted
    try:
        x, out = torch.from_numpy(frames), []
        for (d_in, hid, proj), host in zip(SR1_LAYERS, layers):
            cell = t_make_cell("lstmp", d_in, hid, proj_dim=proj)
            y, st, us, fus = rnn_serve_frames(
                cell, cell_params_from_numpy(host, device="cpu"), x,
                config=cfg, mesh=mesh, device="cpu")
            out.append((y.numpy(), {k: v.numpy() for k, v in st.items()},
                        us, fus))
            x = y
    finally:
        csb_sharded._matvec = real
    return {"layers": out, "b3_calls": len(calls)}


def _rank_program(mesh, job):
    out = {"rank": dist.get_rank(),
           "coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model")),
           "b3": _b3_cases(mesh, job["b3"])}
    if "errors" in job:
        out["errors"] = _errors(mesh, job["errors"])
    if "cell" in job:
        out["cell"] = _cell(mesh, *job["cell"])
    if "linear" in job:
        out["linear"] = _linear(mesh, *job["linear"])
    if "serve" in job:
        out["serve"] = _serve(mesh, *job["serve"])
    return out


# ---------------------------------------------------------------------------
# the parent: inputs, JAX's side, the three meshes
# ---------------------------------------------------------------------------

JAX_SHARDED = r"""
import sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import padded_csb_from_dense
from repro.dist.csb_partition import partition_padded
from repro.kernels.csb_sharded import csb_matvec_sharded

inp = np.load(sys.argv[1])
p = padded_csb_from_dense(inp["z"], 16, 16, row_mask=inp["rm"],
                          col_mask=inp["cm"])
out = {}
for shape in ((1, 4), (2, 2)):
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                ("data", "model"))
    _, s = partition_padded(p, shape[1])
    for ov in (1, 2):
        y = csb_matvec_sharded(s, inp["x"], mesh=mesh, overlap=ov)
        out[f"{shape[0]}x{shape[1]}_{ov}"] = np.asarray(y)
np.savez(sys.argv[2], **out)
"""


def _jax_csb(seed, shape, bm, bn, rate):
    """(JAX PaddedCSB, its numpy leaves, dense z, masks) from a seed."""
    import jax.numpy as jnp

    from repro.core import CSBSpec, csb_masks, csb_project
    from repro.core import padded_csb_from_dense
    w = jnp.asarray(np.random.default_rng(seed).normal(size=shape).astype(
        np.float32))
    spec = CSBSpec(bm=bm, bn=bn, prune_rate=rate)
    rm, cm = (np.asarray(a) for a in csb_masks(w, spec))
    z = np.asarray(csb_project(w, spec))
    p = padded_csb_from_dense(z, bm, bn, row_mask=rm, col_mask=cm)
    return p, _leaves(p), z, rm, cm


def _leaves(p):
    return {**{k: np.asarray(getattr(p, k)) for k in ARRAYS},
            "shape": p.shape, "grid": p.grid, "block": p.block}


def _skewed():
    """tests/test_csb_sharded.py's skewed fixture (32 block-rows, the first
    8 dense)."""
    from repro.core import padded_csb_from_dense
    rng = np.random.default_rng(7)
    z = np.zeros((512, 256), np.float32)
    z[:128] = rng.normal(size=(128, 256))
    light = rng.normal(size=(384, 256)).astype(np.float32)
    mask = np.zeros((384, 256), bool)
    mask[::4, ::4] = True
    z[128:] = np.where(mask, light, 0.0)
    p = padded_csb_from_dense(z, 16, 16)
    return p, _leaves(p), z, None, None


def _cell_params(kind, dims, spec_args, seed, proj=None):
    """JAX's cell params (CSB for the 2-D weights) and their numpy form."""
    import jax

    from repro.cells import init_params, make_cell
    from repro.core import CSBSpec, csb_masks, csb_project
    from repro.core import padded_csb_from_dense
    cell = make_cell(kind, *dims, **({} if proj is None
                                     else {"proj_dim": proj}))
    spec = CSBSpec(*spec_args)
    pj, host = {}, {}
    for k, w in init_params(cell, jax.random.PRNGKey(seed)).items():
        if w.ndim == 2:
            rm, cm = csb_masks(w, spec)
            pj[k] = padded_csb_from_dense(
                np.asarray(csb_project(w, spec)), spec.bm, spec.bn,
                row_mask=np.asarray(rm), col_mask=np.asarray(cm))
            host[k] = _leaves(pj[k])
        else:
            pj[k] = w + 0.05
            host[k] = np.asarray(pj[k])
    return cell, pj, host


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's rank results beside JAX's references."""
    from repro.cells import cell_apply, init_state
    from repro.core import CSBLinear as JLinear, CSBSpec
    from repro.kernels.ops import csb_matvec
    from repro.serve import rnn_serve_frames as j_serve

    tmp = tmp_path_factory.mktemp("b3")
    rng = np.random.default_rng(11)
    mats = {name: (_skewed() if args is None else _jax_csb(args[4],
                                                           *args[:4]))
            for name, args in MATS.items()}

    # JAX's own B3 on four host devices, beside the port's ranks
    _, _, z, rm, cm = mats["uneven 11 rows"]
    x_sub = rng.normal(size=(6, 96)).astype(np.float32)
    np.savez(tmp / "in.npz", z=z, rm=rm, cm=cm, x=x_sub)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    sub = subprocess.Popen(
        [sys.executable, "-c", JAX_SHARDED, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    refs, jobs = {}, {}
    for mesh_shape, cases in MESH_CASES.items():
        job = {}
        for name, batches in cases.items():
            pj, host, z, _, _ = mats[name]
            xs = []
            for i, b in enumerate(batches):
                bshape = b if isinstance(b, tuple) else (b,)
                x = (x_sub if (mesh_shape != (1, 2) and name ==
                               "uneven 11 rows")
                     else rng.normal(size=(*bshape, pj.shape[1])).astype(
                         np.float32))
                xs.append(x)
                refs[(mesh_shape, name, i)] = (
                    x, np.asarray(csb_matvec(pj, x)), x @ z.T)
            job[name] = (host, xs)
        jobs[mesh_shape] = {"b3": job}

    j12 = jobs[(1, 2)]
    j12["errors"] = mats["6 rows"][1]
    gru, gru_j, gru_host = _cell_params("gru", (16, 32), (8, 8, 0.5), 2)
    x_cell = rng.normal(size=(2, 16)).astype(np.float32)
    st = {k: np.asarray(v) for k, v in init_state(gru, (2,)).items()}
    j12["cell"] = (gru_host, x_cell, st)
    refs["cell"] = np.asarray(cell_apply(gru, gru_j, x_cell, st)[0])
    w1, w2 = (rng.normal(size=LIN_SHAPE).astype(np.float32)
              for _ in range(2))
    x_lin = rng.normal(size=(4, LIN_SHAPE[1])).astype(np.float32)
    j12["linear"] = (w1, w2, x_lin)
    spec = CSBSpec(bm=16, bn=16, prune_rate=0.5)
    refs["linear"] = [np.asarray(JLinear(weight=w, spec=spec).freeze()(x_lin))
                      for w in (w1, w2)]

    layers = [_cell_params("lstmp", d[:2], (8, 8, SR1_RATE), 20 + i, d[2])
              for i, d in enumerate(SR1_LAYERS)]
    for mesh_shape, batch in (((1, 2), 2), ((2, 2), 4)):
        frames = rng.normal(size=(5, batch, SR1_LAYERS[0][0])).astype(
            np.float32)
        jobs[mesh_shape]["serve"] = ([h for _, _, h in layers], frames)
        x, outs = frames, []
        for cell, pj, _ in layers:
            y, st, _ = j_serve(cell, pj, x, warmup=1)
            outs.append((np.asarray(y),
                         {k: np.asarray(v) for k, v in st.items()}))
            x = y
        refs[("serve", mesh_shape)] = outs

    got = {shape: spawn_ranks(_rank_program, shape, job, device="cpu",
                             timeout_s=120)
           for shape, job in jobs.items()}
    log = sub.communicate(timeout=120)[0]
    assert sub.returncode == 0, log
    jax_b3 = dict(np.load(tmp / "out.npz"))
    return {"got": got, "refs": refs, "jax_b3": jax_b3, "mats": mats}


def _tol(a, b, tol, what):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _stitched(ranks, key):
    """The global y of a B3 case: one model rank per data index, in data
    order; the other model ranks must hold the same rows, bit for bit."""
    by_data = {}
    for r in ranks:
        d, _ = r["coords"]
        y = r["b3"][key]
        if d in by_data:
            np.testing.assert_array_equal(y, by_data[d], err_msg=str(key))
        by_data[d] = y
    return np.concatenate([by_data[d] for d in sorted(by_data)], axis=0)


@pytest.mark.parametrize("mesh_shape,name,i", [
    (shape, name, i) for shape, cases in MESH_CASES.items()
    for name, batches in cases.items() for i in range(len(batches))])
@pytest.mark.parametrize("overlap", OVERLAPS)
def test_b3_matches_unsharded_and_dense(runs, mesh_shape, name, i, overlap):
    x, y_ref, y_dense = runs["refs"][(mesh_shape, name, i)]
    y = _stitched(runs["got"][mesh_shape], (name, i, overlap))
    assert y.shape == y_ref.shape and y.dtype == np.float32
    _tol(y, y_ref, 1e-5, f"{name} vs csb_matvec")
    _tol(y, y_dense, 1e-4, f"{name} vs x @ z.T")


def test_plans_and_pad_rows(runs):
    """Every rank planned the same rows; Br = 3 over 4 ranks leaves one
    rank nothing but a pad row, whose outputs the unpermute drops."""
    for shape, ranks in runs["got"].items():
        for name in MESH_CASES[shape]:
            plans = {r["b3"][(name, "plan")] for r in ranks}
            assert len(plans) == 1, (shape, name, plans)
    (plan,) = {r["b3"][("3 rows", "plan")] for r in runs["got"][(1, 4)]}
    assert sorted(len(rows) for rows in plan) == [0, 1, 1, 1]
    assert [r["rank"] for r in runs["got"][(2, 2)]] == [0, 1, 2, 3]
    assert [r["coords"] for r in runs["got"][(2, 2)]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("overlap", [1, 2])
def test_b3_matches_jax_csb_matvec_sharded(runs, mesh_shape, overlap):
    """The port's ranks against JAX's own B3 (shard_map over four forced
    host devices, from a subprocess) on the same matrix and x."""
    want = runs["jax_b3"][f"{mesh_shape[0]}x{mesh_shape[1]}_{overlap}"]
    y = _stitched(runs["got"][mesh_shape], ("uneven 11 rows", 0, overlap))
    assert y.shape == want.shape == (6, 176)
    _tol(y, want, 1e-5, "vs JAX's csb_matvec_sharded")


def test_mismatched_mesh_and_arguments_raise(runs):
    for r in runs["got"][(1, 2)]:
        e = r["errors"]
        assert "split for 4 devices but mesh axis 'model' has 2" in e["width"]
        assert "mesh has no axis 'tensor'" in e["axis"]
        assert "overlap must be >= 1, got 0" in e["overlap"]
        assert "needs an active use_rules scope" in e["no mesh"]


def test_cell_apply_sharded_weights(runs):
    for r in runs["got"][(1, 2)]:
        _tol(r["cell"], runs["refs"]["cell"], 1e-5, "GRU step")


def test_csb_linear_routes_through_mesh(runs):
    want1, want2 = runs["refs"]["linear"]
    for r in runs["got"][(1, 2)]:
        lin = r["linear"]
        assert lin["keys"] == [(2, "model")]
        assert lin["fresh"] and lin["distinct"]
        for k in ("local", "mesh", "layer", "keyword"):
            _tol(lin[k], want1, 1e-5, k)
        _tol(lin["refrozen"], want2, 1e-5, "re-frozen")
        _tol(lin["refrozen_local"], want2, 1e-5, "re-frozen, local")
        assert not np.allclose(lin["mesh"], lin["refrozen"])


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_rnn_serve_frames_sharded_matches_jax(runs, mesh_shape):
    """Reduced SR1 served over the mesh: every rank returns JAX's
    unsharded outputs and final states; each frame ran 9 B3 calls per
    layer on every rank (warm-up, the unblocked pass, the timed pass)."""
    want = runs["refs"][("serve", mesh_shape)]
    ranks = runs["got"][mesh_shape]
    for r in ranks:
        s = r["serve"]
        for (y, st, us, fus), (wy, wst) in zip(s["layers"], want):
            assert y.shape == wy.shape
            _tol(y, wy, 1e-5, "outputs")
            assert st.keys() == wst.keys()
            for k in wst:
                _tol(st[k], wst[k], 1e-5, f"state {k}")
            assert us > 0 and fus.shape == (5,) and (fus > 0).all()
        assert s["b3_calls"] == len(SR1_LAYERS) * 9 * (1 + 2 * 5)
    for other in ranks[1:]:
        for (y0, *_), (y1, *_) in zip(ranks[0]["serve"]["layers"],
                                      other["serve"]["layers"]):
            np.testing.assert_array_equal(y0, y1)



def _rank_raises(mesh):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 refuses")
    t = torch.zeros(2)
    dist.all_gather([torch.empty_like(t) for _ in range(2)], t)


def _rank_hangs(mesh):
    if dist.get_rank() == 1:
        import time
        time.sleep(120)


def test_spawn_ranks_defaults_to_the_card(monkeypatch):
    """Without ``device`` the ranks would run on the card: with no CUDA the
    call raises before it starts a rank, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        spawn_ranks(_rank_hangs, (1, 2))


def test_spawn_ranks_fails_with_the_failed_rank_traceback():
    with pytest.raises(Exception, match="rank 1 refuses") as e:
        spawn_ranks(_rank_raises, (1, 2), device="cpu", timeout_s=60)
    assert "_rank_raises" in str(e.value)


def test_spawn_ranks_stops_a_rank_past_its_deadline():
    """The deadline starts once both ranks have joined the group (booting
    has its own limit), so rank 0, which returns at once, is done by then
    however slowly the ranks booted, and only the hung rank 1 is named."""
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2 still running"):
        spawn_ranks(_rank_hangs, (1, 2), device="cpu", timeout_s=5)


def test_spawn_ranks_names_the_ranks_still_booting(monkeypatch):
    """No rank joins its group within a boot limit of 10 ms: the call
    raises, names both ranks, and stops them."""
    from repro_torch.dist import launch
    monkeypatch.setattr(launch, "BOOT_S", 0.01)
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2 still "
                                           r"booting after 0 s"):
        spawn_ranks(_rank_hangs, (1, 2), device="cpu", timeout_s=5)


def test_rules_carry_only_a_mesh_and_nest():
    """``Rules`` carries its mesh and a placement table (JAX's ``get``,
    ``in``, ``items`` and ``updated``, which keeps the mesh); nested
    scopes restore the outer rules, also on an error."""
    from repro_torch.dist import P, current_rules
    table = {"batch": P("data"), "residual": P("data", None, None)}
    r = Rules(table, mesh="m")
    assert dict(r.items()) == table and r.mesh == "m"
    assert "batch" in r and "logits" not in r and r.get("logits") is None
    up = r.updated(batch=P(None), logits=P("data", None, "model"))
    assert up.mesh == "m" and up.get("batch") == P(None)
    assert up.get("logits") == P("data", None, "model")
    assert dict(r.items()) == table            # the original is unchanged
    assert Rules(mesh="m").get("batch") is None
    outer, inner = Rules(mesh="outer"), Rules(mesh="inner")
    assert current_rules() is None
    with use_rules(outer):
        with pytest.raises(KeyError):
            with use_rules(inner):
                assert current_rules().mesh == "inner"
                raise KeyError("inside")
        assert current_rules() is outer
    assert current_rules() is None

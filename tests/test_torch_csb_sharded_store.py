"""Kernel B3's own contract, on the CPU, against the JAX package.

On the card B3 (``src/repro_torch/kernels/csrc/csb_sharded.cu``) is one
launch per call on each rank, which stores the rank's output rows at
their global columns into every rank's output; its stores are the
exchange. Its contract on one rank, without the exchange, is
``csb_sharded_rows``: the rank's rows at their global columns, zeros
elsewhere (on the CPU ``ref.csb_sharded_rows_ref``). Summed over the
ranks of a plan it must equal JAX's ``csb_matvec_sharded`` (``shard_map``
over four forced host devices, Pallas in interpret mode, from a
subprocess) for every ``overlap``, and JAX's unsharded ``csb_matvec``
(interpret mode), both at tests/test_csb_sharded.py's rtol = atol =
1e-5. The matrices cover an uneven plan, a rank that holds only a pad
row (three block-rows over four ranks), an output width that is not a
multiple of ``bm`` and a padded grid. The host helpers run here as they
run on the card; the kernel itself runs only on the card
(``cuda_device`` cases, skipped here).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import cell_params_from_numpy
from repro_torch.dist import partition_padded
from repro_torch.kernels import _build
from repro_torch.kernels.csb_sharded import (
    _column_table, csb_matvec_sharded, csb_sharded_rows,
)

ROOT = Path(__file__).resolve().parents[1]
ARRAYS = ("vals", "row_idx", "col_idx", "m", "n")
OVERLAPS = (1, 2, 3)
MESHES = ((1, 2), (1, 4))
BATCH = 5
# (shape, bm, bn, rate, seed)
MATS = {
    "uneven 11 rows": ((176, 96), 16, 16, 0.5, 0),
    "3 rows, a pad-only rank at R = 4": ((48, 64), 16, 16, 0.5, 1),
    "out 36, not a multiple of bm 16": ((36, 40), 16, 16, 0.5, 5),
    "padded grid": ((40, 24), 8, 8, 0.3, 3),
}

JAX_SHARDED = r"""
import sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import padded_csb_from_dense
from repro.dist.csb_partition import partition_padded
from repro.kernels.csb_sharded import csb_matvec_sharded

mats = np.load(sys.argv[1], allow_pickle=True).item()
out = {}
for name, (z, rm, cm, bm, bn, x) in mats.items():
    p = padded_csb_from_dense(z, bm, bn, row_mask=rm, col_mask=cm)
    for shape in ((1, 2), (1, 4)):
        n = shape[0] * shape[1]
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        _, s = partition_padded(p, shape[1])
        for ov in (1, 2, 3):
            y = csb_matvec_sharded(s, x, mesh=mesh, overlap=ov)
            out[(name, shape, ov)] = np.asarray(y)
np.save(sys.argv[2], out, allow_pickle=True)
"""


class _Mesh:
    """What B3's checks read of a DeviceMesh (they run before any
    collective)."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Per matrix: the port's PaddedCSB, x, JAX's unsharded csb_matvec and
    x @ z.T; and JAX's csb_matvec_sharded per (matrix, mesh, overlap)."""
    import jax.numpy as jnp

    from repro.core import CSBSpec, csb_masks, csb_project
    from repro.core import padded_csb_from_dense
    from repro.kernels.ops import csb_matvec

    tmp = tmp_path_factory.mktemp("b3store")
    mats, host = {}, {}
    for name, (shape, bm, bn, rate, seed) in MATS.items():
        rng = np.random.default_rng(seed)
        w = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        spec = CSBSpec(bm=bm, bn=bn, prune_rate=rate)
        rm, cm = (np.asarray(a) for a in csb_masks(w, spec))
        z = np.asarray(csb_project(w, spec))
        x = rng.normal(size=(BATCH, shape[1])).astype(np.float32)
        pj = padded_csb_from_dense(z, bm, bn, row_mask=rm, col_mask=cm)
        leaves = {**{k: np.asarray(getattr(pj, k)) for k in ARRAYS},
                  "shape": pj.shape, "grid": pj.grid, "block": pj.block}
        p = cell_params_from_numpy({"w": leaves}, device="cpu")["w"]
        mats[name] = (p, x, np.asarray(csb_matvec(pj, x)), x @ z.T)
        host[name] = (z, rm, cm, bm, bn, x)
    np.save(tmp / "in.npy", host, allow_pickle=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run(
        [sys.executable, "-c", JAX_SHARDED, str(tmp / "in.npy"),
         str(tmp / "out.npy")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    sharded = np.load(tmp / "out.npy", allow_pickle=True).item()
    return mats, sharded


def _tol(a, b, what):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("overlap", OVERLAPS)
def test_rows_summed_over_ranks_match_jax(jax_side, mesh_shape, name,
                                          overlap):
    mats, sharded = jax_side
    p, x, y_unsharded, y_dense = mats[name]
    _, s = partition_padded(p, mesh_shape[1])
    y = sum(csb_sharded_rows(s, torch.from_numpy(x), r).numpy()
            for r in range(mesh_shape[1]))
    assert y.shape == (BATCH, p.shape[0]) and y.dtype == np.float32
    _tol(y, sharded[(name, mesh_shape, overlap)],
         "vs JAX's csb_matvec_sharded")
    _tol(y, y_unsharded, "vs JAX's csb_matvec")
    np.testing.assert_allclose(y, y_dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", list(MATS))
def test_each_rank_writes_only_its_own_columns(jax_side, mesh_shape, name):
    """A rank's contract holds JAX's y at the columns its block-rows own
    and exact zeros elsewhere; the columns of the ranks partition the
    output (so a sum over the ranks adds only zeros to each value)."""
    mats, _ = jax_side
    p, x, y_unsharded, _ = mats[name]
    plan, s = partition_padded(p, mesh_shape[1])
    bm, out_dim = p.block[0], p.shape[0]
    owned = np.zeros(out_dim, int)
    for r, rows in enumerate(plan.assignment):
        y = csb_sharded_rows(s, torch.from_numpy(x), r).numpy()
        mine = np.zeros(out_dim, bool)
        for br in rows:
            mine[br * bm:min((br + 1) * bm, out_dim)] = True
        owned += mine
        _tol(y[:, mine], y_unsharded[:, mine], f"rank {r}'s columns")
        assert (y[:, ~mine] == 0).all()
    assert (owned == 1).all()


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", list(MATS))
def test_column_table_is_a_permutation(jax_side, mesh_shape, name):
    """Over the ranks the live entries of the destination-column table are
    ``range(out_dim)`` once each; pad rows and rows past the matrix are
    -1."""
    p = jax_side[0][name][0]
    plan, s = partition_padded(p, mesh_shape[1])
    bm, rpd = p.block[0], s.rows_per_dev
    tables = [_column_table(s.row_map, r, rpd, bm, p.shape[0],
                            torch.device("cpu")) for r in range(s.n_dev)]
    assert all(t.dtype == torch.int32 and t.shape == (rpd * bm,)
               for t in tables)
    live = torch.cat(tables)
    assert sorted(live[live >= 0].tolist()) == list(range(p.shape[0]))
    for r, rows in enumerate(plan.assignment):
        assert (tables[r][len(rows) * bm:] == -1).all()


def test_a_rank_with_only_a_pad_row_contributes_zeros(jax_side):
    p, x, _, _ = jax_side[0]["3 rows, a pad-only rank at R = 4"]
    plan, s = partition_padded(p, 4)
    (empty,) = [r for r, rows in enumerate(plan.assignment) if not rows]
    table = _column_table(s.row_map, empty, s.rows_per_dev, p.block[0],
                          p.shape[0], torch.device("cpu"))
    assert (table == -1).all()
    assert not csb_sharded_rows(s, torch.from_numpy(x), empty).any()


def test_contract_keeps_the_batch_shape(jax_side):
    """A single vector and a (2, 3, in) batch come back with their shape."""
    p, x, y_unsharded, _ = jax_side[0]["uneven 11 rows"]
    _, s = partition_padded(p, 2)
    for xb, want in ((x[0], y_unsharded[0]),
                     (np.stack([x[:3], x[2:]]),
                      np.stack([y_unsharded[:3], y_unsharded[2:]]))):
        y = sum(csb_sharded_rows(s, torch.from_numpy(xb), r)
                for r in range(2)).numpy()
        assert y.shape == want.shape
        _tol(y, want, "batch shape")


@pytest.mark.parametrize("case", ["overlap", "width", "axis", "group"])
def test_b3_still_checks_its_arguments(jax_side, case):
    """B3 refuses what it refused before the kernel took the card path:
    ``overlap < 1``, a plan for another width of the axis, a mesh without
    the axis, and a ``group`` that does not divide ``Bc`` (6 here)."""
    p, x, _, _ = jax_side[0]["uneven 11 rows"]
    _, s2 = partition_padded(p, 2)
    _, s4 = partition_padded(p, 4)
    x = torch.from_numpy(x)
    mesh = _Mesh(data=1, model=2)
    call, msg = {
        "overlap": (lambda: csb_matvec_sharded(s2, x, mesh=mesh, overlap=0),
                    "overlap must be >= 1, got 0"),
        "width": (lambda: csb_matvec_sharded(s4, x, mesh=mesh),
                  "split for 4 devices but mesh axis 'model' has 2"),
        "axis": (lambda: csb_matvec_sharded(s2, x, mesh=mesh,
                                            axis_name="tensor"),
                 "mesh has no axis 'tensor'"),
        "group": (lambda: csb_matvec_sharded(s2, x, mesh=mesh, group=4),
                  "group 4 must divide Bc=6"),
    }[case]
    with pytest.raises(ValueError, match=msg):
        call()


def test_an_edited_header_changes_every_library_name(tmp_path):
    """The build cache names a library by its source, every ``csrc/*.cuh``
    beside it and the flags: editing a header renames (so rebuilds) every
    library, and editing a source renames only its own."""
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    header = tmp_path / "body.cuh"
    a.write_text('#include "body.cuh"\n')
    b.write_text("// no include\n")
    header.write_text("// v1\n")
    before = {p: _build._target(p) for p in (a, b)}
    assert _build._target(a) == before[a]
    header.write_text("// v2\n")
    after = {p: _build._target(p) for p in (a, b)}
    assert all(after[p] != before[p] for p in (a, b))
    assert all(after[p].parent == _build.build_dir() for p in (a, b))
    a.write_text('#include "body.cuh"\n// edited\n')
    assert _build._target(a) != after[a] and _build._target(b) == after[b]


def test_the_real_sources_share_one_header():
    """B1 and B3 include the same block-row body, so both library names
    carry its hash."""
    csrc = _build.CSRC
    assert (csrc / "csb_block.cuh").exists()
    for stem in ("csb_mvm", "csb_sharded"):
        assert '#include "csb_block.cuh"' in (csrc / f"{stem}.cu").read_text()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(MATS))
def test_kernel_rows_match_plain_on_card(jax_side, cuda_device, name):
    """The kernel's contract on every rank of a four-way plan against its
    plain version on the same inputs (fp32: summation order only); one
    launch each for a rank with live rows, none for a pad-only rank."""
    from repro_torch.kernels import csb_sharded
    p, x, _, _ = jax_side[0][name]
    plan, s = partition_padded(p, 4)
    xc = torch.from_numpy(x).to(cuda_device)
    for r, rows in enumerate(plan.assignment):
        before = csb_sharded.LAUNCHES
        y = csb_sharded_rows(s.local(r).to(cuda_device), xc, r)
        torch.cuda.synchronize()
        assert csb_sharded.LAUNCHES == before + (1 if rows else 0)
        ref = csb_sharded_rows(s, torch.from_numpy(x), r)
        torch.testing.assert_close(y.cpu(), ref, rtol=1e-5, atol=1e-5)

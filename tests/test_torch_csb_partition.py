"""Port of dist/csb_partition.py, the sharded CSB format and B3's host
helpers: on the same matrices the port's planner gives JAX's assignment,
cycles and imbalance exactly, ``split_block_rows`` JAX's arrays and row
map, ``csb_output_permutation``, ``_chunk_bounds`` and ``_chunk_order``
JAX's arrays, and ``csb_shard_specs`` keeps JAX's guards. The matrices
are tests/test_csb_sharded.py's (its skewed fixture and the cases of its
planner and parity tests)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.core import CSBSpec, csb_masks, csb_project
from repro.core import padded_csb_from_dense as j_padded
from repro.core.csb_format import CSBMatrix as JCSBMatrix
from repro.core.csb_format import csb_output_permutation as j_perm
from repro.dist import csb_partition as J
from repro.kernels.csb_sharded import _chunk_bounds as j_bounds
from repro.kernels.csb_sharded import _chunk_order as j_order
from repro_torch import obs
from repro_torch.convert import sharded_csb_from_numpy
from repro_torch.core import CSBMatrix, PaddedCSB, ShardedCSB
from repro_torch.core import padded_csb_from_dense
from repro_torch.core.csb_format import csb_output_permutation
from repro_torch.dist import (
    block_row_cycles, csb_shard_specs, partition_padded, plan_block_rows,
)
from repro_torch.kernels.csb_sharded import _chunk_bounds, _chunk_order

ARRAYS = ("vals", "row_idx", "col_idx", "m", "n")


def _masked(seed, shape, bm, bn, rate):
    """(z, row mask, col mask) of a CSB-pruned matrix, JAX's projection."""
    w = jnp.asarray(np.random.default_rng(seed).normal(size=shape).astype(
        np.float32))
    spec = CSBSpec(bm=bm, bn=bn, prune_rate=rate)
    rm, cm = csb_masks(w, spec)
    return np.asarray(csb_project(w, spec)), np.asarray(rm), np.asarray(cm)


def _skewed(seed):
    """tests/test_csb_sharded.py's skewed fixture: 32 block-rows of 16, the
    first 8 dense, the rest 4x4 survivors per block."""
    rng = np.random.default_rng(seed)
    z = np.zeros((512, 256), np.float32)
    z[:128] = rng.normal(size=(128, 256))
    light = rng.normal(size=(384, 256)).astype(np.float32)
    mask = np.zeros((384, 256), bool)
    mask[::4, ::4] = True
    z[128:] = np.where(mask, light, 0.0)
    return z, None, None


def _pair(z, rm, cm, bm, bn):
    kw = {} if rm is None else dict(row_mask=rm, col_mask=cm)
    return (j_padded(z, bm, bn, **kw),
            padded_csb_from_dense(z, bm, bn, device="cpu", **kw))


# (matrix, n_dev): tests/test_csb_sharded.py's planner and parity cases
CASES = {
    "uneven 11 rows over 8": (lambda: _masked(0, (176, 96), 16, 16, 0.5),
                              16, 16, 8),
    "3 rows over 8": (lambda: _masked(1, (48, 64), 16, 16, 0.5), 16, 16, 8),
    "3 rows over 4": (lambda: _masked(1, (48, 64), 16, 16, 0.5), 16, 16, 4),
    "pad-lane heavy": (lambda: _masked(2, (128, 128), 16, 32, 0.9),
                       16, 32, 8),
    "padded grid": (lambda: _masked(3, (40, 24), 8, 8, 0.3), 8, 8, 8),
    "6 rows over 4": (lambda: _masked(4, (96, 64), 16, 16, 0.5), 16, 16, 4),
    "11 rows over 4": (lambda: _masked(5, (176, 96), 16, 16, 0.5),
                       16, 16, 4),
    "skewed over 8": (lambda: _skewed(6), 16, 16, 8),
    "skewed over 2": (lambda: _skewed(6), 16, 16, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", ["greedy", "equal"])
def test_plan_and_split_match_jax(case, policy):
    make, bm, bn, n_dev = CASES[case]
    pj, pt = _pair(*make(), bm, bn)
    np.testing.assert_array_equal(block_row_cycles(pt),
                                  J.block_row_cycles(pj))
    plan_j, sj = J.partition_padded(pj, n_dev, policy=policy)
    plan_t, st = partition_padded(pt, n_dev, policy=policy)
    assert plan_t.assignment == plan_j.assignment
    assert plan_t.device_cycles == plan_j.device_cycles
    assert plan_t.imbalance == plan_j.imbalance
    assert plan_t.as_dict() == plan_j.as_dict()
    assert isinstance(st, ShardedCSB) and st.rank is None
    for k in ARRAYS:
        a, b = getattr(st, k), np.asarray(getattr(sj, k))
        assert tuple(a.shape) == b.shape, k
        assert a.dtype == (torch.float32 if k == "vals" else torch.int32)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    assert st.row_map == sj.row_map
    assert (st.n_dev, st.rows_per_dev, st.pm, st.pn) == \
        (sj.n_dev, sj.rows_per_dev, sj.pm, sj.pn)
    assert (st.shape, st.grid, st.block) == (sj.shape, sj.grid, sj.block)
    np.testing.assert_array_equal(st.output_permutation(),
                                  sj.output_permutation())
    # pad rows carry no work, and the shards hold all of it
    total = int((pt.m.long() * pt.n.long()).sum())
    assert int((st.m.long() * st.n.long()).sum()) == total


def test_skewed_fixture_balance():
    _, pt = _pair(*_skewed(7), 16, 16)
    cyc = block_row_cycles(pt)
    assert len(cyc) == 32 and cyc[:8].min() > cyc[8:].max()
    equal = plan_block_rows(cyc, 8, policy="equal")
    greedy = plan_block_rows(cyc, 8, policy="greedy")
    assert equal.imbalance >= 1.5, equal.as_dict()
    assert greedy.imbalance <= 1.1, greedy.as_dict()
    for plan in (equal, greedy):
        rows = sorted(r for dev in plan.assignment for r in dev)
        assert rows == list(range(32))
        assert sum(plan.device_cycles) == int(cyc.sum())


@pytest.mark.parametrize("seed,n_rows,n_dev", [
    (0, 32, 8), (1, 11, 4), (2, 3, 4), (3, 40, 3), (4, 7, 7), (5, 64, 16)])
def test_plan_random_cycles_match_jax(seed, n_rows, n_dev):
    cyc = np.random.default_rng(seed).integers(0, 500, n_rows)
    for policy in ("greedy", "equal"):
        a = plan_block_rows(cyc, n_dev, policy=policy)
        b = J.plan_block_rows(cyc, n_dev, policy=policy)
        assert (a.assignment, a.device_cycles, a.imbalance) == \
            (b.assignment, b.device_cycles, b.imbalance)


def test_plan_policies_and_errors():
    cyc = [5, 5, 5, 5]
    eq = plan_block_rows(cyc, 4, policy="equal")
    assert eq.imbalance == 1.0 and eq.n_dev == 4
    with pytest.raises(ValueError, match="unknown policy"):
        plan_block_rows(cyc, 4, policy="nope")
    with pytest.raises(ValueError, match="n_dev"):
        plan_block_rows(cyc, 0)
    plan = plan_block_rows([3, 2], 4)             # more devices than rows
    assert sum(len(a) for a in plan.assignment) == 2
    assert plan.assignment == J.plan_block_rows([3, 2], 4).assignment


def test_block_row_cycles_other_inputs():
    z, rm, cm = _masked(8, (64, 48), 16, 16, 0.5)
    mj = JCSBMatrix.from_dense(z, 16, 16, rm, cm)
    mt = CSBMatrix.from_dense(z, 16, 16, rm, cm)
    np.testing.assert_array_equal(block_row_cycles(mt),
                                  J.block_row_cycles(mj))
    np.testing.assert_array_equal(block_row_cycles((mt.m, mt.n), pe=(4, 4)),
                                  J.block_row_cycles((mj.m, mj.n), pe=(4, 4)))


def test_split_rejects_a_non_partition():
    _, pt = _pair(*_masked(9, (96, 64), 16, 16, 0.5), 16, 16)
    with pytest.raises(ValueError, match="partition"):
        pt.split_block_rows(((0, 1), (1, 2)))


def test_output_permutation_matches_jax():
    row_map = ((2, 6, 10), (1, 5, 9), (0, 4, 8), (3, 7))
    for bm in (8, 16):
        np.testing.assert_array_equal(
            csb_output_permutation(row_map, 3, bm, 11),
            np.asarray(j_perm(row_map, 3, bm, 11)))


@pytest.mark.parametrize("rpd,overlap", [
    (4, 1), (4, 2), (5, 2), (3, 8), (11, 3), (1, 3), (2, 2)])
def test_chunk_helpers_match_jax(rpd, overlap):
    assert _chunk_bounds(rpd, overlap) == j_bounds(rpd, overlap)
    for n_dev, bm in ((8, 16), (2, 32), (4, 8)):
        b = _chunk_bounds(rpd, overlap)
        order = _chunk_order(n_dev, rpd, bm, b)
        np.testing.assert_array_equal(order, j_order(n_dev, rpd, bm, b))
        assert sorted(order.tolist()) == list(range(n_dev * rpd * bm))


class _Mesh:
    """What ``csb_shard_specs`` reads of a DeviceMesh."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


def test_csb_shard_specs_guards():
    _, pt = _pair(*_masked(10, (96, 64), 16, 16, 0.5), 16, 16)
    _, s8 = partition_padded(pt, 8)
    specs = csb_shard_specs(s8, _Mesh(data=1, model=8))
    assert isinstance(specs, ShardedCSB) and specs.row_map == s8.row_map
    assert all(isinstance(getattr(specs, k), Shard) and
               getattr(specs, k).dim == 0 for k in ARRAYS)
    # a split of another width, an unsplit matrix and a split of one device
    # are replicated
    assert isinstance(csb_shard_specs(s8, _Mesh(data=1, model=4)).vals,
                      Replicate)
    assert isinstance(csb_shard_specs(s8, _Mesh(data=8)).vals, Replicate)
    p_spec = csb_shard_specs(pt, _Mesh(data=1, model=8))
    assert isinstance(p_spec, PaddedCSB)
    assert all(isinstance(getattr(p_spec, k), Replicate) for k in ARRAYS)
    _, s1 = partition_padded(pt, 1)
    assert isinstance(csb_shard_specs(s1, _Mesh(model=1)).vals, Replicate)
    # a mixed tree keeps its structure; a dense leaf takes the placements
    # of its param_specs spec, one per mesh axis (JAX's _leaf_spec): a 2-D
    # weight's output dim over "model" where it divides, a vector whole
    tree = {"w": torch.zeros(64, 32), "csb": s8, "list": [pt, torch.ones(3)],
            "wo": torch.zeros(64, 32), "odd": torch.zeros(64, 12)}
    specs = csb_shard_specs(tree, _Mesh(data=1, model=8))
    assert specs["w"] == (Replicate(), Shard(1))
    assert specs["wo"] == (Replicate(), Shard(0))
    assert specs["odd"] == (Replicate(), Replicate())
    assert isinstance(specs["csb"].m, Shard)
    assert isinstance(specs["list"][0], PaddedCSB)
    assert specs["list"][1] == (Replicate(), Replicate())


def test_local_shard_views_and_errors():
    _, pt = _pair(*_masked(11, (176, 96), 16, 16, 0.5), 16, 16)
    _, s = partition_padded(pt, 4)
    for r in range(4):
        loc = s.local(r)
        assert loc.rank == r and loc.n_dev == 4 and loc.row_map == s.row_map
        assert loc.local(r) is loc
        for k, a in zip(ARRAYS, loc.shard_arrays(r)):
            full = getattr(s, k)
            assert a.is_contiguous() and a.data_ptr() == full[r].data_ptr()
            torch.testing.assert_close(a, full[r], rtol=0, atol=0)
    with pytest.raises(ValueError, match="holds rank 1"):
        s.local(1).local(2)
    with pytest.raises(ValueError, match="outside"):
        s.local(4)
    moved = s.local(2).to("meta")
    assert moved.vals.device.type == "meta" and moved.rank == 2


def test_sharded_from_numpy_equals_split():
    z, rm, cm = _masked(12, (96, 64), 16, 16, 0.5)
    pj, pt = _pair(z, rm, cm, 16, 16)
    _, sj = J.partition_padded(pj, 4)
    leaves = {k: np.asarray(getattr(sj, k)) for k in ARRAYS}
    leaves.update(shape=sj.shape, grid=sj.grid, block=sj.block,
                  row_map=sj.row_map)
    s = sharded_csb_from_numpy(leaves, device="cpu")
    _, st = partition_padded(pt, 4)
    for k in ARRAYS:
        torch.testing.assert_close(getattr(s, k), getattr(st, k), rtol=0,
                                   atol=0)
    assert (s.row_map, s.shape, s.grid, s.block) == \
        (st.row_map, st.shape, st.grid, st.block)


def test_partition_records_imbalance():
    _, pt = _pair(*_skewed(13), 16, 16)
    tr, reg = obs.enable_all()
    try:
        plan, _ = partition_padded(pt, 8)
    finally:
        obs.disable_all()
    gauges = reg.to_dict()["gauges"]
    assert gauges["dist/csb_partition/imbalance"]["last"] == pytest.approx(
        plan.imbalance)
    assert gauges["dist/csb_partition/max_device_cycles"]["last"] == max(
        plan.device_cycles)
    inst = [e for e in tr.to_chrome()["traceEvents"]
            if e.get("name") == "dist/csb_partition"]
    assert inst and inst[0]["args"]["device_cycles"] == list(
        plan.device_cycles)

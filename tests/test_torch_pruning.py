"""Port of core/pruning.py: masks and projections bit-equal to the JAX
package on the cases of tests/test_csb_pruning.py, including
non-divisible shapes (zero-padding ties) and stacked rank-3 weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro_torch import core as T

CASES = [
    ((128, 96), 32, 32, 0.75),
    ((64, 64), 16, 16, 0.6),
    ((64, 48), 16, 16, 0.5),
    ((128, 128), 32, 32, 0.7),
    ((64, 64), 16, 16, 0.75),
    ((32, 40), 8, 8, 0.2),
    ((48, 64), 16, 16, 0.9),
    ((37, 23), 16, 16, 0.4),           # non-divisible: padded grid
    ((1024, 153), 32, 32, 1 - 1 / 13),  # SR1 layer 1 input matrix
    ((3, 48, 40), 16, 8, 0.5),          # stacked layers
]


def _pair(seed, shape):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(w), torch.from_numpy(w)


@pytest.mark.parametrize("shape,bm,bn,rate", CASES)
def test_masks_and_projection_bit_equal(shape, bm, bn, rate):
    wj, wt = _pair(sum(shape) + bm, shape)
    sj = J.CSBSpec(bm=bm, bn=bn, prune_rate=rate)
    st = T.CSBSpec(bm=bm, bn=bn, prune_rate=rate)
    rmj, cmj = J.csb_masks(wj, sj)
    rmt, cmt = T.csb_masks(wt, st)
    np.testing.assert_array_equal(rmt.numpy(), np.asarray(rmj))
    np.testing.assert_array_equal(cmt.numpy(), np.asarray(cmj))
    np.testing.assert_array_equal(T.csb_project(wt, st).numpy(),
                                  np.asarray(J.csb_project(wj, sj)))
    if len(shape) == 2:
        np.testing.assert_array_equal(
            T.element_mask(shape, st, rmt, cmt).numpy(),
            np.asarray(J.element_mask(shape, sj, rmj, cmj)))
        for a, b in zip(T.kernel_sizes(wt, st), J.kernel_sizes(wj, sj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_zero_padding_ties_keep_the_same_rows():
    """Rows that are all zero tie; a stable sort keeps the earliest."""
    w = np.zeros((40, 24), np.float32)
    w[:5] = np.random.default_rng(0).normal(size=(5, 24))
    spec = dict(bm=8, bn=8, prune_rate=0.5)
    rmj, cmj = J.csb_masks(jnp.asarray(w), J.CSBSpec(**spec))
    rmt, cmt = T.csb_masks(torch.from_numpy(w), T.CSBSpec(**spec))
    np.testing.assert_array_equal(rmt.numpy(), np.asarray(rmj))
    np.testing.assert_array_equal(cmt.numpy(), np.asarray(cmj))


def test_blocks_and_density():
    wj, wt = _pair(7, (37, 23))
    bj = J.to_blocks(wj, 16, 8)
    bt = T.to_blocks(wt, 16, 8)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(T.from_blocks(bt, (37, 23)).numpy(),
                                  wt.numpy())
    z = T.csb_project(wt, T.CSBSpec(bm=8, bn=8, prune_rate=0.6))
    zj = J.csb_project(wj, J.CSBSpec(bm=8, bn=8, prune_rate=0.6))
    assert float(T.density(z)) == float(J.density(zj))


def test_spec_properties():
    s = T.CSBSpec(prune_rate=0.75)
    assert s.keep_fraction == 0.25 and s.compression_ratio == 4.0
    assert s.with_rate(0.5) == T.CSBSpec(prune_rate=0.5)

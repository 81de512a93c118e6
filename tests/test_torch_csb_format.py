"""Port of core/csb_format.py: ``PaddedCSB`` field-for-field equal to
the JAX package's, the numpy ``CSBMatrix`` copy, ``densify`` exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.kernels.ref import densify as j_densify
from repro_torch import core as T
from repro_torch.kernels.ref import densify


def _pruned(seed, shape, bm, bn, rate):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    spec = J.CSBSpec(bm=bm, bn=bn, prune_rate=rate)
    z = J.csb_project(jnp.asarray(w), spec)
    rm, cm = J.csb_masks(jnp.asarray(w), spec)
    return np.asarray(z), np.asarray(rm), np.asarray(cm)


def assert_same_padded(pt, pj):
    for k in ("vals", "row_idx", "col_idx", "m", "n"):
        a = getattr(pt, k)
        b = np.asarray(getattr(pj, k))
        if a.dtype == torch.bfloat16:
            a, b = a.float(), b.astype(np.float32)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
        assert a.shape == b.shape
    assert pt.vals.dtype == {jnp.float32: torch.float32,
                             jnp.bfloat16: torch.bfloat16}[pj.vals.dtype.type]
    assert pt.row_idx.dtype == pt.m.dtype == torch.int32
    assert (pt.shape, pt.grid, pt.block) == (pj.shape, pj.grid, pj.block)
    assert (pt.pm, pt.pn) == (pj.pm, pj.pn)


@pytest.mark.parametrize("shape,bm,bn,rate,pad_to", [
    ((64, 48), 16, 16, 0.6, 8),
    ((37, 23), 16, 16, 0.4, 8),
    ((128, 96), 32, 32, 0.75, 16),
    ((40, 24), 8, 8, 0.3, 8),
])
@pytest.mark.parametrize("masks", [True, False])
def test_padded_field_for_field(shape, bm, bn, rate, pad_to, masks):
    z, rm, cm = _pruned(sum(shape), shape, bm, bn, rate)
    kw = dict(row_mask=rm, col_mask=cm) if masks else {}
    pj = J.padded_csb_from_dense(z, bm, bn, pad_to=pad_to, **kw)
    pt = T.padded_csb_from_dense(z, bm, bn, pad_to=pad_to, device="cpu",
                                 **kw)
    assert_same_padded(pt, pj)
    assert pt.true_flops_per_mvm() == pj.true_flops_per_mvm()
    assert pt.padded_flops_per_mvm() == pj.padded_flops_per_mvm()
    np.testing.assert_array_equal(densify(pt).numpy(), np.asarray(j_densify(pj)))
    np.testing.assert_array_equal(densify(pt).numpy(), z)


def test_padded_bf16_and_tensor_input():
    z, rm, cm = _pruned(3, (64, 64), 16, 16, 0.5)
    pj = J.padded_csb_from_dense(z, 16, 16, dtype=jnp.bfloat16,
                                 row_mask=rm, col_mask=cm)
    pt = T.padded_csb_from_dense(torch.tensor(z), 16, 16,
                                 dtype=torch.bfloat16,
                                 row_mask=torch.tensor(rm),
                                 col_mask=torch.tensor(cm), device="cpu")
    assert_same_padded(pt, pj)


def test_csb_matrix_copy_roundtrip():
    z, rm, cm = _pruned(5, (64, 48), 16, 16, 0.6)
    ct = T.CSBMatrix.from_dense(z, 16, 16, rm, cm)
    cj = J.CSBMatrix.from_dense(z, 16, 16, rm, cm)
    np.testing.assert_array_equal(ct.to_dense(), z)
    for k in ("m", "n", "row_idx", "col_idx", "val"):
        np.testing.assert_array_equal(getattr(ct, k), getattr(cj, k))
    assert ct.nio() == cj.nio() and ct.nnz == cj.nnz


def test_empty_blocks_and_to():
    z = np.zeros((32, 32), np.float32)
    z[:16, :16] = np.random.default_rng(0).normal(size=(16, 16))
    pt = T.padded_csb_from_dense(z, 16, 16, device="cpu")
    assert_same_padded(pt, J.padded_csb_from_dense(z, 16, 16))
    np.testing.assert_array_equal(densify(pt).numpy(), z)
    moved = pt.to("cpu")
    assert moved.vals.device == torch.device("cpu") and moved.grid == pt.grid

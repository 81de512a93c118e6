"""Port of kernels/ops.py + ref.py: on the CPU ``csb_matvec`` runs the
kernel's plain version, which must match the JAX package's Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) over that file's
sweep, at its tolerances: 1e-5 in fp32 (summation order only), 5e-2 in
bf16 (inputs rounded to 8 bits of mantissa). The CUDA kernel itself runs
only on the card: the last test here, and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CSBSpec, csb_masks, csb_project, padded_csb_from_dense
from repro.kernels.ops import csb_matvec as j_matvec
from repro.kernels.ref import densify as j_densify
from repro_torch.convert import cell_params_from_numpy
from repro_torch.kernels import csb_matvec, csb_mvm_ref, densify, pad_to_grid
from repro_torch.kernels.csb_mvm import csb_mvm_cuda


def make_pair(seed, shape, bm, bn, rate, dtype=jnp.float32):
    """The same pruned matrix as a JAX PaddedCSB and a port PaddedCSB."""
    w = jnp.asarray(np.random.default_rng(seed).normal(size=shape)
                    .astype(np.float32))
    spec = CSBSpec(bm=bm, bn=bn, prune_rate=rate)
    z = csb_project(w, spec)
    rm, cm = csb_masks(w, spec)
    pj = padded_csb_from_dense(np.asarray(z), bm, bn, dtype=dtype,
                               row_mask=np.asarray(rm),
                               col_mask=np.asarray(cm))
    pt = cell_params_from_numpy({"w": {
        **{k: np.asarray(getattr(pj, k))
           for k in ("vals", "row_idx", "col_idx", "m", "n")},
        "shape": pj.shape, "grid": pj.grid, "block": pj.block}},
        device="cpu")["w"]
    return pj, pt, np.asarray(z)


def _x(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _close(yt, yj, tol):
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,bm,bn", [
    ((32, 32), 16, 16),
    ((64, 48), 16, 16),
    ((48, 64), 16, 32),
    ((128, 96), 32, 32),
    ((40, 24), 8, 8),      # non-divisible -> padded grid
])
@pytest.mark.parametrize("rate", [0.3, 0.75])
def test_matches_jax_kernel_shapes(shape, bm, bn, rate):
    pj, pt, z = make_pair(sum(shape), shape, bm, bn, rate)
    x = _x(1, (5, shape[1]))
    yt = csb_matvec(pt, torch.from_numpy(x), device="cpu")
    _close(yt, j_matvec(pj, jnp.asarray(x)), 1e-5)
    np.testing.assert_allclose(yt.numpy(), x @ z.T, rtol=1e-4, atol=1e-4)


def test_matches_jax_kernel_bf16():
    pj, pt, _ = make_pair(2, (64, 64), 16, 16, 0.5, dtype=jnp.bfloat16)
    xj = jnp.asarray(_x(3, (4, 64))).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    _close(csb_matvec(pt, xt, device="cpu"), j_matvec(pj, xj), 5e-2)


@pytest.mark.parametrize("batch_shape", [(), (1,), (3,), (2, 5)])
def test_batch_shapes(batch_shape):
    pj, pt, _ = make_pair(4, (48, 32), 16, 16, 0.5)
    x = _x(5, (*batch_shape, 32))
    yt = csb_matvec(pt, torch.from_numpy(x), device="cpu")
    assert yt.shape == (*batch_shape, 48)
    _close(yt, j_matvec(pj, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_group(group):
    pj, pt, _ = make_pair(6, (64, 64), 16, 16, 0.5)
    x = _x(7, (4, 64))
    _close(csb_matvec(pt, torch.from_numpy(x), group=group, device="cpu"),
           j_matvec(pj, jnp.asarray(x), group=group), 1e-5)


def test_group_must_divide_block_columns():
    _, pt, _ = make_pair(6, (64, 48), 16, 16, 0.5)   # Bc = 3
    with pytest.raises(ValueError, match="group"):
        csb_matvec(pt, torch.zeros(2, 48), group=2, device="cpu")


@pytest.mark.parametrize("batch_tile", [8, 16])
def test_batch_tiles(batch_tile):
    pj, pt, _ = make_pair(8, (32, 32), 16, 16, 0.5)
    x = _x(9, (13, 32))
    _close(csb_matvec(pt, torch.from_numpy(x), batch_tile=batch_tile,
                      device="cpu"),
           j_matvec(pj, jnp.asarray(x), batch_tile=batch_tile), 1e-5)


def test_empty_blocks():
    """Blocks pruned away entirely (m = n = 0) contribute zero."""
    z = np.zeros((32, 32), np.float32)
    z[:16, :16] = np.random.default_rng(10).normal(size=(16, 16))
    pj = padded_csb_from_dense(z, 16, 16)
    pt = cell_params_from_numpy({"w": {
        **{k: np.asarray(getattr(pj, k))
           for k in ("vals", "row_idx", "col_idx", "m", "n")},
        "shape": pj.shape, "grid": pj.grid, "block": pj.block}},
        device="cpu")["w"]
    x = _x(11, (3, 32))
    yt = csb_matvec(pt, torch.from_numpy(x), device="cpu")
    _close(yt, j_matvec(pj, jnp.asarray(x)), 1e-5)
    np.testing.assert_allclose(yt.numpy(), x @ z.T, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(densify(pt).numpy(),
                                  np.asarray(j_densify(pj)))
    np.testing.assert_array_equal(densify(pt).numpy(), z)


def test_plain_version_takes_the_kernel_contract():
    """csb_mvm_ref: padded (B, Bc*bn) in, (B, Br*bm) fp32 out."""
    _, pt, z = make_pair(12, (40, 24), 8, 8, 0.5)
    x = torch.from_numpy(_x(13, (3, 24)))
    xp = pad_to_grid(x, 8, pt.grid[1] * pt.block[1])
    assert xp.shape == (8, 24)
    y = csb_mvm_ref(pt.vals, pt.row_idx, pt.col_idx, pt.m, pt.n, xp,
                    grid=pt.grid, block=pt.block)
    assert y.shape == (8, 40) and y.dtype == torch.float32
    np.testing.assert_allclose(y[:3].numpy(), x.numpy() @ z.T, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="columns"):
        csb_mvm_ref(pt.vals, pt.row_idx, pt.col_idx, pt.m, pt.n,
                    xp[:, :20], grid=pt.grid, block=pt.block)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises; it never computes."""
    _, pt, _ = make_pair(14, (32, 32), 16, 16, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        csb_mvm_cuda(pt.vals, pt.row_idx, pt.col_idx, pt.m, pt.n,
                     torch.zeros(8, 32), grid=pt.grid, block=pt.block,
                     batch_tile=8, group=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol):
    from repro_torch.kernels import csb_mvm
    _, pt, _ = make_pair(15, (128, 96), 32, 32, 0.75)
    pc = pt.to(cuda_device)
    pc.vals = pc.vals.to(dtype)
    x = torch.from_numpy(_x(16, (13, 96))).to(cuda_device, dtype)
    before = csb_mvm.LAUNCHES
    y = csb_matvec(pc, x)
    torch.cuda.synchronize()
    assert csb_mvm.LAUNCHES == before + 1
    xp = pad_to_grid(x, 8, 96)
    ref = csb_mvm_ref(pc.vals, pc.row_idx, pc.col_idx, pc.m, pc.n, xp,
                      grid=pc.grid, block=pc.block)[:13, :128]
    torch.testing.assert_close(y, ref, rtol=tol, atol=tol)

"""Port of kernels/ops.py + ref.py: on the CPU ``csb_matvec`` runs the
kernel's plain version, which must match the JAX package's Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) over that file's
sweep, at its tolerances: 1e-5 in fp32 (summation order only), 5e-2 in
bf16 (inputs rounded to 8 bits of mantissa). The CUDA kernel itself runs
only on the card: the tests that take ``cuda_device`` here, and
chip_smoke.py; its launch configurations are computed on the host and
checked here."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CSBSpec, csb_masks, csb_project, padded_csb_from_dense
from repro.kernels.ops import csb_matvec as j_matvec
from repro.kernels.ref import densify as j_densify
from repro_torch.convert import cell_params_from_numpy
from repro_torch.core.csb_format import PaddedCSB
from repro_torch.kernels import (csb_matvec, csb_mvm, csb_mvm_ref, densify,
                                 pad_to_grid)
from repro_torch.kernels.csb_mvm import (csb_mvm_cuda, launch_config,
                                         tiled_config, tiled_smem)


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


# (Bc, bm, Pm, Pn, batch_tile, true rows): SR1's three block grids at
# batch 1, and the card cases of chip_smoke.py (Bc 1, 33 and 128; blocks
# with m = 0; batches 1, 7, 8 and 17; batch_tile 16; bm 8)
CONFIGS = [(5, 32, 16, 32, 8, 1), (16, 32, 24, 32, 8, 1),
           (32, 32, 24, 32, 8, 1), (1, 32, 16, 16, 8, 1),
           (33, 32, 16, 16, 8, 7), (128, 32, 16, 16, 8, 8),
           (128, 32, 16, 16, 8, 17), (4, 16, 0, 0, 8, 3),
           (2, 16, 16, 16, 16, 13), (3, 8, 8, 8, 8, 8),
           (64, 64, 40, 64, 16, 16)]


@pytest.mark.parametrize("bc,bm,pm,pn,tb,rows", CONFIGS)
def test_launch_config(bc, bm, pm, pn, tb, rows):
    """A lane group per block as wide as its rows (a power of two, at
    most a warp); a thread for every output of the tile; at most 1024
    threads; the shared sums of one pass and the gathered inputs within
    227 KB; and every (block-column, row) item of a pass has its own lane
    group when 32 warps allow it."""
    threads, gs, chunk, smem = launch_config(bc, bm, pm, pn, tb, rows)
    tr = min(tb, rows)
    assert threads % 32 == 0 and tb * bm <= threads <= 1024
    assert gs & (gs - 1) == 0 and min(pm, 32) <= gs <= 32
    assert 1 <= chunk <= bc
    assert smem == 4 * (tr * chunk * bm + threads // gs * pn) <= 232448
    items_per_warp = 32 // gs
    assert threads // 32 * items_per_warp >= min(chunk * tr,
                                                 32 * items_per_warp)
    if chunk < bc:
        assert 4 * (tr * (chunk + 1) * bm + 1024 // gs * pn) > 232448


def test_launch_config_one_pass_at_4096_columns():
    """A 4096-wide input in 32-column blocks (Bc = 128) at batch tile 8 is
    one pass over shared memory, a warp for each (block-column, row) pair
    of a batch of one."""
    threads, gs, chunk, _ = launch_config(128, 32, 16, 16, 8, 1)
    assert (threads, gs, chunk) == (1024, 16, 128)
    assert launch_config(128, 32, 16, 16, 8, 8)[2] == 128


# (Br, Bc, bm = bn, Pm, Pn) of the grids the port builds (SR1, SR2, the
# FFN's 32-row blocks, tests' 8-64-row blocks), each at a true row count
# below, at and above the tiled body's threshold, up to 4,096 rows
TH = csb_mvm.TILED_MIN_ROWS
TILED_GRIDS = [g for g in itertools.product(
    (1, 16, 32), (1, 5, 32, 128), (8, 32, 64), (0, 8, 32, 64),
    (0, 8, 32, 64)) if g[3] <= g[2] and g[4] <= g[2]]


@pytest.mark.parametrize("rows", [1, TH - 1, TH, 1000, 4096])
@pytest.mark.parametrize("br,bc,b,pm,pn", TILED_GRIDS[::12])
def test_tiled_config(br, bc, b, pm, pn, rows):
    """The batch-tiled body below its threshold is not taken; at and above
    it, a CTA of whole warps (one a block-row, at most 8) covers every
    block-row, its grid fits the card's y limit, its shared memory is the
    source's sum within 227 KB, and the inputs are staged in as few passes
    as fit."""
    batch = -(-rows // 8) * 8
    cfg = tiled_config(br, bc, b, b, pm, pn, batch, rows)
    if rows < TH:
        assert cfg is None
        return
    threads, chunk, smem, (gx, gy) = cfg
    warps = threads // 32
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert gx * warps >= br > (gx - 1) * warps
    assert gy * 32 >= batch and gy <= 65535
    assert 1 <= chunk <= bc
    assert smem == tiled_smem(b, b, pm, pn, warps, chunk) <= 232448
    passes = -(-bc // chunk)
    if passes > 1:
        assert tiled_smem(b, b, pm, pn, warps, -(-bc // (passes - 1))) \
            > 232448


@pytest.mark.parametrize("br,bc,tiles,want", [
    (32, 16, 32, (256, 16, (4, 32))),     # SR1's U at 1,024 rows
    (32, 32, 32, (256, 32, (4, 32))),     # SR2's U
    (16, 32, 32, (128, 32, (4, 32))),     # SR1's W_proj
    (32, 5, 4, (64, 5, (16, 4))),         # 128 rows: 2 warps a CTA
])
def test_tiled_config_at_the_serving_batch(br, bc, tiles, want):
    """At 1,024 rows of SR1's and SR2's 32 x 32 blocks (Pm = Pn = 32) a
    CTA takes 8 block-rows while the grid still has 128 CTAs, else 4 (at
    128 rows, 2), and the inputs are staged in one pass."""
    cfg = tiled_config(br, bc, 32, 32, 32, 32, 32 * tiles, 32 * tiles)
    assert cfg[:2] + cfg[3:] == want


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


# Kernel B1's two bodies on the card: the batch-tiled body (at and above
# ``csb_mvm.TILED_MIN_ROWS`` true rows) gives the row body's numbers
# exactly, at the speech recognisers' matrix shapes (SR1: 1024 x 153,
# 1024 x 512, 512 x 1024; SR2: 1024 x 39, 1024 x 1024) and two that
# exercise its other paths (inputs staged in several passes; 64 x 64
# blocks, whose dense ones have more live columns than the registers
# hold). The row body's reference is
# the same input run in slices of fewer rows than the threshold; each
# output row depends on its own input row only. The matrices are built
# like the benchmark's pruned ones: 32 x 32 blocks padded to Pm = Pn = 32,
# a mean live m and n of 4 to 7, a few dense blocks on the diagonal, and
# empty blocks (m or n = 0).
# name: ((out, in), block)
B1_SHAPES = {
    "sr1_W": ((1024, 153), 32), "sr1_U": ((1024, 512), 32),
    "sr1_proj": ((512, 1024), 32), "sr2_W": ((1024, 39), 32),
    "sr2_U": ((1024, 1024), 32),
    "passes": ((256, 4096), 32),    # the tile's inputs in several passes
    "rows64": ((256, 512), 64),     # 64-wide blocks, dense ones read in place
}
DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]
_MATS: dict = {}


def pruned_like(shape, b, seed) -> PaddedCSB:
    """A PaddedCSB of ``shape`` in b x b blocks: per block a live m and n
    drawn around 5.5, a dense block on each block-row's diagonal every
    fourth block-row, one block in nine with m = 0 or n = 0 (or both), and
    the padded kernel as wide as the block."""
    rng = np.random.default_rng(seed)
    out, inp = shape
    br, bc = -(-out // b), -(-inp // b)
    nb = br * bc
    vals = np.zeros((nb, b, b), np.float32)
    ridx = np.zeros((nb, b), np.int32)
    cidx = np.zeros((nb, b), np.int32)
    m = np.clip(rng.poisson(5.5, nb), 1, b).astype(np.int32)
    n = np.clip(rng.poisson(5.5, nb), 1, b).astype(np.int32)
    for i in range(br):
        for j in range(bc):
            blk = i * bc + j
            cols = min(b, inp - j * b)      # the block's real columns
            rows = min(b, out - i * b)
            if i % 4 == 0 and j == i * bc // br:
                m[blk], n[blk] = rows, cols
            kind = rng.integers(9)
            if kind == 0:
                m[blk] = 0
            elif kind == 1:
                n[blk] = 0
            elif kind == 2:
                m[blk] = n[blk] = 0
            m[blk], n[blk] = min(m[blk], rows), min(n[blk], cols)
            mb, nbk = int(m[blk]), int(n[blk])
            ridx[blk, :mb] = np.sort(rng.choice(rows, mb, replace=False))
            cidx[blk, :nbk] = np.sort(rng.choice(cols, nbk, replace=False))
            vals[blk, :mb, :nbk] = rng.normal(size=(mb, nbk))
    t = torch.from_numpy
    return PaddedCSB(vals=t(vals), row_idx=t(ridx), col_idx=t(cidx),
                     m=t(m), n=t(n), shape=shape, grid=(br, bc),
                     block=(b, b))


def _on_card(name, vdtype, dev) -> PaddedCSB:
    key = (name, vdtype)
    if key not in _MATS:
        shape, b = B1_SHAPES[name]
        p = pruned_like(shape, b, seed=sum(map(ord, name))).to(dev)
        p.vals = p.vals.to(vdtype)
        _MATS[key] = p
    return _MATS[key]


def _launch(p, xp, rows):
    return csb_mvm.csb_mvm_cuda(p.vals, p.row_idx, p.col_idx, p.m, p.n, xp,
                                grid=p.grid, block=p.block, batch_tile=8,
                                group=1, rows=rows)


def _row_body(p, x):
    """The row body's outputs for x's rows, in slices it takes."""
    cols = p.grid[1] * p.block[1]
    step = csb_mvm.TILED_MIN_ROWS - 1
    parts = []
    for lo in range(0, x.shape[0], step):
        xs = x[lo: lo + step]
        parts.append(_launch(p, pad_to_grid(xs, 8, cols).contiguous(),
                             xs.shape[0])[: xs.shape[0]])
    return torch.cat(parts)


@pytest.mark.parametrize("vdtype,xdtype", DTYPES,
                         ids=["f32-f32", "f32-bf16", "bf16-f32", "bf16-bf16"])
@pytest.mark.parametrize("rows", ["threshold", 1000, 1024])
@pytest.mark.parametrize("name", list(B1_SHAPES))
def test_tiled_body_equals_row_body(cuda_device, name, rows, vdtype,
                                    xdtype):
    """Equal numbers, and the pad rows of the batch (8 past the true rows,
    plus the tile grid's own) written as zeros."""
    rows = csb_mvm.TILED_MIN_ROWS if rows == "threshold" else rows
    p = _on_card(name, vdtype, cuda_device)
    cols = p.grid[1] * p.block[1]
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, p.shape[1], generator=gen).to(cuda_device, xdtype)
    xp = pad_to_grid(x, 8, cols)
    xp = torch.cat([xp, torch.zeros_like(xp[:8])]).contiguous()
    tiled_before = csb_mvm.TILED_LAUNCHES
    y = _launch(p, xp, rows)
    assert csb_mvm.TILED_LAUNCHES == tiled_before + 1
    ref = _row_body(p, x)
    torch.cuda.synchronize()
    assert csb_mvm.TILED_LAUNCHES == tiled_before + 1
    np.testing.assert_array_equal(y[:rows].cpu().numpy(), ref.cpu().numpy())
    assert not y[rows:].any()
    if (vdtype, xdtype) == (torch.float32, torch.float32):
        plain = csb_mvm_ref(p.vals, p.row_idx, p.col_idx, p.m, p.n, xp,
                            grid=p.grid, block=p.block)
        torch.testing.assert_close(y, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows,tiled", [(1, 0), (1024, 1)])
def test_tiled_launches_count_the_tiled_body(cuda_device, rows, tiled):
    """``TILED_LAUNCHES`` counts a launch at 1,024 rows and none at one;
    ``LAUNCHES`` counts both."""
    p = _on_card("sr1_U", torch.float32, cuda_device)
    x = torch.randn(rows, p.shape[1], device=cuda_device)
    xp = pad_to_grid(x, 8, p.grid[1] * p.block[1]).contiguous()
    before = (csb_mvm.LAUNCHES, csb_mvm.TILED_LAUNCHES)
    _launch(p, xp, rows)
    torch.cuda.synchronize()
    assert (csb_mvm.LAUNCHES - before[0],
            csb_mvm.TILED_LAUNCHES - before[1]) == (1, tiled)

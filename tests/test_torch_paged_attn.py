"""Port of kernels/paged_attn.py: the plain version ``paged_attn_ref``
(what ``paged_attn_decode`` runs on a CPU tensor) against the JAX
package's Pallas kernel ``paged_attn_decode`` in interpret mode, on the
edge cases of tests/test_paged_attn.py, at that file's 1e-6 bound
(``test_kernel_*``; fp32 summation order only). The CUDA kernel runs only
on the card: the last test here, and chip_smoke.py, which also covers
long caches and the boundaries of the key splits at full size. The
``test_plan_*`` tests check the host's launch plan (heads per CTA, pages
per split, the grid) at every shape chip_smoke.py launches."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attn_decode as j_paged_attn
from repro_torch.kernels import paged_attn, paged_attn_decode, paged_attn_ref
from repro_torch.kernels.paged_attn import (
    KERNELS_PER_CALL, paged_attn_cuda, plan, smem_bytes, workspace_floats,
)

SMS = 132                  # streaming multiprocessors of an H100 SXM

T3 = [[0, 1, 2], [3, 4, 9], [5, 6, 7]]

# (b, h, kv, d, dv, d2, psz, n_pages, table, pos, window)
CASES = {
    "vector-pos-page-boundaries": (3, 4, 2, 8, 8, 0, 4, 9,
                                   [[0, 1], [2, 3], [5, 6]], [3, 4, 7],
                                   None),
    "max-pages-1-scalar-pos": (3, 2, 1, 16, 16, 0, 8, 4,
                               [[2], [0], [3]], 0, None),
    "max-pages-1-vector-pos": (3, 2, 1, 16, 16, 0, 8, 4,
                               [[2], [0], [3]], [3, 0, 7], None),
    "inactive-slot-scratch-page": (2, 4, 2, 8, 8, 0, 4, 5,
                                   [[0, 1], [4, 4]], [6, 0], None),
    "window-6": (3, 4, 2, 16, 16, 0, 4, 10, T3, [7, 2, 10], 6),
    "window-3-scalar-pos": (3, 4, 2, 16, 16, 0, 4, 10, T3, 9, 3),
    "mla-rope-dv-ne-d": (3, 2, 1, 32, 16, 8, 4, 10, T3, [7, 2, 10], None),
    "rope-16-heads-window": (3, 16, 1, 16, 8, 8, 4, 10, T3, [7, 2, 10], 5),
    "gqa-rep-3": (3, 6, 2, 16, 16, 0, 4, 10, T3, [11, 0, 5], None),
    "pos-before-every-key": (3, 4, 2, 8, 8, 0, 4, 10, T3, [-1, 3, 0],
                             None),
    # hymba-1.5b's attention: 25 query heads over 5 KV heads (rep 5, an
    # odd number of heads per CTA), head dim 64, pages of 16
    "hymba-25-over-5": (4, 25, 5, 64, 64, 0, 16, 13,
                        [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 12, 12]],
                        [47, 16, 31, 15], None),
}


def _inputs(seed, b, h, kv, d, dv, d2, psz, n_pages):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = dict(q=r(b, h, d), k_pool=r(n_pages, psz, kv, d),
               v_pool=r(n_pages, psz, kv, dv))
    if d2:
        out.update(q2=r(b, h, d2), k2_pool=r(n_pages, psz, kv, d2))
    return out


def _both(name, seed=0, dtype=np.float32):
    b, h, kv, d, dv, d2, psz, n_pages, table, pos, window = CASES[name]
    arrays = _inputs(seed, b, h, kv, d, dv, d2, psz, n_pages)
    kw = dict(scale=1.0 / math.sqrt(d), window=window)
    jx = {k: jnp.asarray(v).astype(dtype) for k, v in arrays.items()}
    jpos = pos if isinstance(pos, int) else jnp.asarray(pos, jnp.int32)
    want = j_paged_attn(jx["q"], jx["k_pool"], jx["v_pool"],
                        jnp.asarray(table, jnp.int32), jpos,
                        q2=jx.get("q2"), k2_pool=jx.get("k2_pool"), **kw)
    tdt = torch.bfloat16 if dtype != np.float32 else torch.float32
    tx = {k: torch.from_numpy(v).to(tdt) for k, v in arrays.items()}
    args = (tx["q"], tx["k_pool"], tx["v_pool"],
            torch.tensor(table, dtype=torch.int32), pos)
    return want, args, dict(q2=tx.get("q2"), k2_pool=tx.get("k2_pool"),
                            **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_kernel(name):
    want, args, kw = _both(name)
    got = paged_attn_ref(*args, **kw)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["vector-pos-page-boundaries",
                                  "mla-rope-dv-ne-d", "window-6"])
def test_plain_version_matches_jax_kernel_bf16(name):
    """bf16 pools: both round q and the probabilities to bf16 before the
    products; a probability within an fp32 ulp of a bf16 rounding
    boundary may round the other way, one bf16 ulp (2^-8 of p <= 1,
    times |v| ~ 1): 1e-2, the bound chip_smoke.py holds the kernel to."""
    want, args, kw = _both(name, seed=1, dtype=jnp.bfloat16)
    got = paged_attn_ref(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_dispatch_runs_the_plain_version_on_the_cpu():
    _, args, kw = _both("window-6")
    before = paged_attn.LAUNCHES
    torch.testing.assert_close(paged_attn_decode(*args, **kw),
                               paged_attn_ref(*args, **kw), rtol=0, atol=0)
    assert paged_attn.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises; it never computes."""
    _, args, kw = _both("window-6")
    pos = torch.tensor([7, 2, 10], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attn_cuda(*args[:4], pos, **kw)


def test_dispatch_refuses_a_tensor_on_another_device():
    _, args, kw = _both("window-6")
    q = torch.empty(args[0].shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        paged_attn_decode(q, *args[1:], **kw)


# (b, rep, kv, d, d2, psz, max_pages) of every call chip_smoke.py makes
PLANNED = {
    "gemma-2b-4-slots": (4, 8, 1, 256, 0, 16, 65),
    "gemma-2b-1-slot": (1, 8, 1, 256, 0, 16, 65),
    "gemma-2b-16-slots": (16, 8, 1, 256, 0, 16, 65),
    "gemma-2b-63-pages": (4, 8, 1, 256, 0, 16, 63),
    "mla-128-heads-rope": (2, 128, 1, 512, 64, 16, 16),
    "long-8000-keys": (2, 8, 1, 64, 0, 16, 500),
    "long-64000-keys": (1, 1, 1, 32, 0, 16, 4000),
    "gqa-rep-3": (3, 3, 2, 16, 0, 4, 3),
    "rope-16-heads": (3, 16, 1, 16, 8, 4, 3),
    "max-pages-1": (3, 2, 1, 16, 0, 8, 1),
    "split-edges": (2, 4, 2, 64, 0, 16, 24),
    "hymba-25-over-5-heads": (4, 5, 5, 64, 0, 16, 65),
    "hymba-generate-twin": (4, 5, 5, 64, 0, 16, 18),
    "hymba-short-prompts": (4, 5, 5, 64, 0, 16, 1),
}


def test_plan_keeps_gemma_scores_in_one_cta():
    """gemma-2b's 4 slots x 1040 keys: all 8 heads of the group in one
    CTA, splits of 2 pages (32 keys), 33 x 4 = 132 CTAs: one wave."""
    hpc, ps, splits = plan(4, 8, 1, 256, 0, 16, 65, SMS)
    assert (hpc, ps, splits) == (8, 2, 33)
    assert splits * 4 * 1 * (8 // hpc) == SMS
    assert smem_bytes(8, 256, 0, 32, 2, 33) == 4 * (8 * (256 + 32) + 2)


@pytest.mark.parametrize("name", list(PLANNED))
def test_plan_fits_shared_memory(name):
    """Both kernels' shared memory and the workspace fit at every shape
    chip_smoke.py launches; the heads of a CTA divide the group."""
    b, rep, kv, d, d2, psz, mp = PLANNED[name]
    hpc, ps, splits = plan(b, rep, kv, d, d2, psz, mp, SMS)
    assert rep % hpc == 0
    assert smem_bytes(hpc, d, d2, ps * psz, ps, splits) <= 232448
    n_sc, n_st, n_out = workspace_floats(b, rep * kv, d, psz, mp, splits)
    assert all(n % 4 == 0 for n in (n_sc, n_st))
    assert 4 * (n_sc + 2 * n_st + n_out) < 2 ** 30
    assert kv * (rep // hpc) <= 65535


@pytest.mark.parametrize("name", list(PLANNED))
def test_plan_splits_cover_every_key_once(name):
    """Split s owns pages s*ps .. s*ps+ps-1 (the last one fewer): the
    splits cover keys 0 .. max_pages*P - 1 exactly once, page-aligned."""
    b, rep, kv, d, d2, psz, mp = PLANNED[name]
    _, ps, splits = plan(b, rep, kv, d, d2, psz, mp, SMS)
    seen = np.zeros(mp * psz, int)
    for s in range(splits):
        a, z = s * ps * psz, min((s + 1) * ps * psz, mp * psz)
        assert a % psz == 0 and a < z
        seen[a:z] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("sms", [SMS, 114])
@pytest.mark.parametrize("name", list(PLANNED))
def test_plan_fills_one_wave(name, sms):
    """At least one CTA per SM (132 on an H100 SXM, 114 on an H100 PCIe)
    wherever the table has pages enough (one page per split at most), and
    no split smaller than it must be: one page more per split would fall
    short of a wave."""
    b, rep, kv, d, d2, psz, mp = PLANNED[name]
    hpc, ps, splits = plan(b, rep, kv, d, d2, psz, mp, sms)
    groups = b * kv * (rep // hpc)
    assert splits * groups >= sms or ps == 1
    if ps < mp and smem_bytes(hpc, d, d2, (ps + 1) * psz, ps + 1,
                              -(-mp // (ps + 1))) <= 232448:
        assert -(-mp // (ps + 1)) * groups < sms


def test_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 1, 1, 65536, 0, 16, 1, SMS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_kernel_matches_plain_on_card(cuda_device, name, dtype, tol):
    b, h, kv, d, dv, d2, psz, n_pages, table, pos, window = CASES[name]
    arrays = _inputs(2, b, h, kv, d, dv, d2, psz, n_pages)
    t = {k: torch.from_numpy(v).to(cuda_device, dtype)
         for k, v in arrays.items()}
    args = (t["q"], t["k_pool"], t["v_pool"],
            torch.tensor(table, dtype=torch.int32, device=cuda_device), pos)
    kw = dict(scale=1.0 / math.sqrt(d), window=window, q2=t.get("q2"),
              k2_pool=t.get("k2_pool"))
    before = paged_attn.LAUNCHES
    got = paged_attn_decode(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attn.LAUNCHES == before + KERNELS_PER_CALL
    torch.testing.assert_close(got, paged_attn_ref(*args, **kw), rtol=tol,
                               atol=tol)

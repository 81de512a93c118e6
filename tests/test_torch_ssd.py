"""Port of models/layers.py's mamba2 SSD block and hymba's hybrid mixer
(tests/test_torch_lm_ssd.py holds the SSD and hybrid branches of
models/lm.py, tests/test_torch_serve_ssd.py the serve paths).

The same numpy-seeded inputs and the JAX package's own parameters
(through ``lm_params_from_numpy``) go through both packages, JAX's jitted
as its engine runs them. In fp32 every output and cache leaf agrees at
2e-5, the port's prefill and decode bound (tests/test_torch_models.py),
well inside the 2e-3 of the matching reference test,
tests/test_models.py::test_ssd_decode_matches_scan; the chunked scan
agrees at 1e-5. A state stored in bf16 (``ssd_state_dtype``, bf16 in
both reduced configs) is held at the port's bf16 bound, 1e-2: its fp32
update agrees at 2e-5, and the rounding to bf16 may then fall one ulp
apart. bf16 models are held at 1e-2 too.

JAX's functions are compiled with XLA's ``xla_allow_excess_precision``
off. By default XLA may skip a bf16 rounding inside a fusion (a bf16
residual sum fed on to an fp32 norm keeps its fp32 value), so the jitted
result depends on what XLA fuses; with the option off it rounds every
op to its type, as JAX's op-by-op semantics say and the port does. It
changes nothing in fp32. The paged decode
runs hymba's attention through the paged-attention kernel's plain
version (on the CPU) against JAX's Pallas kernel in interpret mode, and
through the gather path. Configs: the layers of reduced mamba2-370m
(fused in-projection) and hymba-1.5b (split in-projections)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve import PagePool as JPagePool
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.serve import PagePool

TOL = 2e-5
SCAN_TOL = 1e-5
BF16_TOL = 1e-2


def _cfgs(arch, **over):
    """The same configuration in both packages."""
    return (dataclasses.replace(j_configs.get_reduced(arch), **over),
            dataclasses.replace(t_configs.get_reduced(arch), **over))


def _carry(tree):
    """One layer's JAX parameter dict -> the port's (bf16 keeps its
    bits)."""
    stacked = jax.tree.map(lambda a: np.asarray(a)[None], tree)
    return lm_params_from_numpy({"layers": stacked}, device="cpu")[
        "layers"][0]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _jit(fn, *args, **static):
    """JAX's ``fn(*args, **static)`` jitted, every op rounded to its type
    (see the module docstring)."""
    return jax.jit(functools.partial(fn, **static)).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _tol(t, tol=TOL):
    """The bound of a leaf: bf16-stored ones at the bf16 bound."""
    return max(tol, BF16_TOL) if t.dtype == torch.bfloat16 else tol


def _x(seed, shape, dtype):
    x = _np(seed, *shape)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _layer(init, arch, seed, dtype="float32", **over):
    jcfg, tcfg = _cfgs(arch, dtype=dtype, **over)
    jp = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _carry(jp)


# ---------------------------------------------------------------------------
# the SSD primitives
# ---------------------------------------------------------------------------

def test_segsum_matches_jax():
    x = _np(0, 2, 3, 7)
    got = TL._segsum(torch.from_numpy(x))
    want = np.asarray(JL._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6,
                               atol=1e-6)


def test_softplus_is_jax_softplus_above_torch_threshold():
    """``F.softplus`` returns x above 20; JAX's is log(1 + e^x)
    everywhere. Both agree with the exact value at every x."""
    x = np.asarray([-30.0, -1.0, 0.0, 3.0, 19.5, 20.0, 20.5, 25.0, 40.0],
                   np.float32)
    np.testing.assert_array_equal(
        TL._softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))


@pytest.mark.parametrize("s", [5, 16, 37, 48],
                         ids=["one-partial-chunk", "one-chunk",
                              "three-chunks-partial", "three-chunks"])
def test_ssd_scan_matches_jax(s):
    """Chunk 16: one partial chunk, one whole, three ending on a partial
    chunk, three whole; y and the final fp32 state at 1e-5."""
    b, h, p, n = 2, 3, 8, 6
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    jy, jfin = _jit(JL.ssd_scan, *map(jnp.asarray, (x, dt, a, bm, cm)),
                    chunk=16)
    ty, tfin = TL.ssd_scan(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                           chunk=16)
    assert ty.dtype == torch.float32 and tfin.dtype == torch.float32
    _close(ty, jy, SCAN_TOL)
    _close(tfin, jfin, SCAN_TOL)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"],
                         ids=["fused-proj", "split-proj"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_init_matches_jax_shapes_and_dtypes(arch, dtype):
    """Both in-projections; a_log, d_skip and dt_bias fp32 in bf16."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp = JL.ssd_init(jax.random.PRNGKey(0), jcfg)
    tp = TL.ssd_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(v.dtype), k
    jc = JL.ssd_cache_init(jcfg, 3, jnp.dtype(dtype))
    tc = TL.ssd_cache_init(tcfg, 3, getattr(torch, dtype), "cpu")
    for k, v in jc.items():
        assert tuple(tc[k].shape) == v.shape
        assert str(tc[k].dtype).split(".")[-1] == str(v.dtype)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"],
                         ids=["fused-proj", "split-proj"])
@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_ssd_block_apply_prefill_matches_jax(arch, dtype, tol):
    """Prefill over 37 tokens (chunk 16: three chunks, the last
    partial), and the conv and SSM states ``_ssd_prefill`` leaves."""
    jcfg, tcfg, jp, tp = _layer(JL.ssd_init, arch, 1, dtype)
    # nonzero decay and skip, so every term of the block shows
    rng = np.random.default_rng(2)
    for k in ("a_log", "dt_bias", "d_skip"):
        v = rng.standard_normal(jp[k].shape).astype(np.float32) * 0.5
        jp = dict(jp, **{k: jnp.asarray(v)})
        tp[k] = torch.from_numpy(v)
    jx, tx = _x(3, (2, 37, jcfg.d_model), dtype)
    _close(TL.ssd_block_apply(tp, tx, tcfg),
           _jit(JL.ssd_block_apply, jp, jx, cfg=jcfg), tol)
    jy, jconv, jssm = _jit(JLM._ssd_prefill, jp, jx, cfg=jcfg)
    ty, tconv, tssm = TL.ssd_prefill(tp, tx, tcfg)
    assert tconv.dtype == tx.dtype and tssm.dtype == torch.float32
    for t, j in ((ty, jy), (tconv, jconv), (tssm, jssm)):
        assert tuple(t.shape) == j.shape
        _close(t, j, tol)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"],
                         ids=["fused-proj", "split-proj"])
@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_ssd_block_apply_decode_matches_jax(arch, dtype, tol):
    """One decode step from random states (SSM state in the config's
    bf16 state dtype): output, shifted conv state, updated SSM state."""
    jcfg, tcfg, jp, tp = _layer(JL.ssd_init, arch, 4, dtype)
    conv_dim = jcfg.d_inner + 2 * jcfg.d_state
    jx, tx = _x(5, (3, 1, jcfg.d_model), dtype)
    jconv, tconv = _x(6, (3, jcfg.conv_k - 1, conv_dim), dtype)
    jssm, tssm = _x(7, (3, jcfg.ssd_heads, jcfg.ssd_headdim, jcfg.d_state),
                    jcfg.ssd_state_dtype)
    want = _jit(lambda p, x, c, s: JL.ssd_block_apply(
        p, x, jcfg, conv_state=c, ssm_state=s, decode=True),
        jp, jx, jconv, jssm)
    got = TL.ssd_block_apply(tp, tx, tcfg, conv_state=tconv,
                             ssm_state=tssm, decode=True)
    for t, j in zip(got, want):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        _close(t, j, _tol(t, tol))


# ---------------------------------------------------------------------------
# the hybrid mixer
# ---------------------------------------------------------------------------

def test_hybrid_apply_matches_jax():
    jcfg, tcfg, jp, tp = _layer(JL.hybrid_init, "hymba-1.5b", 8)
    jx, tx = _x(9, (2, 21, jcfg.d_model), "float32")
    _close(TL.hybrid_apply(tp, tx, tcfg),
           _jit(JL.hybrid_apply, jp, jx, cfg=jcfg))


def _random_cache(cache, seed):
    """JAX's cache tree ``cache`` refilled with numpy-seeded values (each
    leaf in its own dtype), and the port's copy of it."""
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), cache)
    return jc, _carry(jc)


@pytest.mark.parametrize("vec", [False, True], ids=["scalar-pos",
                                                    "vector-pos"])
def test_hybrid_decode_matches_jax(vec):
    """Contiguous decode: attention over the cache, the SSD step on the
    per-slot states; every leaf written in place."""
    jcfg, tcfg, jp, tp = _layer(JL.hybrid_init, "hymba-1.5b", 11)
    jc, tc = _random_cache({"attn": JL.attn_cache_init(jcfg, 3, 12,
                                                       jnp.float32),
                            "ssd": JL.ssd_cache_init(jcfg, 3, jnp.float32)},
                           10)
    pos = np.asarray([7, 2, 10], np.int32) if vec else 7
    jx, tx = _x(12, (3, 1, jcfg.d_model), "float32")
    jy, jnew = _jit(lambda p, x, c, q: JL.hybrid_decode(p, x, jcfg, c, q),
                    jp, jx, jc, jnp.asarray(pos))
    ty, tnew = TL.hybrid_decode(tp, tx, tcfg, tc, torch.as_tensor(pos))
    assert tnew is tc
    _close(ty, jy)
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jnew)[0],
                            jax.tree.leaves(tnew)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        _close(t, j, _tol(t))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_hybrid_decode_paged_matches_jax(use_kernel):
    """Paged decode with slots at page boundaries and one slot inactive
    (all its pages the scratch page): JAX's Pallas kernel in interpret
    mode against the kernel's plain version, and both gather paths."""
    jcfg, tcfg, jp, tp = _layer(JL.hybrid_init, "hymba-1.5b", 13)
    psz, n_pages, max_pages = 4, 10, 3
    jpool = JPagePool(psz, n_pages, 3, max_pages)
    tpool = PagePool(psz, n_pages, 3, max_pages, device="cpu")
    pos_list = [7, 3, 0]
    for pool in (jpool, tpool):
        for s, p in enumerate(pos_list[:2]):
            pool.reserve(s, max_pages * psz)
            pool.ensure(s, p + 1)
    table = tpool.device_table()
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jpool.device_table()))
    jc, tc = _random_cache(
        {"attn": JL.attn_paged_cache_init(jcfg, n_pages + 1, psz,
                                          jnp.float32),
         "ssd": JL.ssd_cache_init(jcfg, 3, jnp.float32)}, 14)
    pos = np.asarray(pos_list, np.int32)
    jx, tx = _x(15, (3, 1, jcfg.d_model), "float32")
    jy, jnew = _jit(lambda p, x, c, q, tab: JL.hybrid_decode_paged(
        p, x, jcfg, c, q, tab, use_kernel), jp, jx, jc, jnp.asarray(pos),
        jpool.device_table())
    ty, tnew = TL.hybrid_decode_paged(tp, tx, tcfg, tc,
                                      torch.from_numpy(pos), table,
                                      use_kernel=use_kernel)
    assert tnew is tc
    _close(ty, jy)
    mapped = sorted({p for s in range(3) for p in tpool.slot_pages(s)})
    for k in ("k", "v"):
        _close(tnew["attn"][k][mapped], np.asarray(jnew["attn"][k])[mapped])
    for k in ("conv", "ssm"):
        _close(tnew["ssd"][k], jnew["ssd"][k], _tol(tnew["ssd"][k]))

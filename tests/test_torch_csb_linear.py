"""Port of core/csb_linear.py and models/layers.py::csb_dense: the same
weights and inputs go through the JAX package's ``CSBLinear`` (its csb
mode through the Pallas kernel in interpret mode) and the port's (the
kernel's plain version on the CPU). Bounds are tests/test_csb_linear.py's:
1e-5 for the dense and masked modes, 2e-5 for the csb mode. The packed
matrices are equal field for field, ``compression()`` is equal, and
``csb_specs_for_params`` selects JAX's paths on converted parameters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import core as J
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro.models import layers as JL
from repro_torch import core as T
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL

MODES = ("dense", "masked", "csb")
# (seed, weight shape as held, transposed, batch): tests/test_csb_linear.py
CASES = {"out-in": (0, (48, 32), False, 4), "in-out": (1, (32, 48), True, 3)}
TOL = {"dense": 1e-5, "masked": 1e-5, "csb": 2e-5}


def _pair(seed, shape, batch, spec=(16, 16, 0.5), transposed=False):
    key = jax.random.PRNGKey(seed)
    w = jax.random.normal(key, shape)
    x = jax.random.normal(key, (batch, shape[0] if transposed else shape[1]))
    jl = J.CSBLinear(weight=w, spec=J.CSBSpec(*spec), mode="masked",
                     transposed=transposed)
    tl = T.CSBLinear(torch.from_numpy(np.array(w)), T.CSBSpec(*spec),
                     mode="masked", transposed=transposed)
    return jl, tl, x, torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_modes_match_jax(case, mode):
    seed, shape, transposed, batch = CASES[case]
    jl, tl, xj, xt = _pair(seed, shape, batch, transposed=transposed)
    if mode == "csb":
        jl, tl = jl.freeze(), tl.freeze()
    else:
        jl = dataclasses.replace(jl, mode=mode)
        tl.mode = mode
    got = tl(xt)
    assert got.dtype == torch.float32 and got.shape == (batch, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl(xj)),
                               rtol=TOL[mode], atol=TOL[mode])


@pytest.mark.parametrize("case", CASES)
def test_freeze_packs_as_jax(case):
    seed, shape, transposed, batch = CASES[case]
    jl, tl, _, _ = _pair(seed, shape, batch, transposed=transposed)
    jf, tf = jl.freeze(), tl.freeze()
    assert tf.mode == "csb" and tl.mode == "masked"
    assert tf.weight is tl.weight and tf.spec == tl.spec
    jp, tp = jf._packed, tf._packed
    for f in ("vals", "row_idx", "col_idx", "m", "n"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    assert (tp.shape, tp.grid, tp.block) == (tuple(jp.shape),
                                            tuple(jp.grid), tuple(jp.block))
    assert tf.compression() == jf.compression() > 1.5
    assert tl.compression() == jl.compression() == 1.0


def test_freeze_keeps_autograd_out_and_refuses_a_mesh():
    w = torch.nn.Parameter(torch.randn(32, 16))
    lin = T.CSBLinear(w, T.CSBSpec(8, 8, 0.5), mode="masked")
    assert list(lin.parameters()) == [w]
    lin(torch.randn(2, 16)).sum().backward()
    mask = T.csb_project(w.detach(), lin.spec) != 0
    np.testing.assert_array_equal((w.grad != 0).numpy(), mask.numpy())
    frozen = lin.freeze()
    assert not frozen._packed.vals.requires_grad
    # the mesh path itself runs over spawned ranks in
    # tests/test_torch_csb_sharded.py; what is not a DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh, got object"):
        frozen(torch.randn(2, 16), mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh, got object"):
        frozen.shard_for_mesh(object())
    with pytest.raises(RuntimeError, match="freeze"):
        T.CSBLinear(w, lin.spec, mode="csb")(torch.randn(2, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frozen", [False, True])
def test_csb_dense_matches_jax(dtype, frozen):
    """An LM projection held (in, out), as models/layers.py holds it."""
    key = jax.random.PRNGKey(3)
    w = jax.random.normal(key, (64, 96)) / 8
    x = jax.random.normal(jax.random.PRNGKey(4), (2, 5, 64)).astype(dtype)
    spec = (32, 32, 0.75)
    jl = J.CSBLinear(weight=w, spec=J.CSBSpec(*spec), mode="masked",
                     transposed=True)
    tl = T.CSBLinear(torch.from_numpy(np.array(w)), T.CSBSpec(*spec),
                     mode="masked", transposed=True)
    if frozen:
        jl, tl = jl.freeze(), tl.freeze()
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = TL.csb_dense(xt, tl)
    if dtype == "bfloat16" and not frozen:
        # XLA:CPU cannot run a bf16 x bf16 product: widen JAX's operands
        # (the rounding of w to bf16 is kept), as the other bf16 tests do
        wm = J.csb_project(w.T, J.CSBSpec(*spec)).astype(jnp.bfloat16)
        want = jnp.einsum("...i,oi->...o", x.astype(jnp.float32),
                          wm.astype(jnp.float32)).astype(jnp.bfloat16)
    else:
        want = JL.csb_dense(x, jl)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 5, 96)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


TINY = dict(name="t", mixer="attn", ffn="swiglu", n_layers=2, d_model=64,
            n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=100,
            dtype="float32")
SELECT = {
    "gemma-2b reduced, defaults": ("gemma-2b", {}),
    "gemma-2b reduced, min_dim 16": ("gemma-2b", dict(min_dim=16)),
    # JAX's stacked (L, d) norms reach min_dim 2: rank 1 in the port
    "gemma-2b reduced, min_dim 2": ("gemma-2b", dict(min_dim=2)),
    "gemma-2b reduced, exclude w_": ("gemma-2b", dict(exclude=("w_",),
                                                      min_dim=16)),
    "tests/test_csb_linear.py's model, min_dim 32": ("tiny",
                                                     dict(min_dim=32)),
}


def _chosen_jax(specs):
    flat = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: x is None or isinstance(x, J.CSBSpec))
    return {tuple(getattr(k, "key", str(k)) for k in path)
            for path, v in flat if isinstance(v, J.CSBSpec)}


def _chosen_port(specs, keys=()):
    """Selected paths, without the index into the port's layer list (the
    path JAX's stacked leaf has)."""
    if isinstance(specs, dict):
        return set().union(*(_chosen_port(v, keys + (k,))
                             for k, v in specs.items()))
    if isinstance(specs, list):
        return set().union(*(_chosen_port(v, keys) for v in specs))
    return {keys} if isinstance(specs, T.CSBSpec) else set()


@pytest.mark.parametrize("case", SELECT)
def test_spec_tree_selects_jax_paths(case):
    arch, kw = SELECT[case]
    cfg = (j_configs.get_reduced(arch) if arch != "tiny"
           else JModelConfig(**TINY))
    params = j_init(jax.random.PRNGKey(2), cfg)
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                   device="cpu")
    jspec, tspec = J.CSBSpec(8, 8, 0.5), T.CSBSpec(8, 8, 0.5)
    want = _chosen_jax(J.csb_specs_for_params(params, jspec, **kw))
    tree = T.csb_specs_for_params(tparams, tspec, **kw)
    assert want and _chosen_port(tree) == want
    # the spec tree mirrors the params, one entry per layer
    assert len(tree["layers"]) == cfg.n_layers
    assert set(tree) == set(tparams)


def test_spec_tree_of_an_rnn_keeps_the_substring_rule():
    """SR1-shaped tree (cells in a list, not under "layers"): "embed"
    does not exclude "emb", so the pipeline passes ("emb", "out")."""
    rng = np.random.default_rng(0)
    shapes = {"W_i": (96, 40), "U_i": (96, 64), "b_i": (96,),
              "W_proj": (64, 96)}
    tree = {"emb": rng.normal(size=(80, 80)).astype(np.float32),
            "rnn": [{k: rng.normal(size=s).astype(np.float32)
                     for k, s in shapes.items()} for _ in range(2)],
            "out": rng.normal(size=(64, 4)).astype(np.float32)}
    ttree = {"emb": torch.from_numpy(tree["emb"]),
             "rnn": [{k: torch.from_numpy(v) for k, v in c.items()}
                     for c in tree["rnn"]],
             "out": torch.from_numpy(tree["out"])}
    for kw in ({}, dict(exclude=("emb", "out")), dict(min_dim=4)):
        want = _chosen_jax(J.csb_specs_for_params(
            jax.tree.map(jnp.asarray, tree), J.CSBSpec(), **kw))
        got = T.csb_specs_for_params(ttree, T.CSBSpec(), **kw)
        paths = {(k,) for k in ("emb", "out") if got[k] is not None} | {
            ("rnn", f"[{i}]", n) for i, c in enumerate(got["rnn"])
            for n, s in c.items() if s is not None}
        assert paths == want, kw
    assert ("emb",) in _chosen_jax(J.csb_specs_for_params(
        jax.tree.map(jnp.asarray, tree), J.CSBSpec()))

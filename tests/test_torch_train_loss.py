"""The training forward of models/lm.py (``layer_apply``, ``backbone``,
``lm_loss``, ``forward_loss``) and its autograd gradients against the JAX
package's jitted ``value_and_grad``, on the CPU.

Every ``ARCH_IDS`` reduced config (fp32) with JAX's ``PRNGKey`` params
carried across by ``convert.lm_params_from_numpy``, one numpy batch; the
port's gradients are restacked into JAX's layout
(``convert.params_to_numpy``) and compared leaf by leaf. Bounds: the
loss within 1e-5 (fp32 sums in another order through two layers and the
chunked CE: observed <= 1.5e-6); a gradient element within 1e-4 of its
own size plus 1e-5 of the largest gradient of the model (observed
<= 3e-6 of a leaf's largest). The second term is there for leaves whose
gradient is analytically zero and so only round-off in both packages:
llama4's top-1 router, whose one gate value is divided by itself."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_reduced as j_reduced
from repro.models import ModelConfig as JModelConfig
from repro.models import forward_loss as j_forward_loss
from repro.models import init_params as j_init
from repro.models.lm import lm_loss as j_lm_loss
from repro_torch import _tree
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy, params_to_numpy
from repro_torch.models import ModelConfig, forward_loss, lm_loss
from repro_torch.models import layers as L

LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
            d_ff=128, vocab=97, dtype="float32", logit_chunk=16, remat=False)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Models of a few thousand parameters: one intra-op thread. Under
    the suite's parallel workers more threads a process only contend
    (the file took 8x longer with torch's default of one a core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    toks = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if cfg.n_img_tokens:
        batch["img_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, 1024)).astype(np.float32)
    return batch


def _port_value_and_grad(params, batch, cfg):
    leaves = [p for ps in _tree.leaves(params) for p in ps]
    for p in leaves:
        p.requires_grad_(True)
    loss = forward_loss(params, {k: torch.as_tensor(v)
                                 for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(grads)
    tree = _tree.rebuild(params, iter([[next(it) for _ in ps]
                                       for ps in _tree.leaves(params)]))
    return float(loss.detach()), tree


def _jax_and_port(jcfg, cfg, key, batch):
    jp = j_init(jax.random.PRNGKey(key), jcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_loss(p, b, jcfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    tl, tg = _port_value_and_grad(params, batch, cfg)
    return float(jl), jax.tree.map(np.asarray, jg), tl, tg


def _grads_close(jg, tg):
    want = jax.tree_util.tree_leaves_with_path(jg)
    got = jax.tree.leaves(params_to_numpy(tg))
    assert len(want) == len(got)
    scale = max(float(np.abs(a).max()) for _, a in want)
    for (path, a), b in zip(want, got):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_reduced_train_step(arch):
    """tests/test_arch_smoke.py::test_arch_reduced_train_step's step: the
    loss is finite, the gradients are finite and not all zero; and both
    equal JAX's."""
    cfg, jcfg = get_reduced(arch), j_reduced(arch)
    batch = _batch(cfg)
    jl, jg, tl, tg = _jax_and_port(jcfg, cfg, hash(arch) % 2**31, batch)
    assert np.isfinite(tl)
    gn = sum(float(torch.sum(torch.abs(g))) for ps in _tree.leaves(tg)
             for g in ps)
    assert np.isfinite(gn) and gn > 0.0
    assert abs(tl - jl) <= LOSS_TOL, (tl, jl)
    _grads_close(jg, tg)


def test_loss_label_masking():
    """tests/test_models.py::test_loss_label_masking: masking labels with
    -1 changes the loss; both losses equal JAX's."""
    jcfg = JModelConfig(name="t", mixer="attn", ffn="swiglu", **BASE)
    cfg = ModelConfig(name="t", mixer="attn", ffn="swiglu", **BASE)
    jp = j_init(jax.random.PRNGKey(9), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    batch = _batch(cfg, s=24)
    masked = dict(batch, labels=batch["labels"].copy())
    masked["labels"][:, :8] = -1
    losses = []
    for b in (batch, masked):
        jl = float(j_forward_loss(jp, {k: jnp.asarray(v)
                                       for k, v in b.items()}, jcfg))
        with torch.no_grad():
            tl = float(forward_loss(params, {k: torch.as_tensor(v)
                                             for k, v in b.items()}, cfg))
        assert np.isfinite(tl) and abs(tl - jl) <= LOSS_TOL, (tl, jl)
        losses.append(tl)
    assert abs(losses[0] - losses[1]) > 1e-6


@pytest.mark.parametrize("s,chunk,codebooks,pad", [
    (40, 16, 0, 1), (40, 16, 0, 128), (32, 64, 0, 1), (24, 8, 3, 1)])
def test_lm_loss_chunks_and_codebooks(s, chunk, codebooks, pad):
    """``lm_loss`` alone on random hidden states: a sequence that the chunk
    does not divide (the last chunk padded with -1 labels), a vocab of 97
    padded to 128 (the padded columns set to -1e30), one chunk longer
    than the sequence, and K codebook label streams against a (d, K*V)
    head; scattered -1 labels."""
    rng = np.random.default_rng(s)
    over = dict(BASE, logit_chunk=chunk, n_codebooks=codebooks,
                vocab_pad=pad)
    jcfg = JModelConfig(name="t", mixer="attn", ffn="swiglu", **over)
    cfg = ModelConfig(name="t", mixer="attn", ffn="swiglu", **over)
    cols = codebooks * cfg.vocab if codebooks else cfg.padded_vocab
    head = rng.standard_normal((64, cols)).astype(np.float32) * 0.1
    hidden = rng.standard_normal((2, s, 64)).astype(np.float32)
    shape = (2, s, codebooks) if codebooks else (2, s)
    labels = rng.integers(-1, cfg.vocab, shape).astype(np.int32)
    jl = float(j_lm_loss({"head": jnp.asarray(head)}, jnp.asarray(hidden),
                         jnp.asarray(labels), jcfg))
    tl = float(lm_loss({"head": torch.from_numpy(head)},
                       torch.from_numpy(hidden), torch.from_numpy(labels),
                       cfg))
    assert abs(tl - jl) <= LOSS_TOL, (tl, jl)


@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b",
                                  "deepseek-v2-236b"])
def test_remat_changes_no_number(arch):
    """``cfg.remat`` checkpoints each layer (backward runs it again): the
    loss and every gradient are bit-equal to the run without it."""
    base = get_reduced(arch)
    jcfg = j_reduced(arch)
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(1), jcfg))
    batch = _batch(base)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        out[remat] = _port_value_and_grad(
            lm_params_from_numpy(jp, device="cpu"), batch, cfg)
    assert out[True][0] == out[False][0]
    for a, b in zip(_tree.leaves(out[True][1]), _tree.leaves(out[False][1])):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_expert_products_keep_their_gradient():
    """``_mm_f32`` off the CPU takes bf16 operands straight into an fp32
    product (``bmm``'s ``out_dtype``), which has no derivative: where
    autograd records the product it goes through fp32 operands instead.
    Meta tensors stand in for the card's."""
    a = torch.randn(2, 3, 4, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    b = torch.randn(2, 4, 5, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    y = L._mm_f32(a, b)
    assert y.dtype == torch.float32 and y.requires_grad
    ga, gb = torch.autograd.grad(y.sum(), (a, b))
    assert ga.dtype == gb.dtype == torch.bfloat16
    with torch.no_grad():          # decode: the one-read form
        assert L._mm_f32(a, b).dtype == torch.float32

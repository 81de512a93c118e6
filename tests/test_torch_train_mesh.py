"""Training on a mesh of gloo ranks (``repro_torch.dist`` placements,
``train.loop`` on DTensors) against the JAX package's unsharded
``train``: (1, 2) and (2, 1) ("data", "model") meshes; the (2, 2) mesh,
the other optimizers and the DTensor traps are in
tests/test_torch_train_mesh_2x2.py.

Each mesh runs once, in a module fixture, as ranks spawned by
``spawn_ranks(..., device="cpu")`` (a deadline each) that train every
case in one job, as the launcher does on its mesh (tests/_torch_mesh_jobs.py):
tests/test_train.py's tiny ``CFG`` (AdamW, AdamW with int8
compression, and AdamW with the params on FSDP's placements,
``ShardingPolicy(fsdp=True)``: each weight also split over "data",
the embedding on its d dim; 8 steps each), reduced deepseek-v2-236b (MLA and MoE) and
reduced mamba2-370m (SSD), 3 steps each, from JAX's ``PRNGKey(0)``
params carried across by ``lm_params_from_numpy``, on the same numpy
batches. The (1, 2) job also runs ADMM on the tiny model and writes a
checkpoint, which the (2, 1) job restores through ``shardings`` and JAX
restores too; the (2, 1) job also restores a checkpoint JAX wrote. The (2, 1) job runs DTensor's collectives as c10d's
synchronous ones (``dist.gloo_cuda``, what the card's gloo ranks run).
JAX runs in the parent, beside the spawns.

Bounds, tests/test_torch_train.py's: losses within 1e-5, AdamW's params
within 5e-4, compressed losses within 5e-4; ADMM losses within 1e-4 and
the same pruning masks (tests/test_torch_train.py's ADMM test). Every
rank reports the same losses.
"""
import concurrent.futures
import os

import numpy as np
import pytest
import torch

from repro_torch.dist.launch import spawn_ranks

import _torch_mesh_jobs as jobs

MESHES = ((1, 2), (2, 1))
STEPS = {"tiny": 8, "deepseek-v2-236b": 3, "mamba2-370m": 3}
BATCH, SEQ = 8, 32
TINY_CASES = ("tiny-adamw", "tiny-adamw-int8", "tiny-adamw-fsdp")
LM_CASES = ("deepseek-v2-236b", "mamba2-370m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in the parent (the JAX references' torch side
    is tiny); the ranks pin their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases():
    """{name: (arch, tcfg kwargs, extra)}, shared with the JAX side."""
    base = dict(lr=3e-3, log_every=1000)
    cases = {
        "tiny-adamw": ("tiny", dict(base, steps=8), {}),
        "tiny-adamw-int8": ("tiny", dict(base, steps=8, compress_grads=True),
                            {}),
        "tiny-adamw-fsdp": ("tiny", dict(base, steps=8), {"fsdp": True}),
        "tiny-admm": ("tiny", dict(base, steps=10, admm_every=5,
                                   admm_rho=0.05), {"admm": True}),
    }
    for arch in LM_CASES:
        cases[arch] = (arch, dict(base, steps=STEPS[arch]), {})
    return cases


def _jax_inputs(arch, seed=0):
    """JAX's config, its params from ``PRNGKey(seed)`` and the task."""
    import jax
    from repro.configs import get_reduced as j_reduced
    from repro.data import CharLMTask
    from repro.models import ModelConfig as JModelConfig
    from repro.models import init_params as j_init
    cfg = (JModelConfig(**jobs.TINY) if arch == "tiny" else j_reduced(arch))
    jp = j_init(jax.random.PRNGKey(seed), cfg)
    task = CharLMTask(vocab=min(cfg.vocab, 256), seed=seed)
    return cfg, jp, task


def _jax_run(name, arch, tcfg, extra, batches):
    import jax
    import jax.numpy as jnp
    from repro.core import CSBSpec as JSpec
    from repro.models import forward_loss as j_loss
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import train as j_train
    cfg, jp, _ = _jax_inputs(arch, 1 if extra.get("admm") else 0)
    specs = None
    if extra.get("admm"):
        specs = jax.tree.map(lambda _: None, jp)
        specs["layers"]["mixer"]["wq"] = JSpec(bm=8, bn=8, prune_rate=0.5)
        specs["layers"]["mixer"]["wo"] = JSpec(bm=8, bn=8, prune_rate=0.5)
    jb = ((s, {k: jnp.asarray(v) for k, v in b.items()})
          for s, b in enumerate(batches))
    jp, hist = j_train(lambda p, b: j_loss(p, b, cfg), jp, jb,
                       JTrainConfig(**tcfg), csb_specs=specs,
                       log=lambda *_: None)
    return [h["loss"] for h in hist], jobs.numpy_tree(
        jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results per mesh, JAX's per case and the checkpoint
    (its directory, its step, the 1x2 run's params)."""
    import jax
    ckdir = str(tmp_path_factory.mktemp("mesh-ckpt"))
    cases, inputs = {}, {}
    for name, (arch, tcfg, extra) in _cases().items():
        cfg, jp, task = _jax_inputs(arch, 1 if extra.get("admm") else 0)
        batches = [task.batch(s, BATCH, SEQ) for s in range(tcfg["steps"])]
        # JAX's train donates its params: numpy copies first
        np_params = jobs.numpy_tree(jax.tree.map(np.asarray, jp))
        cases[name] = dict(arch=arch, tcfg=tcfg, params=np_params,
                           batches=batches, **extra)
        inputs[name] = (arch, tcfg, extra, batches)
    steps = cases["tiny-adamw"]["tcfg"]["steps"]
    first = dict(cases)
    first["tiny-adamw"] = dict(cases["tiny-adamw"], tcfg=dict(
        cases["tiny-adamw"]["tcfg"], ckpt_dir=ckdir, ckpt_every=steps))

    # a checkpoint the JAX package writes: PRNGKey(0)'s params, AdamW's
    # fresh state, step 0
    from repro.optim import get_optimizer as j_opt
    from repro.train import checkpoint as j_ckpt
    jdir = str(tmp_path_factory.mktemp("jax-ckpt"))
    jparams = jax.tree.map(np.asarray, _jax_inputs("tiny")[1])
    j_ckpt.save(jdir, 0, {"opt": j_opt("adamw").init(jparams),
                          "params": jparams})

    def saved_then_restored():
        out = spawn_ranks(jobs.train_cases, (1, 2), first, device="cpu",
                          timeout_s=300)
        return out, spawn_ranks(
            jobs.restore_cases, (2, 1), [(ckdir, steps), (jdir, 0)],
            cases["tiny-adamw"]["params"], device="cpu", timeout_s=120)

    second = {k: v for k, v in cases.items() if k != "tiny-admm"}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fut_a = pool.submit(saved_then_restored)
        # the (2, 1) ranks run DTensor's collectives as the card's gloo
        # ranks do (dist.gloo_cuda, registered for the CPU)
        fut_b = pool.submit(spawn_ranks, jobs.train_cases, (2, 1), second,
                            True, device="cpu", timeout_s=300)
        jax_out = {name: _jax_run(name, *inputs[name]) for name in inputs}
        (a, restored), b = fut_a.result(), fut_b.result()
    ranks = {(1, 2): a, (2, 1): b, "restored": restored}
    return {"ranks": ranks, "jax": jax_out, "ckpt": (ckdir, steps),
            "jax_ckpt_params": jobs.numpy_tree(jparams)}


def _rank0(runs, mesh, name):
    res = runs["ranks"][mesh]
    for r in res[1:]:
        assert r[name]["losses"] == res[0][name]["losses"], name
    return res[0][name]


def _close_params(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_params(got[k], want[k], atol)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("name", TINY_CASES + LM_CASES)
def test_mesh_training_matches_jax(runs, mesh, name):
    got = _rank0(runs, mesh, name)
    j_losses, j_params = runs["jax"][name]
    loss_tol = 5e-4 if name.endswith("int8") else 1e-5
    assert len(got["losses"]) == len(j_losses)
    np.testing.assert_allclose(got["losses"], j_losses, rtol=0,
                               atol=loss_tol)
    if not name.endswith("int8"):
        _close_params(got["params"], j_params, 5e-4)


def test_admm_on_a_mesh_matches_jax(runs):
    """ADMM on a (1, 2) mesh: each projection takes the whole matrix
    (``full_tensor()``), so the masks are JAX's."""
    got = _rank0(runs, (1, 2), "tiny-admm")
    j_losses, j_params = runs["jax"]["tiny-admm"]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=0, atol=1e-4)
    for w in ("wq", "wo"):
        np.testing.assert_array_equal(
            got["params"]["layers"]["mixer"][w] != 0,
            j_params["layers"]["mixer"][w] != 0)
        assert (got["params"]["layers"]["mixer"][w] == 0).mean() >= 0.44


def test_checkpoint_moves_between_meshes_and_into_jax(runs):
    """Saved whole by rank 0 of the (1, 2) run, restored onto the (2, 1)
    mesh through ``shardings`` (FSDP's: each weight split over "data"
    on its largest free dim; the values bit-equal), and by the JAX
    package's ``restore``; a checkpoint the JAX package wrote, restored
    onto the (2, 1) mesh the same way."""
    import jax
    from torch.distributed.tensor import Replicate, Shard

    from repro.models import ModelConfig as JModelConfig
    from repro.optim import get_optimizer as j_opt
    from repro.train import checkpoint as j_ckpt
    ckdir, step = runs["ckpt"]
    saved = _rank0(runs, (1, 2), "tiny-adamw")["params"]
    for r, _ in runs["ranks"]["restored"]:
        # wq (32, 32): "model" (one device) on its output dim, "data" on
        # its input dim; wo's moment: "model" on its input dim, "data" on
        # the other
        assert r["placements"] == ((Shard(0), Replicate()),
                                   (Shard(1), Replicate()))
        assert r["step"] == step
        _close_params(r["params"], saved, 0)
    like_p = jax.tree.map(np.asarray, _jax_inputs("tiny")[1])
    assert JModelConfig(**jobs.TINY).n_layers == 2
    like = {"opt": j_opt("adamw").init(like_p), "params": like_p}
    tree, _ = j_ckpt.restore(ckdir, step, like)
    _close_params(jobs.numpy_tree(jax.tree.map(np.asarray, tree["params"])),
                  saved, 0)
    restored = runs["ranks"]["restored"][0][0]
    _close_params(restored["m"], jobs.numpy_tree(
        jax.tree.map(np.asarray, tree["opt"].inner["m"])), 0)
    assert int(tree["opt"].step) == step
    assert os.path.isdir(os.path.join(ckdir, f"step_{step:08d}"))
    # and the other way: the JAX package's checkpoint onto the (2, 1) mesh
    for _, r in runs["ranks"]["restored"]:
        assert r["placements"] == ((Shard(0), Replicate()),
                                   (Shard(1), Replicate()))
        assert r["step"] == 0
        _close_params(r["params"], runs["jax_ckpt_params"], 0)
        assert all(not np.any(v) for v in jax.tree.leaves(r["m"]))

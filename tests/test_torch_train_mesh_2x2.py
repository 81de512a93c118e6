"""Training on a (2, 2) ("data", "model") mesh of gloo ranks against the
JAX package's unsharded ``train``, and the DTensor traps the port's
model code pins; the (1, 2) and (2, 1) meshes, ADMM and checkpoints are
in tests/test_torch_train_mesh.py (its docstring: the cases' setup).

One spawned job (``spawn_ranks(..., device="cpu")``) trains every case
(tests/_torch_mesh_jobs.py): the tiny ``CFG`` with AdamW, AdamW with int8
compression and AdamW over two microbatches, 5 steps each (each rank splits its own part
of the batch) and Adafactor (its factored statistics placed as
``opt_state_specs`` says), AdamW with the params on FSDP's
placements (``ShardingPolicy(fsdp=True)``), and reduced deepseek-v2-236b and
mamba2-370m. Bounds, tests/test_torch_train.py's: losses 1e-5 (int8:
5e-4); params 5e-4 for AdamW, 1e-5 for Adafactor.

The traps (one more job on the same mesh): ``torch.cumsum`` along a
split dim through ``dist.api.along`` is the whole sum; ``moe_apply`` with one
token group (the batch's split lands on the token dim, where its
dispatch positions are counted) equals its plain run within 1e-5; SSD
over a sequence-split input equals its plain run within 1e-5 (its
"ssd_inner" pins).
"""
import concurrent.futures

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.dist.launch import spawn_ranks

import _torch_mesh_jobs as jobs
from test_torch_train_mesh import BATCH, SEQ, STEPS, _close_params, \
    _jax_inputs, _jax_run

MESH = (2, 2)
# fewer steps than the two-rank file's: four ranks share the host's cores
STEPS_2X2 = dict(STEPS, tiny=5)
# name -> (arch, optimizer, microbatches, compress, loss tol, param tol)
CASES = {
    "tiny-adamw": ("tiny", "adamw", 1, False, 1e-5, 5e-4),
    "tiny-adamw-int8": ("tiny", "adamw", 1, True, 5e-4, None),
    "tiny-adamw-mb2": ("tiny", "adamw", 2, False, 1e-5, 5e-4),
    "tiny-adafactor": ("tiny", "adafactor", 1, False, 1e-5, 1e-5),
    "tiny-adamw-fsdp": ("tiny", "adamw", 1, False, 1e-5, 5e-4),
    "deepseek-v2-236b": ("deepseek-v2-236b", "adamw", 1, False, 1e-5, 5e-4),
    "mamba2-370m": ("mamba2-370m", "adamw", 1, False, 1e-5, 5e-4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    import jax
    cases, inputs = {}, {}
    for name, (arch, opt, mb, comp, _, _) in CASES.items():
        tcfg = dict(lr=3e-3, log_every=1000, steps=STEPS_2X2[arch],
                    optimizer=opt, microbatches=mb, compress_grads=comp)
        cfg, jp, task = _jax_inputs(arch)
        batches = [task.batch(s, BATCH, SEQ) for s in range(tcfg["steps"])]
        cases[name] = dict(arch=arch, tcfg=tcfg, batches=batches,
                           fsdp=name.endswith("fsdp"),
                           params=jobs.numpy_tree(jax.tree.map(np.asarray,
                                                               jp)))
        inputs[name] = (arch, tcfg, {}, batches)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        def both():
            return (spawn_ranks(jobs.train_cases, MESH, cases, device="cpu",
                                timeout_s=300),
                    spawn_ranks(jobs.traps, MESH, device="cpu",
                                timeout_s=120))
        fut = pool.submit(both)
        jax_out = {name: _jax_run(name, *inputs[name]) for name in inputs}
        ranks, traps = fut.result()
    return {"ranks": ranks, "jax": jax_out, "traps": traps}


@pytest.mark.parametrize("name", list(CASES))
def test_2x2_training_matches_jax(runs, name):
    *_, loss_tol, param_tol = CASES[name]
    got = runs["ranks"][0][name]
    for r in runs["ranks"][1:]:
        assert r[name]["losses"] == got["losses"]
    j_losses, j_params = runs["jax"][name]
    assert len(got["losses"]) == len(j_losses)
    np.testing.assert_allclose(got["losses"], j_losses, rtol=0,
                               atol=loss_tol)
    if param_tol is not None:
        _close_params(got["params"], j_params, param_tol)


def test_cumsum_along_a_split_dim_is_pinned(runs):
    """Through ``dist.api.along`` a split dim's cumulative sum is the
    whole one, whatever DTensor's own cumsum strategy does with the split
    (this torch's replicates the dim; each shard's own running sum has
    been seen from DTensor, with no error); the pinned model sites equal
    their plain runs."""
    for t in runs["traps"]:
        np.testing.assert_array_equal(t["cumsum_along"], t["cumsum"])
        assert t["cumsum_split"].shape == t["cumsum"].shape
        assert t["moe_err"] <= 1e-5 and t["ssd_err"] <= 1e-5, t


def test_sync_collectives_equal_dtensor_s_own(runs):
    """``dist.gloo_cuda``'s kernels (what the card's gloo ranks run),
    registered for the CPU: every redistribution over each mesh dim
    equal to DTensor's own collectives; the shard-to-shard exchange
    directly."""
    ys = [np.arange(48, dtype=np.float32).reshape(8, 6) * (1 + r)
          for r in range(4)]
    for r, t in enumerate(runs["traps"]):
        native, synced, direct = t["collectives"]
        assert set(native) == set(synced)
        for k in native:
            np.testing.assert_array_equal(synced[k], native[k], err_msg=k)
        # the "data" group of rank r: ranks {r % 2, r % 2 + 2}
        d, m = t["coord"]
        peers = [ys[m + 2 * i] for i in range(2)]
        np.testing.assert_array_equal(
            direct["alltoall"], np.concatenate(peers, 0)[:, 3 * d:3 * d + 3])


def test_optimizer_state_lands_on_opt_state_specs(runs):
    """SGD's, AdamW's and Adafactor's state, made by ``init`` from placed
    params on the (2, 2) mesh, on ``opt_state_specs``' placements leaf
    for leaf (Adafactor's factored ``r``/``c`` included)."""
    for t in runs["traps"]:
        for name, (n_got, bad, n_want) in t["opt_placements"].items():
            assert n_got == n_want > 0 and bad == [], (name, bad)


def test_sharded_batches_on_a_mesh(runs):
    """Each rank holds its "data" coordinate's rows of every batch, as a
    DTensor split over "data"; unlisted keys replicated."""
    for t in runs["traps"]:
        d = t["coord"][0]
        assert [s for s, *_ in t["batches"]] == [0, 1]
        for step, tokens, tp, lp in t["batches"]:
            want = np.arange(8 * 4).reshape(8, 4) + 100 * step
            np.testing.assert_array_equal(tokens, want[4 * d:4 * d + 4])
            assert tp == (Shard(0), Replicate())
            assert lp == (Replicate(), Replicate())

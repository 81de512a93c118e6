"""LM serving on a mesh of gloo ranks against the JAX package's
unsharded run: (1, 2) and (2, 1) ("data", "model") meshes; the (2, 2)
mesh is in tests/test_torch_serve_mesh_2x2.py.

Each mesh runs once, in a module fixture, as ranks spawned by
``spawn_ranks(..., device="cpu")`` (a deadline each) that serve every
case of tests/_torch_serve_mesh_jobs.py in one job: the JAX package's own
mesh tests (paged with and without the paged-attention kernel's plain
version, contiguous, ``generate`` and its speculative branch, one paged
step at a vector position, speculative serving, the disaggregated tiers,
``Router(2)``, the prefix cache on and off for attention and MLA), on
their configs and traces, from JAX's ``PRNGKey(0)`` params carried across
by ``lm_params_from_numpy``. JAX's unsharded runs (tests/_jax_serve_refs.py)
run in the parent, beside the spawns.

Bounds, the reference tests': greedy tokens identical to JAX's (and on
every rank). The vector-position step's logits and pools against JAX's
scalar-position step within 2e-5, the port's bound for
``decode_step_paged`` against JAX (tests/test_torch_models.py: fp32
summation order; the mesh splits the row-parallel products' sums too).
Where "data" is 2, the "*-split" cases' pools (an odd page count, even
with the scratch page) must be split over "data" on their page dim; where
"model" is 2, the weights must be split over "model"; the prompt pass
tags its cache "kv_cache" / "mla_cache" (time over "model").
"""
import concurrent.futures

import pytest
import torch

from repro_torch.dist.launch import spawn_ranks

import _jax_serve_refs as refs
import _torch_serve_mesh_jobs as jobs

MESHES = ((1, 2), (2, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """{mesh: the ranks' results}, and JAX's per case."""
    params = refs.params_np()
    extra = refs.extras()
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {m: pool.submit(spawn_ranks, jobs.serve_cases, m, m, params,
                               extra, device="cpu", timeout_s=600)
                for m in MESHES}
        jax_out = refs.run_all(MESHES[0], params, extra)
        ranks = {m: f.result() for m, f in futs.items()}
    return {"ranks": ranks, "jax": jax_out}


NAMES = tuple(jobs.cases(MESHES[0]))


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("name", NAMES)
def test_mesh_serving_matches_jax(runs, mesh, name):
    got = refs.check_case(runs, mesh, name)
    if name.startswith("prefix-") and name.endswith("-on"):
        assert got["stats"]["prefix_hits"] > 0
    if name == "router":
        assert got["stats"]["replicas"] == 2
        assert all(got["stats"]["per_replica_sharded"])


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x1"])
def test_mesh_placements(runs, mesh):
    refs.check_placements(runs, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x1"])
def test_pool_part_ops(runs, mesh):
    refs.check_pool_part_ops(runs, mesh)


def test_paged_attn_decode_refuses_a_dtensor(tmp_path):
    """The kernel's wrapper takes plain tensors: a DTensor raises (on the
    card the call is the hand kernel or an error, never a gather)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.ops import paged_attn_decode

    created = not dist.is_initialized()
    if created:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        q = torch.zeros(2, 2, 16)
        pool = torch.zeros(5, 4, 2, 16)
        table = torch.zeros(2, 2, dtype=torch.int32)
        dq = DTensor.from_local(q, mesh, (Replicate(),))
        with pytest.raises(TypeError, match="plain tensors"):
            paged_attn_decode(dq, pool, pool, table, 3, scale=0.25)
        dpool = DTensor.from_local(pool, mesh, (Replicate(),))
        with pytest.raises(TypeError, match="plain tensors"):
            paged_attn_decode(q, dpool, pool, table, 3, scale=0.25)
        assert paged_attn_decode(q, pool, pool, table, 3,
                                 scale=0.25).shape == (2, 2, 16)
    finally:
        if created:
            dist.destroy_process_group()

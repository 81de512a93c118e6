"""LM serving on a (2, 2) ("data", "model") mesh of four gloo ranks
against the JAX package's unsharded run: every case of
tests/test_torch_serve_mesh.py (the same jobs, checks and bounds) plus
tests/test_paged_attn.py's hybrid ``generate`` (12 new tokens), which the
reference runs on its 2x4 mesh. The ranks run in one spawn, in a module
fixture, while JAX's references run in the parent.
"""
import pytest
import torch

from repro_torch.dist.launch import spawn_ranks

import _jax_serve_refs as refs
import _torch_serve_mesh_jobs as jobs

MESH = (2, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures
    params = refs.params_np()
    extra = refs.extras()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn_ranks, jobs.serve_cases, MESH, MESH, params,
                          extra, device="cpu", timeout_s=600)
        jax_out = refs.run_all(MESH, params, extra)
        ranks = fut.result()
    return {"ranks": {MESH: ranks}, "jax": jax_out}


@pytest.mark.parametrize("name", tuple(jobs.cases(MESH)))
def test_mesh_serving_matches_jax(runs, name):
    got = refs.check_case(runs, MESH, name)
    if name.startswith("prefix-") and name.endswith("-on"):
        assert got["stats"]["prefix_hits"] > 0


def test_mesh_placements(runs):
    refs.check_placements(runs, MESH)


def test_pool_part_ops(runs):
    refs.check_pool_part_ops(runs, MESH)

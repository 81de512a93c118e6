"""``repro_torch.launch.op_cost`` (the per-device op counter that stands
for ``repro.launch.hlo_cost.analyze``) and the H100 roofline.

The counts are per device: under DTensor the counter sees each rank's
local ops, not the global-shape DTensor op that
``torch.utils.flop_counter.FlopCounterMode`` counts, nor DTensor's
sharding propagation on fake tensors of the global shapes. Collectives
count their operand's bytes (an all-gather's input); Python loops count
every call. Against the JAX package: the matrix-product FLOPs of reduced
gemma-2b decode and train cells on a 1x1 mesh are within 1% of the
``dot`` FLOPs of JAX's compiled HLO for the same cell, counted with
``hlo_cost``'s parser (loop bodies times their trip counts).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.launch import hlo_cost as JH
from repro_torch import configs as TC
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as TR
from repro_torch.launch.op_cost import OpCounter, count

DOT_RTOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_mesh(dims, axes):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(TD.FAKE_DEVICE, torch.arange(int(np.prod(dims))
                                                  ).reshape(dims),
                      mesh_dim_names=axes)


def test_dtensor_product_counts_the_local_op():
    """The probe: x (128, 2048) split over "data", w (2048, 16384) split
    over "model" on a 16x16 mesh: rank 0 multiplies (8, 2048) by
    (2048, 1024), 2 x 8 x 2048 x 1024 FLOPs, not the global product's
    8,589,934,592."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with TD.fake_group(256):
        mesh = _fake_mesh((16, 16), ("data", "model"))
        with FakeTensorMode():
            x = torch.empty(128, 2048, dtype=torch.bfloat16,
                            device=TD.FAKE_DEVICE)
            w = torch.empty(2048, 16384, dtype=torch.bfloat16,
                            device=TD.FAKE_DEVICE)
            xd = distribute_tensor(x, mesh, [Shard(0), Replicate()],
                                   src_data_rank=None)
            wd = distribute_tensor(w, mesh, [Replicate(), Shard(1)],
                                   src_data_rank=None)
            with OpCounter() as c:
                y = xd @ wd
            assert tuple(y.to_local().shape) == (8, 1024)
    assert c.cost.flops == 33_554_432 == c.cost.dot_flops
    assert c.cost.flops != 2 * 128 * 2048 * 16384
    assert c.cost.coll_count == {}


def test_all_gather_counts_its_input_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with TD.fake_group(16):
        mesh = _fake_mesh((16,), ("model",))
        with FakeTensorMode():
            x = torch.empty(256, 96, dtype=torch.float32,
                            device=TD.FAKE_DEVICE)
            xd = distribute_tensor(x, mesh, [Shard(0)], src_data_rank=None)
            with OpCounter() as c:
                full = xd.redistribute(mesh, [Replicate()])
            assert tuple(full.to_local().shape) == (256, 96)
    assert c.cost.coll_count == {"all-gather": 1}
    assert c.cost.coll_bytes == {"all-gather": 16 * 96 * 4}
    assert c.cost.collective_total == 16 * 96 * 4


def test_python_loop_counts_every_call():
    """tests/test_dist.py's loop case: ten (128, 128) x (128, 256)
    products, each all-reduced, count ten times (no trip counts to
    multiply: the loop is unrolled as it runs)."""
    import torch.distributed._functional_collectives as funcol
    with TD.fake_group(2):
        group = torch.distributed.group.WORLD
        a = torch.randn(128, 128)
        w = torch.randn(128, 256)

        def step(a, w):
            for _ in range(10):
                y = funcol.all_reduce(a @ w, "sum", group)
                y = funcol.wait_tensor(y)
            return y

        _, c = count(step, a, w)
    assert c.cost.dot_flops == 2 * 128 * 128 * 256 * 10
    assert c.cost.coll_bytes == {"all-reduce": 128 * 256 * 4 * 10}
    assert c.cost.coll_count == {"all-reduce": 10}


def test_elementwise_reduction_views_and_memory():
    a = torch.randn(64, 32)
    b = torch.randn(64, 32)

    def step(a, b):
        s = (a + b).t()          # add: 2,048 flops; t(): a view, (32, 64)
        return s.sum(0)          # sum: 1 a input element, out (64,)

    out, c = count(step, a, b)
    n = 64 * 32
    assert c.cost.flops == n + n
    assert c.cost.bytes == 3 * n * 4 + (n + 64) * 4
    mem = c.memory()
    assert mem["argument_bytes"] == 2 * n * 4
    assert mem["output_bytes"] == 64 * 4 and mem["alias_bytes"] == 0
    # the arguments, the sum and the sum's output live at once
    assert mem["peak_bytes_per_device"] == 3 * n * 4 + 64 * 4
    assert mem["temp_bytes"] == n * 4


def test_roofline_dominance_under_h100_constants():
    """tests/test_dist.py's dominance cases under the H100's peaks."""
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 50e9)
    r = TR.roofline(1e15, 1e9, 1e6, 0.9e15)
    assert r.dominant == "compute"
    assert 0.89 <= r.useful_ratio <= 0.91
    r = TR.roofline(1e9, 1e13, 1e6, 1e9)
    assert r.dominant == "memory"
    r = TR.roofline(1e9, 1e9, 1e13, 1e9)
    assert r.dominant == "collective"
    assert r.t_collective == 1e13 / 50e9


class _DotOnly(JH.HloCostModel):
    """``hlo_cost``'s walk (loops times their trip counts, fusions
    entered) counting only ``dot`` FLOPs."""

    def _op_flops(self, op):
        return super()._op_flops(op) if op.opcode == "dot" else 0.0


@pytest.fixture(scope="module")
def jax_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def _reduced_over(arch) -> dict:
    full, red = TC.get_config(arch), TC.get_reduced(arch)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(full)
            if getattr(red, f.name) != getattr(full, f.name)
            and f.name != "name"}


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_product_flops_match_jax_hlo_dots(jax_dryrun, shape):
    """The port's matrix-product FLOPs on a 1x1 mesh within DOT_RTOL of
    the dots of JAX's compiled step. The totals over all ops are printed
    beside them, not held to each other: XLA fuses the elementwise ops
    and rewrites some (a divide by a constant becomes a multiply, a
    softmax's pieces are counted as their HLO ops, converts count none),
    and its while loops run the layers where the port's Python loop
    runs them, with its own bookkeeping ops."""
    from repro.dist import use_rules
    arch = "gemma-2b"
    over = _reduced_over(arch)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    fn, args, in_sh, donate, rules, _ = jax_dryrun.build_cell(
        arch, shape, mesh, extra_over=over)
    with use_rules(rules):
        hlo = jax.jit(fn, in_shardings=in_sh, donate_argnums=donate
                      ).lower(*args).compile().as_text()
    want = _DotOnly(hlo).module_cost().flops
    rec = TD.run_cell(arch, shape, extra_over=over, save=False,
                      mesh_shape=(1, 1))
    assert rec["status"] == "ok", rec.get("traceback")
    got = rec["cost"]["dot_flops_per_device"]
    print(f"{arch} {shape} reduced, 1x1: products {got:.6e} FLOPs, JAX's "
          f"dots {want:.6e}; all ops {rec['cost']['flops_per_device']:.6e}, "
          f"JAX's {JH.analyze(hlo).flops:.6e}")
    assert got == pytest.approx(want, rel=DOT_RTOL)

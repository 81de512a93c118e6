"""The launch tooling of the port (``repro_torch.launch.{inputs, roofline,
dryrun}``, the registry's ``shape_overrides``/``all_cells``, the models'
``abstract_*`` trees) against the JAX package's.

Exact where the JAX side is host code or shapes: the 40 cells, their
overrides, runnability and model FLOPs; every abstract tree's keys,
shapes and dtypes at full width for every arch; ``csb_partition_report``
and ``serve_report`` give JAX's dicts. ``run_cell`` on reduced configs
over the fake 16x16 mesh returns ``status: ok`` with JAX's record keys
but the XLA-only ones: reduced gemma-2b and mamba2-370m decode cells
(their 4 and 8 heads split over 16 ranks) and mamba2-370m's train cell at
full width, one layer (a reduced train cell traces for ~30 s a layer).

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
(its first lines): the ``jax_dryrun`` fixture imports it with the
variable put back at once, so no other test in this worker sees it.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro.launch import inputs as JI
from repro.launch import roofline as JR
from repro.models import lm as JLM
from repro_torch import _tree
from repro_torch import configs as TC
from repro_torch.launch import dryrun as TD
from repro_torch.launch import inputs as TI
from repro_torch.launch import roofline as TR
from repro_torch.models import SHAPES
from repro_torch.models import lm as TLM

ROOT = Path(__file__).resolve().parents[1]

# JAX's record keys (src/repro/launch/dryrun.py run_cell) and those that
# only XLA has: lowering and compile times, XLA:CPU's convert correction,
# XLA's own once-per-loop cost_analysis
JAX_KEYS = {"arch", "shape", "mesh", "kind", "status", "chips", "lower_s",
            "compile_s", "memory", "cost", "collectives", "roofline",
            "csb_partition", "params", "active_params"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_bytes_per_device", "cpu_f32_convert_bytes",
              "peak_bytes_tpu_estimate"}
JAX_COST = {"flops_per_device", "bytes_per_device",
            "xla_flops_unrolled_once", "xla_bytes_unrolled_once"}
XLA_ONLY = {"lower_s", "compile_s", "cpu_f32_convert_bytes",
            "peak_bytes_tpu_estimate", "xla_flops_unrolled_once",
            "xla_bytes_unrolled_once"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_shapes(tree) -> dict:
    """{path: (shape, dtype name)} of a JAX tree of ShapeDtypeStructs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in flat}


def _port_shapes(tree) -> dict:
    """The same of a port tree (a list of layers as JAX's stacked leaf)."""
    def one(parts, stacked):
        t = parts[0]
        assert t.device.type == "meta"
        return jax.ShapeDtypeStruct(
            ((len(parts),) if stacked else ()) + tuple(t.shape),
            jnp.dtype(str(t.dtype).replace("torch.", "")))
    return _jax_shapes(_tree.jax_structure(tree, one))


def test_cells_overrides_runnable_and_model_flops_equal_jax():
    assert TC.all_cells() == JC.all_cells()
    assert len(TC.all_cells()) == 40
    for arch, shape in JC.all_cells():
        assert TC.shape_overrides(arch, shape) == \
            JC.shape_overrides(arch, shape)
        assert TC.cell_is_runnable(arch, shape) == \
            JC.cell_is_runnable(arch, shape)
        jcfg = dataclasses.replace(JC.get_config(arch),
                                   **JC.shape_overrides(arch, shape))
        tcfg = dataclasses.replace(TC.get_config(arch),
                                   **TC.shape_overrides(arch, shape))
        for chips in (256, 512):
            assert TR.model_flops(tcfg, SHAPES[shape], chips) == \
                JR.model_flops(jcfg, SHAPES[shape], chips)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_abstract_trees_match_jax(arch):
    """abstract_params/cache/paged_cache: JAX's keys, shapes and dtypes
    at full width, nothing allocated (meta tensors)."""
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert _port_shapes(TLM.abstract_params(tcfg)) == \
        _jax_shapes(JLM.abstract_params(jcfg))
    for b, t, dt in ((128, 32768, "bfloat16"), (3, 40, "float32")):
        assert _port_shapes(TLM.abstract_cache(tcfg, b, t, dt)) == \
            _jax_shapes(JLM.abstract_cache(jcfg, b, t, jnp.dtype(dt)))
    assert _port_shapes(TLM.abstract_paged_cache(
        tcfg, 37, 16, 5, torch.bfloat16)) == _jax_shapes(
            JLM.abstract_paged_cache(jcfg, 37, 16, 5, jnp.bfloat16))


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_input_specs_match_jax(arch):
    for shape in SHAPES:
        cfg = dataclasses.replace(TC.get_config(arch),
                                  **TC.shape_overrides(arch, shape))
        jcfg = dataclasses.replace(JC.get_config(arch),
                                   **JC.shape_overrides(arch, shape))
        got = TI.input_specs(cfg, SHAPES[shape])
        want = JI.input_specs(jcfg, SHAPES[shape])
        assert sorted(got) == sorted(want)
        assert _port_shapes(got) == _jax_shapes(want)


def _mesh_standins(dims):
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    jax_mesh = types.SimpleNamespace(shape=dict(zip(axes, dims)))
    port_mesh = types.SimpleNamespace(mesh_dim_names=axes, shape=dims)
    return jax_mesh, port_mesh


def _plain(x):
    return json.loads(json.dumps(x, default=lambda v: v.item()))


@pytest.mark.parametrize("dims", [(16, 16), (2, 16, 16)])
def test_csb_partition_report_equals_jax(jax_dryrun, dims):
    jm, tm = _mesh_standins(dims)
    for arch in TC.ARCH_IDS:
        want = jax_dryrun.csb_partition_report(JC.get_config(arch), jm)
        got = TD.csb_partition_report(TC.get_config(arch), tm)
        assert _plain(got) == _plain(want), arch


@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_serve_report_equals_jax(jax_dryrun, shape, chips):
    """The report reads the shape, the roofline and the chips, not the
    config: one arch a shape."""
    terms = dict(flops_per_device=3.1e12, bytes_per_device=5.2e10,
                 collective_bytes=7.0e8, t_compute=1.1e-3,
                 t_memory=1.55e-2, t_collective=1.4e-2, dominant="memory",
                 model_flops_per_device=2.0e12, useful_ratio=0.645)
    arch = "gemma-2b" if shape == "decode_32k" else "mamba2-370m"
    want = jax_dryrun.serve_report(JC.get_config(arch), SHAPES[shape],
                                   JR.Roofline(**terms), chips)
    got = TD.serve_report(TC.get_config(arch), SHAPES[shape],
                          TR.Roofline(**terms), chips)
    assert _plain(got) == _plain(want)


def _reduced_over(arch) -> dict:
    """``extra_over`` that makes the full config the reduced one."""
    full, red = TC.get_config(arch), TC.get_reduced(arch)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(full)
            if getattr(red, f.name) != getattr(full, f.name)
            and f.name != "name"}


@pytest.mark.parametrize("arch,shape,reduced,layers", [
    ("gemma-2b", "decode_32k", True, 2),
    ("mamba2-370m", "decode_32k", True, 2),
    ("mamba2-370m", "train_4k", False, 1)])
def test_run_cell_on_the_fake_production_mesh(arch, shape, reduced, layers):
    over = {**(_reduced_over(arch) if reduced else {}), "n_layers": layers}
    rec = TD.run_cell(arch, shape, extra_over=over, save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "pod16x16" and rec["chips"] == 256
    want = JAX_KEYS - XLA_ONLY | ({"serve"} if shape.startswith("decode")
                                  else set())
    assert set(rec) - {"trace_s", "device"} == want
    assert set(rec["memory"]) == JAX_MEMORY - XLA_ONLY
    assert JAX_COST - XLA_ONLY <= set(rec["cost"])
    coll = {"bytes_by_op", "count_by_op", "total_bytes"}
    if shape.startswith("train"):
        coll.add("grad_compress")
    assert set(rec["collectives"]) == coll
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"] > 0
    cfg = dataclasses.replace(TC.get_config(arch), **over)
    rl = TR.roofline(rec["cost"]["flops_per_device"],
                     rec["cost"]["bytes_per_device"],
                     rec["collectives"]["total_bytes"],
                     TR.model_flops(cfg, SHAPES[shape], 256))
    assert rec["roofline"] == rl.as_dict()
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["params"] == cfg.param_count()


def test_skipped_cell_and_cli_list(capsys):
    rec = TD.run_cell("gemma-2b", "long_500k", save=False)
    assert rec["status"] == "skipped"
    assert TD.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 40
    assert sum(line.startswith("SKIP") for line in lines) == sum(
        not JC.cell_is_runnable(a, s) for a, s in JC.all_cells())


def test_new_modules_load_no_jax_or_repro_and_no_group():
    """The new modules and the example, imported in a fresh process, load
    no JAX and nothing of ``repro``, and start no process group."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    probe = ("import json, runpy, sys, torch.distributed as d; "
             "import repro_torch.launch.dryrun, repro_torch.launch.op_cost, "
             "repro_torch.launch.inputs, repro_torch.launch.roofline, "
             "repro_torch.train.classifier; runpy.run_path(sys.argv[1], "
             "run_name='imports_only'); print(json.dumps([sorted(k for k "
             "in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
             "'repro')), d.is_initialized()]))")
    out = subprocess.run(
        [sys.executable, "-c", probe,
         str(ROOT / "examples" / "prune_progressive_torch.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False]

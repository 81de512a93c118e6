"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` load no
JAX and nothing of ``repro``, and nothing runs on the CPU unasked."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

PROBE = r"""
import importlib, json, pkgutil, runpy, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_imports")
print(json.dumps(sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("jax", "jaxlib", "repro")
    or k.startswith("jax_"))))
"""


def test_no_jax_or_repro_module_is_loaded():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["repro_torch.engine", "repro_torch.data",
                                    "repro_torch.core"])
def test_paper_subpackages_alone_load_no_jax_or_repro(module):
    """Each subpackage of the paper pipeline, imported first and alone
    in a fresh process, loads no JAX and nothing of ``repro``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    probe = (f"import json, sys, {module}; print(json.dumps(sorted(k for k "
             f"in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
             f"'repro'))))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["repro_torch.dist",
                                    "repro_torch.dist.launch",
                                    "repro_torch.dist.symm",
                                    "repro_torch.kernels.csb_sharded"])
def test_sharded_modules_alone_load_no_jax_or_repro(module):
    """The sharded CSB path's modules, imported first and alone in a fresh
    process, load no JAX and nothing of ``repro``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    probe = (f"import json, sys, {module}; print(json.dumps(sorted(k for k "
             f"in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
             f"'repro'))))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["repro_torch.optim",
                                    "repro_torch.train",
                                    "repro_torch.launch",
                                    "repro_torch.launch.train",
                                    "repro_torch.dist.compress",
                                    "repro_torch.data.pipeline"])
def test_training_modules_alone_load_no_jax_repro_or_triton(module):
    """The training path's modules, imported first and alone in a fresh
    process, load no JAX, nothing of ``repro`` and no ``triton``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    probe = (f"import json, sys, {module}; print(json.dumps(sorted(k for k "
             f"in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
             f"'repro', 'triton'))))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["repro_torch.dist.api",
                                    "repro_torch.dist.rules",
                                    "repro_torch.launch.shardspec",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.dist.gloo_cuda",
                                    "repro_torch.configs.registry"])
def test_placement_modules_alone_load_no_jax_repro_or_triton(module):
    """The dense placements' modules, imported first and alone in a fresh
    process, load no JAX, nothing of ``repro`` and no ``triton``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    probe = (f"import json, sys, {module}; print(json.dumps(sorted(k for k "
             f"in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', "
             f"'repro', 'triton'))))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _loaded_modules(mesh):
    """Run in each spawned rank: the JAX and ``repro`` modules loaded
    after the sharded serving path and the mesh launcher are imported."""
    import repro_torch.kernels.csb_sharded  # noqa: F401
    import repro_torch.launch.train  # noqa: F401
    import repro_torch.serve  # noqa: F401
    return sorted(k for k in sys.modules
                  if k.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_spawned_ranks_load_no_jax_or_repro():
    from repro_torch.dist.launch import spawn_ranks
    assert spawn_ranks(_loaded_modules, (1, 2), device="cpu",
                       timeout_s=120) == [[], []]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"),
                                       ROOT / "chip_smoke.py",
                                       ROOT / "examples" /
                                       "quickstart_torch.py",
                                       ROOT / "examples" /
                                       "train_lm_e2e_torch.py",
                                       ROOT / "examples" /
                                       "serve_batched_torch.py",
                                       ROOT / "examples" /
                                       "serve_router_torch.py"]))
def test_sources_import_no_jax_or_repro(path):
    src = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import\s+(?:jax|repro)\b|from\s+(?:jax|repro)"
                     r"(?:\.\S+)?\s+import)", src, re.M)
    assert not bad, bad


def test_no_subdirectory_named_torch():
    assert not [p for p in PKG.rglob("torch") if p.is_dir()]


def _tiny():
    from repro_torch.cells import init_params, make_cell
    cell = make_cell("lstm", 4, 8)
    return cell, init_params(cell, torch.Generator().manual_seed(0),
                             device="cpu")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")


def test_serve_raises_without_cuda_unless_asked(no_cuda):
    from repro_torch.serve import rnn_serve_frames
    cell, params = _tiny()
    frames = torch.zeros(2, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rnn_serve_frames(cell, params, frames)
    assert rnn_serve_frames(cell, params, frames, device="cpu")[0].shape \
        == (2, 1, 8)


def test_mesh_entry_points_raise_without_cuda_unless_asked(no_cuda):
    """A mesh run and a mesh builder ask for the card unless told the
    CPU: without CUDA they raise before any rank starts."""
    from repro_torch.dist.launch import spawn_ranks
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_test_mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "gemma-2b", "--reduced", "--mesh", "1x2",
                     "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn_ranks(_loaded_modules, (1, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_test_mesh()


@pytest.mark.parametrize("name", ["serve_batched_torch", "serve_router_torch"])
def test_serve_examples_raise_without_cuda_unless_asked(no_cuda, name):
    """Without ``--cpu`` the serve examples ask for the card: without CUDA
    they raise before any rank starts, never falling back to the CPU."""
    import importlib
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        ex = importlib.import_module(name)
    finally:
        sys.path.remove(str(ROOT / "examples"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.main([])


def test_matvec_raises_without_cuda_unless_asked(no_cuda):
    from repro_torch.core import padded_csb_from_dense
    from repro_torch.kernels import csb_matvec
    z = np.eye(16, dtype=np.float32)
    p = padded_csb_from_dense(z, 8, 8, device="cpu")
    x = torch.ones(3, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        csb_matvec(p, x)
    torch.testing.assert_close(csb_matvec(p, x, device="cpu"), x)


def test_constructors_raise_without_cuda_unless_asked(no_cuda):
    from repro_torch.cells import init_params, init_state, make_cell
    from repro_torch.convert import cell_params_from_numpy
    from repro_torch.core import padded_csb_from_dense
    cell = make_cell("gru", 4, 8)
    for call in (lambda: init_params(cell),
                 lambda: init_state(cell, (1,)),
                 lambda: cell_params_from_numpy({"b": np.zeros(3)}),
                 lambda: padded_csb_from_dense(np.eye(8), 8, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_matvec_refuses_a_tensor_on_another_device():
    from repro_torch.core import padded_csb_from_dense
    from repro_torch.kernels import csb_matvec
    p = padded_csb_from_dense(np.eye(8, dtype=np.float32), 8, 8,
                              device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        csb_matvec(p, torch.ones(2, 8, device="meta"), device="cpu")


def test_smoke_script_fails_without_cuda(no_cuda):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_script_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

"""Finding a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration, traffic and metrics, and each of
those is a file of its own under this directory."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# module names whose presence in a run means it loaded JAX or the JAX
# package; compared with the part of each module name before the first dot
FORBIDDEN_TOPS = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """``<base>/<kind>/<name>.py`` loaded by its path (a name may hold
    dots), once per process."""
    key = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def per_layer_metrics(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those without a ``workloads`` key."""
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])]


def end_to_end_metrics(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted(k for k in modules if k.split(".")[0] in FORBIDDEN_TOPS)

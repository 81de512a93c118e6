"""A configuration, a traffic mix and a per-layer metric added as new
files are found by their names, with no file of the benchmark edited;
and BENCHMARK.json holds to the form the harness reads."""
import hashlib
import importlib.util
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import spec
from portbench.tests import _tiny

RUN = Path(spec.HERE) / "run.py"


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _run_module():
    s = importlib.util.spec_from_file_location("portbench_run_for_test", RUN)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = _digest(base)
    cfg = _tiny.config("lstmp")
    cfg["name"] = "tiny_new"
    (base / "configs" / "tiny_new.json").write_text(json.dumps(cfg))
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(_tiny.MIX))
    (base / "metrics" / "chunks_seen.py").write_text(
        "def read(run):\n    return float(run['window'].chunks)\n")
    bench = spec.benchmark(spec.ROOT)
    bench["workloads"].append({"name": "tiny_new.mix", "config": "tiny_new",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "a cell added as data"})
    bench["per_layer"].append({"name": "chunks_seen", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving loop", "moves":
                               "frames_per_s",
                               "workloads": ["tiny_new.mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = spec.benchmark(tmp_path)
    cell = spec.workload(bench, "tiny_new.mix")
    cfg = spec.config(cell["config"], base)
    mix = spec.traffic(cell["traffic"], base)
    assert mix == _tiny.MIX and cfg["name"] == "tiny_new"
    driver = spec.module("drivers", cfg["driver"], base)
    r = driver.run(cfg, mix, 8, 0.02, False, torch.device("cpu"),
                   time.perf_counter())
    run = _run_module()
    line = run.result_line(bench, cell["name"], cfg, r, True, "cpu", base)
    assert line["metrics"]["chunks_seen"]["value"] == r["window"].chunks
    assert line["correct"] is True
    line = run.result_line(bench, cell["name"], cfg, r, False, "cpu", base)
    assert set(line["metrics"]) == {"frames_per_s", "chunk_p95_ms",
                                    "setup_s"}
    assert list(line)[-1] == "compared"
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_names_files_that_exist():
    bench = spec.benchmark(spec.ROOT)
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and c["reduced"] == []
        assert set(cfg["limits"]) == {"out_gap", "out_gap_median",
                                      "state_gap"}
        for layer in cfg["layers"]:
            spec.module("reference", layer["cell"])
        spec.module("drivers", cfg["driver"])
    for w in bench["workloads"]:
        spec.traffic(w["traffic"])
        assert w["chips"] == 1
    for m in bench["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"repro_torch.serve": 1, "repro": 1, "repro.core": 1,
            "jaxtyping": 1, "jax.numpy": 1, "flax": 1, "portbench": 1}
    assert spec.forbidden_modules(mods) == ["flax", "jax.numpy", "repro",
                                            "repro.core"]


def _run_cli(cwd: Path):
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sr1.offline",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=240)


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits nonzero and prints no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "src/repro_torch" in out.stderr


def test_run_refuses_without_a_card():
    """Without CUDA a run exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_cli(spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA is not available" in out.stderr

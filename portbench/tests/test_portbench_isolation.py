"""A run loads no JAX and nothing of the JAX package (``repro``), and the
reference imports nothing of the program. Checked in a fresh process.
A run in which any part loaded one, a metric reader read after the
window too, exits nonzero and prints no result."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec

PROBE = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import torch
torch.set_num_threads(1)
from portbench import spec
from portbench.tests import _tiny
cfg = _tiny.config("gru")
bench = spec.benchmark()
r = spec.module("drivers", cfg["driver"]).run(
    cfg, _tiny.MIX, 3, 0.02, False, torch.device("cpu"), time.perf_counter())
import torch.profiler
from portbench import devtrace
for m in bench["per_layer"]:
    spec.module("metrics", m["name"]).read(r)
print(json.dumps(spec.forbidden_modules()))
"""

REF_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import spec
for kind in ("lstmp", "gru"):
    spec.module("reference", kind)
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in ("repro_torch",)
                        + spec.FORBIDDEN_TOPS)))
"""


# the rest of a run after the look for the card, on the CPU, with the
# benchmark's files from a copy that holds one more metric reader
SERVE_PROBE = r"""
import importlib.util, sys
from pathlib import Path
root, tmp, reader = sys.argv[1:4]
sys.path[:0] = [tmp + "/fake", root + "/src", root]
import torch
torch.set_num_threads(1)
from portbench import spec
from portbench.tests import _tiny
s = importlib.util.spec_from_file_location("portbench_run_probe",
                                           root + "/portbench/run.py")
run = importlib.util.module_from_spec(s)
s.loader.exec_module(run)
bench = spec.benchmark()
bench["per_layer"].append({"name": reader, "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "serving loop", "moves": "frames_per_s"})
run.serve(bench, spec.workload(bench, "sr2.offline"), _tiny.config("gru"),
          _tiny.MIX, 2**31 + 5, 0.02, True, torch.device("cpu"),
          Path(tmp) / "portbench")
"""

READERS = {
    "reads_a_count": "def read(run):\n    return 1.0\n",
    # a stand-in for the JAX package, by its top-level name
    "loads_repro": "import repro  # noqa: F401\n\n\n"
                   "def read(run):\n    return 1.0\n",
}


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code, str(spec.ROOT),
                           *args], capture_output=True, text=True, env=env,
                          cwd=spec.ROOT, timeout=240)


def _probe(code: str) -> list:
    out = _run(code)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_or_repro():
    assert _probe(PROBE) == []


def test_the_reference_imports_nothing_of_the_program():
    assert _probe(REF_PROBE) == []


@pytest.mark.parametrize("reader", sorted(READERS))
def test_a_reader_that_loads_repro_stops_the_result(tmp_path, reader):
    """The check for JAX and the JAX package comes after every metric
    reader, just before the result is printed."""
    base = tmp_path / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (base / "metrics" / f"{reader}.py").write_text(READERS[reader])
    (tmp_path / "fake" / "repro").mkdir(parents=True)
    (tmp_path / "fake" / "repro" / "__init__.py").write_text(
        '"""Not the JAX package: a module of its top-level name."""\n')
    out = _run(SERVE_PROBE, str(tmp_path), reader)
    if reader == "loads_repro":
        assert out.returncode != 0 and out.stdout == ""
        assert "['repro']" in out.stderr.strip().splitlines()[-1]
    else:
        assert out.returncode == 0, out.stderr
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["metrics"][reader]["value"] == 1.0
        assert list(line)[-1] == "compared"

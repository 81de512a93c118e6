"""``examples/serve_batched_torch.py --cpu`` end to end, as a user runs it:
eight gloo ranks on a (2, 4) mesh from the example's own seeded params,
every part's assertion on every rank, rank 0's trace written into the
working directory. Its parity with the JAX package is
tests/test_torch_example_serve_batched.py's."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_script_runs_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_batched_torch.py"),
         "--cpu"], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "done", out.stdout[-2000:]
    assert "8 ranks agree" in out.stdout
    assert (tmp_path / "serve_trace.json").is_file()
    assert list(tmp_path.iterdir()) == [tmp_path / "serve_trace.json"]

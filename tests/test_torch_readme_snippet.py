"""README.md's ```python blocks run as the docs lane (tools/check_docs.py)
runs them: its prelude, then every block in order in one namespace, from
the repository's root. The mesh-serving block spawns two gloo ranks of a
function that lives in examples/serve_batched_torch.py (``spawn_ranks``
pickles it by reference) and holds their tokens to the JAX package's
``serve_continuous``; a rank function defined in the snippet itself
cannot be pickled for the ranks. docs/*.md's blocks are the lane's."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import check_docs  # noqa: E402

README = ROOT / "README.md"


def test_readme_blocks_run_in_the_docs_namespace(monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "path", list(sys.path))
    blocks = check_docs.python_blocks(str(README))
    mesh = [start for start, src in blocks if "spawn_ranks" in src]
    assert len(mesh) == 1, [start for start, _ in blocks]
    ns: dict = {}
    exec(compile(check_docs.PRELUDE, "<docs prelude>", "exec"), ns)
    for start, src in blocks:
        exec(compile(src, f"README.md:{start}", "exec"), ns)
    # the mesh block's rank 0 served every request of the prelude's trace
    assert sorted(ns["tokens"]) == [r.rid for r in ns["requests"]]
    assert all(len(ns["tokens"][r.rid]) == r.max_new_tokens
               for r in ns["requests"])
    assert check_docs.check_links(str(README)) == []

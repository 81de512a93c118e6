"""Paper Algorithm 1 on the port: ``repro_torch.train.classifier`` (the
counterpart of ``benchmarks/common.py``'s ``train_rnn_classifier``) and
``examples/prune_progressive_torch.py`` against the JAX package's.

From JAX's initial weights (its PRNG has no torch counterpart, so the
tests hand them over), the trained params end within TOL of JAX's, the
bound of tests/test_torch_admm.py (fp32 states and penalties), and the
accuracies are equal. The example's ``--fast`` rounds (JAX's example
run as a script, its printout read) take JAX's decisions at every rate.
An accuracy within TOL of the lossless bar would let summation order
flip a decision: the test names such a round, and holds it to the same
decision all the same.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks.common import train_rnn_classifier as jax_train
from repro import core as JCORE
from repro.cells import init_params as jax_init, make_cell as jax_cell
from repro_torch.core import CSBSpec
from repro_torch.train.classifier import train_rnn_classifier

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import prune_progressive_torch as example  # noqa: E402

TOL = 1e-6          # tests/test_torch_admm.py's bound


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_start():
    """benchmarks/common.py's initial weights (seed 0), as numpy."""
    cell = jax_cell("gru", 16, 32)
    key = jax.random.PRNGKey(0)
    p = jax_init(cell, key)
    p["emb"] = jax.random.normal(key, (16, 16)) * 0.3
    p["out"] = jax.random.normal(key, (32, 4)) * 0.3
    return {k: np.array(v) for k, v in p.items()}


def _port(start):
    return {k: torch.from_numpy(v.copy()) for k, v in start.items()}


@pytest.mark.parametrize("rate,steps", [(None, 40), (0.5, 30)])
def test_train_rnn_classifier_matches_jax(jax_start, rate, steps):
    jspecs = tspecs = None
    if rate is not None:
        jspecs = {k: (JCORE.CSBSpec(8, 8, rate) if v.ndim == 2
                      and k not in ("emb", "out") else None)
                  for k, v in jax_start.items()}
        tspecs = {k: (CSBSpec(8, 8, rate) if s is not None else None)
                  for k, s in jspecs.items()}
    _, jp, jacc = jax_train("gru", steps=steps, seed=0, specs=jspecs)
    _, tp, tacc = train_rnn_classifier(
        "gru", steps=steps, seed=0, specs=tspecs,
        generator=torch.Generator(), device="cpu", params=_port(jax_start))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.array(jp[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
        if rate is not None and jspecs[k] is not None:
            assert np.array_equal(tp[k].numpy() == 0, np.array(jp[k]) == 0)
    assert tacc() == jacc()


def test_seeded_start_on_the_cpu():
    gen = torch.Generator().manual_seed(3)
    _, p, acc = train_rnn_classifier("gru", steps=2, generator=gen,
                                     device="cpu")
    assert p["emb"].shape == (16, 16) and p["out"].shape == (32, 4)
    assert 0.0 <= acc() <= 1.0


_ROUND = re.compile(r"rate ([\d.]+) \([\d.]+x\): acc ([\d.]+) "
                    r"(LOSSLESS|over-pruned)")


def test_example_fast_takes_jax_decisions(jax_start, capsys):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "prune_progressive.py"),
         "--fast"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=600)
    assert out.returncode == 0, out.stderr
    want = [(float(r), float(a), ok == "LOSSLESS")
            for r, a, ok in _ROUND.findall(out.stdout)]
    base = float(re.search(r"dense accuracy: ([\d.]+)", out.stdout)[1])
    best = float(re.search(r"best lossless rate: ([\d.]+)", out.stdout)[1])
    got = example.main(["--fast", "--cpu"], start=_port(jax_start))
    capsys.readouterr()
    assert round(got["baseline"], 3) == base
    assert len(got["history"]) == len(want) > 0
    for (rate, acc, ok), (wrate, wacc, wok) in zip(got["history"], want):
        if abs(acc - got["lossless"]) <= TOL:
            print(f"rate {rate}: accuracy {acc} within {TOL} of the "
                  f"lossless bar {got['lossless']}")
        assert round(rate, 3) == wrate
        assert round(acc, 3) == wacc
        assert ok == wok
    assert round(got["controller"].best_lossless_rate, 3) == best

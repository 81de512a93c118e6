"""End-to-end behaviour of the port's CSB-RNN stack — the port of
tests/test_system.py, through the trainer and the flow that
``chip_smoke.py``'s ``[phase paper]`` runs on the card (here on the CPU):

train the GRU classifier on the synthetic task -> ADMM-CSB prune it ->
encode to the CSB format -> serve it through the CSB-MVM (its plain
version on the CPU) -> outputs match the masked-dense model; the engine's
2-D sharing is no worse than none on the same pruned weights.

One ADMM cycle from the JAX package's own parameters (converted) agrees
with JAX's within 1e-5 (losses, parameters, Z with equal masks); the
whole flow is held to test_system.py's own thresholds. Also: the
synthetic tasks give JAX's batches, and examples/quickstart_torch.py
runs on the CPU."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as JD
from repro.cells import init_params as j_init_params
from repro.cells import make_cell as j_make_cell
from repro.cells import rnn_scan as j_rnn_scan
from repro.core import (
    CSBSpec as JSpec, admm_finalize, admm_init, admm_penalty, admm_update,
    residual_norm,
)
from repro_torch import data as TD
from repro_torch.cells import make_cell

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PRUNED = ("U_z", "U_r", "U_n")
TOL = 1e-5


def _jax_params(seed=0):
    """tests/test_system.py's start: emb and out from the cell's key."""
    cell = j_make_cell("gru", 16, 32)
    key = jax.random.PRNGKey(seed)
    params = j_init_params(cell, key)
    params["emb"] = jax.random.normal(key, (16, 16)) * 0.3
    params["out"] = jax.random.normal(key, (32, 4)) * 0.3
    return cell, params


def _port_tree(params):
    """The JAX package's flat GRU dict -> the trainer's tree."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return {"emb": t.pop("emb"), "rnn": [t], "out": t.pop("out")}


def _flat(tree):
    return {"emb": tree["emb"], "out": tree["out"], **tree["rnn"][0]}


def _jax_cycle(cell, params, task, steps, specs):
    """test_system.py's loss and SGD (lr 0.05, batch 32, rho 0.02), with
    the loss of each step, then one ``admm_update``."""

    def loss_fn(p, toks, labels, st):
        xs = p["emb"][toks].transpose(1, 0, 2)
        ys, _ = j_rnn_scan(cell, {k: v for k, v in p.items()
                                  if k not in ("emb", "out")}, xs)
        ll = jax.nn.log_softmax(ys[-1] @ p["out"])
        loss = -jnp.mean(jnp.take_along_axis(ll, labels[:, None], 1))
        return loss + admm_penalty(p, st, specs)

    state = admm_init(params, specs, rho=0.02)
    losses = []
    for step in range(steps):
        b = task.batch(step, 32)
        loss, g = jax.value_and_grad(loss_fn)(
            params, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]), state)
        losses.append(float(loss))
        params = jax.tree.map(lambda w, gg: w - 0.05 * gg, params, g)
    state = admm_update(params, state, specs)
    return params, state, losses


def test_one_admm_cycle_matches_jax():
    """10 SGD steps with the ADMM penalty, then ``admm_update``: the
    port's trainer from JAX's parameters stays within 1e-5 of JAX."""
    cell, params = _jax_params()
    specs = jax.tree.map(lambda _: None, params)
    for name in PRUNED:
        specs[name] = JSpec(8, 8, 0.5)
    task = JD.SeqClassifyTask(vocab=16, n_classes=4, seq_len=12, seed=0)
    jp, jst, jlosses = _jax_cycle(cell, params, task, 10, specs)

    tparams = _port_tree(params)
    tcells = [make_cell("gru", 16, 32)]
    out = cs.train_classifier(tcells, tparams, TD.SeqClassifyTask(
        vocab=16, n_classes=4, seq_len=12, seed=0), 10,
        specs=cs.gru_specs(tparams))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=TOL, atol=TOL)
    trained = _flat(out["trained"])
    assert set(trained) == set(jp)
    for k, v in jp.items():
        np.testing.assert_allclose(trained[k].numpy(), np.asarray(v),
                                   rtol=TOL, atol=TOL, err_msg=k)
    z = out["state"].z["rnn"][0]
    for name in PRUNED:
        want = np.asarray(jst.z[name])
        np.testing.assert_array_equal(z[name].numpy() != 0, want != 0)
        np.testing.assert_allclose(z[name].numpy(), want, rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(out["residuals"],
                               [float(residual_norm(jp, jst, specs))],
                               rtol=TOL)
    fin, jfin = _flat(out["params"]), admm_finalize(jp, specs)
    for name in PRUNED:
        np.testing.assert_array_equal(fin[name].numpy() != 0,
                                      np.asarray(jfin[name]) != 0)


def test_end_to_end_csb_pipeline():
    """The whole flow from JAX's starting parameters, on the CPU, held to
    test_system.py's thresholds: dense accuracy > 0.5 after 150 steps;
    after 100 ADMM steps accuracy > max(dense - 0.2, 0.4) and
    density(U_z) <= 0.56; served through CSB within 3e-5 of the
    masked-dense cell; 2-D sharing no worse than none on U_n."""
    _, params = _jax_params()
    r = cs.gru_flow(torch.device("cpu"), _port_tree(params))
    assert r["dense_acc"] > 0.5, r
    assert r["pruned_acc"] > max(r["dense_acc"] - 0.2, 0.4), r
    assert r["density_U_z"] <= 0.56, r
    assert r["serve_err"] <= 3e-5, r
    assert r["eff_2d"] >= r["eff_none"], r


def test_admm_hooks_on_the_trainer_tree():
    """``gru_specs`` prunes the three U matrices and nothing else; the
    ADMM state mirrors the trainer's tree with None elsewhere."""
    tree = cs.gru_params(torch.device("cpu"))
    specs = cs.gru_specs(tree)
    assert specs["emb"] is None and specs["out"] is None
    assert {k for k, v in specs["rnn"][0].items() if v is not None} \
        == set(PRUNED)
    st = cs.admm_init(tree, specs)
    assert st.z["rnn"][0]["W_z"] is None and st.z["emb"] is None
    assert st.z["rnn"][0]["U_z"].shape == (32, 32)


TASKS = {
    "char-lm": ("CharLMTask", dict(vocab=16, seed=3), (4, 9)),
    "copy": ("CopyTask", dict(vocab=6, copy_len=4, delay=5, seed=1), (5,)),
    "adding": ("AddingTask", dict(seq_len=20, seed=2), (6,)),
    "classify": ("SeqClassifyTask", dict(vocab=16, n_classes=4,
                                         seq_len=12, seed=0), (32,)),
    "classify SR1": ("SeqClassifyTask", dict(vocab=153, n_classes=4,
                                             seq_len=12, seed=0), (32,)),
}


@pytest.mark.parametrize("case", TASKS)
def test_synthetic_batches_equal_jax(case):
    name, kw, args = TASKS[case]
    jt, tt = getattr(JD, name)(**kw), getattr(TD, name)(**kw)
    for step in (0, 1, 100):
        want, got = jt.batch(step, *args), tt.batch(step, *args)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


def test_lm_batch_iterator_equals_jax():
    jt, tt = JD.CharLMTask(vocab=12, seed=5), TD.CharLMTask(vocab=12, seed=5)
    ji = JD.lm_batch_iterator(jt, 3, 7, start_step=4)
    ti = TD.lm_batch_iterator(tt, 3, 7, start_step=4)
    for _ in range(3):
        (js, jb), (ts, tb) = next(ji), next(ti)
        assert js == ts
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


def test_quickstart_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=240)
    assert out.returncode == 0, out.stderr
    assert "overall compression" in out.stdout
    assert out.stdout.count("kernel vs plain max err") == 2

"""ADMM at SR1's full width (two LSTMP layers, 153 -> 1024 -> 512 and
512 -> 1024 -> 512, between a 153 x 153 embedding and a 512 x 4 readout)
in the JAX package and in the port, from one start, on the same batches
of ``SeqClassifyTask(153, 4, 12)``: the residual ``||W - Z||`` after each
``admm_update`` agrees between the two, so how it moves at a given rho is
the reference algorithm's behaviour, not the port's.

The port's side is ``chip_smoke.py``'s trainer, which ``[phase paper]``
runs on the card; the JAX side is tests/test_system.py's loss and SGD,
jitted. The test runs a short recipe; the recipe of ``[phase paper]``
(100 dense steps, then 100 ADMM steps) is run on demand, and prints both
trajectories at rho 0.02 and at rho 2.0:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_admm_sr1.py
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import data as JD
from repro.cells import make_cell as j_make_cell
from repro.cells import rnn_scan as j_rnn_scan
from repro.configs.paper_models import PAPER_MODELS
from repro.core import (
    CSBSpec as JSpec, admm_init, admm_penalty, admm_update,
    csb_specs_for_params, residual_norm,
)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

# the residuals of the two packages, relative (tests/test_torch_system.py's
# bound for one ADMM cycle): fp32 products summed in another order
RTOL = 1e-5


def _to_jax(tree):
    return {"emb": jnp.asarray(tree["emb"].numpy()),
            "rnn": [{k: jnp.asarray(v.numpy()) for k, v in p.items()}
                    for p in tree["rnn"]],
            "out": jnp.asarray(tree["out"].numpy())}


def _jax_admm(params, task, steps, start, rho):
    """tests/test_system.py's loss and SGD (lr 0.05, batch 32) over SR1's
    two layers, ADMM on the matrices ``csb_specs_for_params`` selects,
    ``admm_update`` every 10 steps; the residual after each update."""
    cells = [j_make_cell(c.cell, c.n_input, c.n_hidden, c.proj)
             for c in PAPER_MODELS["SR1"].layers]
    spec = JSpec(cs.SR1_SPEC.bm, cs.SR1_SPEC.bn, cs.SR1_SPEC.prune_rate)
    specs = csb_specs_for_params(params, spec, exclude=("emb", "out"))

    def loss_fn(p, toks, labels, st):
        xs = p["emb"][toks].transpose(1, 0, 2)
        for cell, cp in zip(cells, p["rnn"]):
            xs, _ = j_rnn_scan(cell, cp, xs)
        ll = jax.nn.log_softmax(xs[-1] @ p["out"])
        loss = -jnp.mean(jnp.take_along_axis(ll, labels[:, None], 1))
        return loss + admm_penalty(p, st, specs)

    @jax.jit
    def step(p, toks, labels, st):
        g = jax.grad(loss_fn)(p, toks, labels, st)
        return jax.tree.map(lambda w, gg: w - cs.PAPER_LR * gg, p, g)

    state = admm_init(params, specs, rho=rho)
    residuals = []
    for i in range(steps):
        b = task.batch(start + i, cs.PAPER_BATCH)
        params = step(params, jnp.asarray(b["tokens"]),
                      jnp.asarray(b["labels"]), state)
        if (i + 1) % cs.ADMM_EVERY == 0:
            state = admm_update(params, state, specs)
            residuals.append(float(residual_norm(params, state, specs)))
    return residuals


def trajectories(dense_steps, admm_steps, rhos):
    """The port trains SR1's classifier dense (from ``sr1_classifier``'s
    seeded start), then the port and JAX each run ``admm_steps`` ADMM
    steps from that point at each rho. Returns {rho: (port, jax)}."""
    dev = torch.device("cpu")
    cells, params = cs.sr1_classifier(dev)
    task = cs.SeqClassifyTask(**cs.SR1_TASK)
    jtask = JD.SeqClassifyTask(**cs.SR1_TASK)
    start = cs.train_classifier(cells, params, task,
                                dense_steps)["params"]
    specs = cs.csb_specs_for_params(start, cs.SR1_SPEC,
                                    exclude=("emb", "out"))
    out = {}
    for rho in rhos:
        port = cs.train_classifier(cells, start, task, admm_steps,
                                   specs=specs, start=dense_steps,
                                   rho=rho)["residuals"]
        out[rho] = (port, _jax_admm(_to_jax(start), jtask, admm_steps,
                                    dense_steps, rho))
    return out


def test_sr1_admm_residuals_match_jax():
    """From SR1's seeded start, 20 ADMM steps (two updates) at
    test_system.py's rho 0.02: the port's residuals are JAX's within
    RTOL, and in both the residual grows."""
    (port, want), = trajectories(0, 20, (cs.ADMM_RHO,)).values()
    assert len(port) == len(want) == 2
    np.testing.assert_allclose(port, want, rtol=RTOL)
    assert want[1] > want[0] and port[1] > port[0], (port, want)


if __name__ == "__main__":
    rhos = (cs.ADMM_RHO, cs.SR1_RHO)
    res = trajectories(cs.SR1_DENSE_STEPS, cs.SR1_ADMM_STEPS, rhos)
    for rho, (port, want) in res.items():
        print(f"rho {rho}: residual after each update")
        print("  port: " + " ".join(f"{v:.4f}" for v in port))
        print("  JAX:  " + " ".join(f"{v:.4f}" for v in want))
        rel = max(abs(a - b) / abs(b) for a, b in zip(port, want))
        print(f"  largest relative difference {rel:.3e} (RTOL {RTOL})")
        if rel > RTOL:
            sys.exit(1)

"""The small task-trained RNN classifier the paper's pruning flows use:
the port of ``benchmarks/common.py``'s ``train_rnn_classifier``, and the
loop beneath it.

A classifier is an embedding table ``emb`` (vocab x emb), RNN cells run
one after the other (``cells.rnn_scan``) and a readout ``out`` of the
last step (hidden x classes). :func:`train_classifier` trains one with
plain SGD on a ``data.SeqClassifyTask`` (batch ``start + step`` at each
step); with CSB ``specs`` the ADMM penalty joins the loss,
``admm_update`` runs every ``every`` steps and ``admm_finalize`` ends the
run (``core.admm``). :func:`train_rnn_classifier` is the benchmark
harness's recipe on one cell, its params in the JAX package's flat tree
(the cell's weights beside ``emb`` and ``out``).
"""
from __future__ import annotations

import time

import torch

from repro_torch.cells import init_params, make_cell, rnn_scan
from repro_torch.core import (
    admm_finalize, admm_init, admm_penalty, admm_update, residual_norm,
)
from repro_torch.data import SeqClassifyTask

LR = 0.05
BATCH = 32
RHO = 0.02
EVERY = 10
N_CLASSES = 4


def _map(t, fn):
    if isinstance(t, dict):
        return {k: _map(v, fn) for k, v in t.items()}
    if isinstance(t, list):
        return [_map(v, fn) for v in t]
    return fn(t)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def classifier_logits(cells, p, toks) -> torch.Tensor:
    """Embedding, the cells one after the other, a readout of the last
    step. ``p``: {"emb", "rnn": [one params dict per cell], "out"}."""
    xs = p["emb"][toks].transpose(0, 1)            # (T, B, emb)
    for cell, cp in zip(cells, p["rnn"]):
        xs, _ = rnn_scan(cell, cp, xs)
    return xs[-1] @ p["out"]


def classifier_loss(cells, p, toks, labels) -> torch.Tensor:
    ll = torch.log_softmax(classifier_logits(cells, p, toks), -1)
    return -torch.mean(torch.gather(ll, 1, labels[:, None]))


def task_batch(task, step, batch, dev):
    """Batch ``step`` of ``task`` as (tokens, labels) on ``dev``."""
    b = task.batch(step, batch)
    return (torch.from_numpy(b["tokens"]).long().to(dev),
            torch.from_numpy(b["labels"]).long().to(dev))


def train_classifier(cells, params, task, steps, *, specs=None, start=0,
                     lr=LR, batch=BATCH, rho=RHO, every=EVERY) -> dict:
    """SGD on batch ``start + step`` of ``task``; with ``specs`` the ADMM
    penalty joins the loss, ``admm_update`` runs every ``every`` steps
    and ``admm_finalize`` ends the run. Returns the params (as
    ``trained`` those before the finalize), the ADMM state, each step's
    loss, the residual after each update and the wall ms per step (the
    card synchronised once, at the end)."""
    dev = params["out"].device
    state = admm_init(params, specs, rho=rho) if specs else None
    losses, residuals = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for step in range(steps):
        toks, labels = task_batch(task, start + step, batch, dev)
        params = _map(params, lambda t: t.detach().requires_grad_())
        loss = classifier_loss(cells, params, toks, labels)
        if state is not None:
            loss = loss + admm_penalty(params, state, specs)
        grads = iter(torch.autograd.grad(loss, list(_leaves(params))))
        params = _map(params, lambda t: (t - lr * next(grads)).detach())
        losses.append(loss.detach())
        if state is not None and (step + 1) % every == 0:
            state = admm_update(params, state, specs)
            residuals.append(residual_norm(params, state, specs))
    _sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    trained = params
    if specs:
        params = admm_finalize(params, specs)
    return {"params": params, "trained": trained, "state": state,
            "losses": [float(v) for v in losses],
            "residuals": [float(v) for v in residuals], "step_ms": step_ms}


def classifier_accuracy(cells, params, task, start=100, n=4,
                        batch=64) -> float:
    """The share of ``n`` batches of ``batch`` from ``start`` whose class
    the classifier gets right."""
    dev = params["out"].device
    correct = 0
    with torch.no_grad():
        for step in range(start, start + n):
            toks, labels = task_batch(task, step, batch, dev)
            pred = torch.argmax(classifier_logits(cells, params, toks), -1)
            correct += int((pred == labels).sum())
    return correct / (n * batch)


def nested_params(flat: dict) -> dict:
    """The flat one-cell tree as :func:`train_classifier`'s tree."""
    return {"emb": flat["emb"], "out": flat["out"],
            "rnn": [{k: v for k, v in flat.items()
                     if k not in ("emb", "out")}]}


def flat_params(nested: dict) -> dict:
    """The reverse of :func:`nested_params`."""
    return {**nested["rnn"][0], "emb": nested["emb"], "out": nested["out"]}


def train_rnn_classifier(cell_kind="gru", hidden=32, vocab=16, steps=60,
                         specs=None, seed=0, admm_every=EVERY, rho=RHO, *,
                         generator: torch.Generator, device,
                         params: dict | None = None):
    """Small task-trained RNN used across the pruning flows.

    One ``cell_kind`` cell of ``hidden`` units over a vocab x vocab
    embedding, read out to the task's 4 classes, trained ``steps`` SGD
    steps at lr 0.05 on batches of 32 of ``SeqClassifyTask(vocab, 4,
    seq_len=12, seed)``; with ``specs`` (the params' flat tree of
    ``CSBSpec`` or None) ADMM runs every ``admm_every`` steps at ``rho``
    and ``admm_finalize`` ends the run. ``params`` (the flat tree: the
    cell's weights, ``emb``, ``out``) gives the start, as the tests give
    the JAX package's; otherwise they are drawn from ``generator`` (the
    JAX package draws from its own PRNG) and put on ``device``.

    Returns (cell, params, accuracy): params in the flat tree, and
    ``accuracy(p=params)`` the share of 4 batches of 64 from batch 200
    classified right."""
    task = SeqClassifyTask(vocab=vocab, n_classes=N_CLASSES, seq_len=12,
                           seed=seed)
    cell = make_cell(cell_kind, vocab, hidden)
    if params is None:
        params = dict(init_params(cell, generator, device="cpu"))
        params["emb"] = torch.randn(vocab, vocab, generator=generator) * 0.3
        params["out"] = torch.randn(hidden, N_CLASSES,
                                    generator=generator) * 0.3
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    res = train_classifier(
        [cell], nested_params(params), task, steps,
        specs=nested_params(specs) if specs else None, lr=LR, batch=BATCH,
        rho=rho, every=admm_every)
    trained = flat_params(res["params"])

    def accuracy(p=trained):
        return classifier_accuracy([cell], nested_params(p), task, start=200)

    return cell, trained, accuracy

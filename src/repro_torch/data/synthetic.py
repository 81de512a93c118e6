"""Synthetic task generators (numpy, deterministic per (seed, step)) — a
copy of ``repro.data.synthetic``, which has no JAX code: a ``(seed,
step)`` gives the same batch in both packages.

``CharLMTask``    — order-2 Markov chain text: a learnable LM task whose
                    optimal perplexity is known to be far below uniform,
                    so "loss goes down" is a meaningful signal.
``CopyTask``      — emit the input sequence after a delay (classic RNN
                    memory benchmark; used for lossless-pruning evals).
``AddingTask``    — sum two marked positions (regression; stock-price
                    stand-in for the paper's SPP benchmark).
``SeqClassifyTask`` — class = argmax of class-conditioned pattern score
                    (sentiment/QA stand-in).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CharLMTask:
    vocab: int = 64
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse-ish row-stochastic transition table over (prev2, prev1)
        raw = rng.gamma(0.3, size=(self.vocab, self.vocab, self.vocab))
        self.trans = raw / raw.sum(-1, keepdims=True)

    def batch(self, step: int, batch: int, seq: int):
        rng = np.random.default_rng((self.seed, step))
        toks = np.zeros((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        toks[:, 1] = rng.integers(0, self.vocab, batch)
        u = rng.random((batch, seq + 1))
        for t in range(2, seq + 1):
            p = self.trans[toks[:, t - 2], toks[:, t - 1]]
            cdf = np.cumsum(p, -1)
            toks[:, t] = (u[:, t, None] > cdf).sum(-1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class CopyTask:
    vocab: int = 8          # symbols 1..vocab-1; 0 = blank
    copy_len: int = 8
    delay: int = 16
    seed: int = 0

    @property
    def seq_len(self) -> int:
        return self.copy_len + self.delay + self.copy_len

    def batch(self, step: int, batch: int):
        rng = np.random.default_rng((self.seed, step))
        pat = rng.integers(1, self.vocab, (batch, self.copy_len))
        seq = np.zeros((batch, self.seq_len), np.int32)
        seq[:, : self.copy_len] = pat
        labels = np.full((batch, self.seq_len), -1, np.int32)
        labels[:, -self.copy_len:] = pat
        return {"tokens": seq, "labels": labels}


@dataclasses.dataclass
class AddingTask:
    seq_len: int = 64
    seed: int = 0

    def batch(self, step: int, batch: int):
        rng = np.random.default_rng((self.seed, step))
        vals = rng.random((batch, self.seq_len)).astype(np.float32)
        marks = np.zeros((batch, self.seq_len), np.float32)
        idx = np.stack([rng.choice(self.seq_len, 2, replace=False)
                        for _ in range(batch)])
        rows = np.arange(batch)
        marks[rows, idx[:, 0]] = 1.0
        marks[rows, idx[:, 1]] = 1.0
        target = vals[rows, idx[:, 0]] + vals[rows, idx[:, 1]]
        x = np.stack([vals, marks], -1)           # (B, S, 2)
        return {"inputs": x, "targets": target.astype(np.float32)}


@dataclasses.dataclass
class SeqClassifyTask:
    vocab: int = 32
    n_classes: int = 4
    seq_len: int = 48
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.class_logits = rng.normal(size=(self.n_classes, self.vocab))

    def batch(self, step: int, batch: int):
        rng = np.random.default_rng((self.seed, step))
        cls = rng.integers(0, self.n_classes, batch)
        p = np.exp(self.class_logits[cls] * 0.8)
        p = p / p.sum(-1, keepdims=True)
        toks = np.stack([rng.choice(self.vocab, self.seq_len, p=pi)
                         for pi in p]).astype(np.int32)
        return {"tokens": toks, "labels": cls.astype(np.int32)}


def lm_batch_iterator(task: CharLMTask, batch: int, seq: int,
                      start_step: int = 0):
    step = start_step
    while True:
        yield step, task.batch(step, batch, seq)
        step += 1

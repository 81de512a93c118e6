"""The one generator of stream traffic: slots of audio streams stepped
together in chunks of frames, with utterances drawn from the seed.

A mix (``traffic/<name>.json``) gives:

* ``loop``: ``"closed"`` (the next chunk is issued when the last returns)
  or ``"open"`` (each group of streams has a chunk due every
  ``chunk_frames * frame_ms``; the groups are staggered evenly over that
  period, and a chunk's latency runs from its due time);
* ``slots``: the stream slots, split evenly over ``groups`` (open loop;
  the closed loop has one group);
* ``chunk_frames``, ``frame_ms``;
* ``utterance_frames``: ``{"median", "sigma", "min", "max", "pool"}``,
  a log-normal length clipped to [min, max]. Every seed gets the same
  pool of lengths (its ``pool`` quantiles) in its own order, so a seed
  changes which utterance comes when, not how much work there is;
* ``bank_frames``: the frames of the feature bank utterances are cut from;
* ``check_streams``: the slots whose outputs the run compares.

A slot whose utterance ends inside a chunk gets zero frames for the rest
of it (those outputs are dropped); at the next chunk boundary its state
is zeroed and a new utterance starts there. Each slot's first utterance
starts at a seeded frame inside it, as in a stream already running.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def length_pool(u: dict) -> np.ndarray:
    """The ``pool`` quantiles of the clipped log-normal lengths."""
    n = int(u["pool"])
    nd = NormalDist(math.log(u["median"]), u["sigma"])
    q = [math.exp(nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(q), u["min"], u["max"]).astype(np.int64)


class Utterances:
    """Lengths and feature-bank offsets of successive utterances: the
    pool, permuted anew from the seed each time it is used up."""

    def __init__(self, mix: dict, rng: np.random.Generator):
        self.pool = length_pool(mix["utterance_frames"])
        self.bank = int(mix["bank_frames"])
        self.rng = rng
        self.queue = np.empty(0, np.int64)

    def take(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        while self.queue.size < n:
            self.queue = np.concatenate(
                [self.queue, self.rng.permutation(self.pool)])
        lens, self.queue = self.queue[:n], self.queue[n:]
        return lens, self.rng.integers(0, self.bank, n)


@dataclasses.dataclass
class Chunk:
    """One chunk of a group: per slot the bank index of its first frame
    (``start``), its true frames (``valid``, the rest are zeros) and
    whether its state is zeroed before the chunk (``reset``)."""

    group: int
    due_s: float | None
    start: np.ndarray
    valid: np.ndarray
    reset: np.ndarray


class Streams:
    """One group's slots and where each stands in its utterance."""

    def __init__(self, n: int, k: int, utts: Utterances,
                 rng: np.random.Generator):
        self.k = k
        self.utts = utts
        self.lens, self.off = utts.take(n)
        self.pos = rng.integers(0, self.lens)
        self.fresh = True

    def next(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        ended = self.pos >= self.lens
        if ended.any():
            idx = np.nonzero(ended)[0]
            self.lens[idx], self.off[idx] = self.utts.take(idx.size)
            self.pos[idx] = 0
        reset = np.ones_like(ended) if self.fresh else ended
        self.fresh = False
        start = self.off + self.pos
        valid = np.minimum(self.lens - self.pos, self.k)
        self.pos = self.pos + self.k
        return start, valid, reset


class Traffic:
    """The chunks of a mix in issue order, from ``seed``."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.k = int(mix["chunk_frames"])
        self.open = mix["loop"] == "open"
        if mix["loop"] not in ("open", "closed"):
            raise ValueError(f"loop must be open or closed, not {mix['loop']}")
        self.groups = int(mix.get("groups", 1)) if self.open else 1
        slots = int(mix["slots"])
        if slots % self.groups:
            raise ValueError(f"{slots} slots do not split into "
                             f"{self.groups} groups")
        self.per_group = slots // self.groups
        self.period_s = self.k * mix["frame_ms"] / 1e3
        utts = Utterances(mix, rng_for(seed, 0))
        rng = rng_for(seed, 1)
        self.streams = [Streams(self.per_group, self.k, utts, rng)
                        for _ in range(self.groups)]
        self.issued = 0
        # the slots compared, drawn from the seed over all groups
        n_check = min(int(mix["check_streams"]), slots)
        self.check = np.sort(rng_for(seed, 2).choice(slots, n_check,
                                                     replace=False))

    def due_s(self, i: int) -> float | None:
        """When the ``i``-th chunk is due after the window opens (open
        loop), or None (closed loop)."""
        if not self.open:
            return None
        n, g = divmod(i, self.groups)
        return (n + g / self.groups) * self.period_s

    def next(self) -> Chunk:
        i = self.issued
        self.issued += 1
        g = i % self.groups
        start, valid, reset = self.streams[g].next()
        return Chunk(g, self.due_s(i), start, valid, reset)

    def check_in_group(self, g: int) -> np.ndarray:
        """The compared slots of group ``g``, as indices within it."""
        lo = g * self.per_group
        hi = lo + self.per_group
        sel = self.check[(self.check >= lo) & (self.check < hi)]
        return sel - lo

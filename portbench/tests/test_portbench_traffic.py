"""The traffic generator: the same seed gives the same chunks, every seed
the same work in another order, refills at chunk boundaries, and the
open loop's staggered schedule."""
import time

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.drivers import rnn_frames as d
from portbench.tests import _tiny
from portbench.generator import Traffic, Utterances, length_pool, rng_for


def _chunks(mix, seed, n):
    t = Traffic(mix, seed)
    return t, [t.next() for _ in range(n)]


def test_same_seed_same_chunks():
    big = 2**31 + 12345
    (ta, a), (tb, b) = _chunks(_tiny.MIX, big, 20), _chunks(_tiny.MIX, big, 20)
    assert np.array_equal(ta.check, tb.check)
    for x, y in zip(a, b):
        for f in ("start", "valid", "reset"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
    _, c = _chunks(_tiny.MIX, big + 1, 20)
    assert any(not np.array_equal(x.start, y.start) for x, y in zip(a, c))


def test_every_seed_draws_the_same_lengths():
    """Each seed's first ``pool`` utterances are the pool's lengths, in an
    order of the seed's own."""
    mix = spec.traffic("offline")
    u = mix["utterance_frames"]
    pool = length_pool(u)
    assert pool.size == u["pool"]
    assert pool.min() >= u["min"] and pool.max() <= u["max"]
    assert abs(np.median(pool) - u["median"]) <= 1
    firsts = [Utterances(mix, rng_for(seed, 0)).take(pool.size)[0]
              for seed in (1, 2**31 + 7)]
    for f in firsts:
        assert np.array_equal(np.sort(f), np.sort(pool))
    assert not np.array_equal(*firsts)


def test_slot_state_runs_out_then_refills():
    t = Traffic(_tiny.MIX, 4)
    s = t.streams[0]
    prev_left = None
    for _ in range(15):
        left_before = s.lens - s.pos
        ch = t.next()
        ended = left_before <= 0
        assert np.array_equal(ch.reset, ended | (prev_left is None))
        assert np.array_equal(ch.valid, np.minimum(
            np.where(ended, s.lens, left_before), t.k))
        prev_left = left_before


def test_open_loop_schedule_is_staggered():
    mix = _tiny.OPEN_MIX
    t = Traffic(mix, 1)
    period = mix["chunk_frames"] * mix["frame_ms"] / 1e3
    dues = [t.due_s(i) for i in range(7)]
    g = mix["groups"]
    assert dues == pytest.approx([(i // g + (i % g) / g) * period
                                  for i in range(7)])
    chunks = [t.next() for _ in range(6)]
    assert [c.group for c in chunks] == [0, 1, 2, 0, 1, 2]
    assert t.per_group == mix["slots"] // g
    assert Traffic(_tiny.MIX, 1).due_s(3) is None


def test_open_loop_runs_and_times_from_due():
    """An open-loop window on the CPU: chunks issued on schedule, latency
    from each chunk's due time, and the check holds."""
    cfg = _tiny.config("gru")
    r = d.run(cfg, _tiny.OPEN_MIX, 21, 0.05, False, torch.device("cpu"),
              time.perf_counter())
    w = r["window"]
    assert len(w.late_ms) == len(w.chunk_ms) == w.chunks >= 3 * 3
    assert min(w.late_ms) >= 0
    assert r["checks"]["out_gap"] <= 1e-5
    assert set(w.checks) <= {0, 1, 2} and len(w.checks) >= 2

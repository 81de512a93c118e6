"""``spawn_ranks`` reports the rank that failed first, whichever rank
``ProcessContext.join`` notices first.

``join`` raises for the lowest-numbered rank among those that had ended
when it polled. Here every rank has ended before ``join`` polls (the
poll is held until then), so ``join`` alone would report rank 0's
failure in its collective; the call must still report rank 1's.
"""
import os
import time

import pytest
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessContext

from repro_torch.dist.launch import spawn_ranks


def _rank_raises(mesh):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 refuses")
    t = __import__("torch").zeros(2)
    dist.all_gather([t.clone() for _ in range(2)], t)


def _rank_aborts(mesh):
    if dist.get_rank() == 1:
        os.abort()
    t = __import__("torch").zeros(2)
    dist.all_gather([t.clone() for _ in range(2)], t)


@pytest.fixture
def join_after_every_rank_ended(monkeypatch):
    """``join`` polls only once every rank has ended (60 s at most)."""
    real = ProcessContext.join

    def join(self, timeout=None, grace_period=None):
        deadline = time.monotonic() + 60
        for p in self.processes:
            p.join(max(deadline - time.monotonic(), 0))
        return real(self, timeout=timeout, grace_period=grace_period)

    monkeypatch.setattr(ProcessContext, "join", join)


def test_the_first_traceback_comes_first(join_after_every_rank_ended):
    with pytest.raises(Exception, match="rank 1 refuses") as e:
        spawn_ranks(_rank_raises, (1, 2), device="cpu", timeout_s=60)
    msg = str(e.value)
    assert "_rank_raises" in msg
    # rank 0 failed in its all_gather after rank 1 had gone: it comes after
    assert msg.index("rank 1 raised") < msg.index("rank 0 raised")


def test_a_rank_dead_without_a_traceback_comes_first(
        join_after_every_rank_ended):
    with pytest.raises(Exception, match=r"rank 1 ended without a traceback "
                                        r"\(signal SIGABRT\)") as e:
        spawn_ranks(_rank_aborts, (1, 2), device="cpu", timeout_s=60)
    assert str(e.value).index("rank 1 ended") < str(e.value).index(
        "rank 0 raised")

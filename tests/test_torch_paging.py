"""Port of serve/paging.py and the host half of serve/scheduler.py.

The port's ``PagePool`` and ``SlotScheduler`` are copies; the one change
is ``device_table``, which returns a torch tensor. Each test here drives
the JAX package's pool and the port's through the same events: the
non-prefix fuzz traces of tests/test_paging.py (the engine protocol, and
the speculative ensure/truncate protocol), running the port pool's
``check()`` after every event and holding its table, counters and stats
equal to the JAX pool's."""
import numpy as np
import pytest
import torch

from repro.serve import PagePool as JPagePool
from repro.serve import Request as JRequest
from repro.serve import SlotScheduler as JSlotScheduler
from repro.serve import pages_for as j_pages_for
from repro.serve import simulate_admission as j_simulate
from repro_torch.serve import (
    PagePool, Request, SlotScheduler, pages_for, simulate_admission,
)

N_SWEEPS = 20          # 120 traces of each kind
TRACES_PER_SWEEP = 6


class Pair:
    """The JAX pool and scheduler and the port's, fed the same events."""

    def __init__(self, n_slots, page_size, n_pages, max_pages):
        self.jpool = JPagePool(page_size, n_pages, n_slots, max_pages)
        self.tpool = PagePool(page_size, n_pages, n_slots, max_pages,
                              device="cpu")
        self.jsched = JSlotScheduler(n_slots, pool=self.jpool)
        self.tsched = SlotScheduler(n_slots, pool=self.tpool)

    def both(self, method, *args, pool=False):
        j = getattr(self.jpool if pool else self.jsched, method)(*args)
        t = getattr(self.tpool if pool else self.tsched, method)(*args)
        return j, t

    def agree(self):
        """The port pool's invariants, and the same state as JAX's."""
        self.tpool.check()
        table = self.tpool.device_table()
        assert table.dtype == torch.int32 and table.device.type == "cpu"
        np.testing.assert_array_equal(
            table.numpy(), np.asarray(self.jpool.device_table()))
        j, t = self.jpool, self.tpool
        assert t.allocated_total() == j.allocated_total()
        assert t.reserved_total() == j.reserved_total()
        assert t.available() == j.available()
        assert t._free == j._free
        assert t.fragmentation() == j.fragmentation()
        np.testing.assert_array_equal(self.tsched.positions(),
                                      self.jsched.positions())
        np.testing.assert_array_equal(self.tsched.active_mask(),
                                      self.jsched.active_mask())


def _requests(rng, n_reqs, cap_tokens):
    out = []
    for i in range(n_reqs):
        total = int(rng.integers(2, cap_tokens + 1))
        plen = int(rng.integers(1, total))
        arrival = int(rng.integers(0, 3 * n_reqs))
        out.append((i, plen, total - plen, arrival))
    return out


def run_trace(rng, n_slots, page_size, n_pages, max_pages, n_reqs,
              spec_k=0):
    """tests/test_paging.py's engine-protocol trace (``spec_k`` > 0: its
    speculative verify-span ensure + random-acceptance truncate), on both
    pools in lockstep."""
    if min(n_pages, max_pages) * page_size < 2:
        page_size = 2
    pr = Pair(n_slots, page_size, n_pages, max_pages)
    cap = min(n_pages, max_pages) * page_size
    for rid, plen, new, arrival in _requests(rng, n_reqs, cap):
        toks = np.zeros(plen, np.int32)
        pr.jsched.submit(JRequest(rid=rid, tokens=toks, max_new_tokens=new,
                                  arrival=arrival))
        pr.tsched.submit(Request(rid=rid, tokens=toks, max_new_tokens=new,
                                 arrival=arrival))
    pr.agree()
    guard = 100 * n_reqs + 1000
    while pr.tsched.has_work():
        assert pr.jsched.has_work()
        ja, ta = pr.both("admit")
        assert [(s, r.rid) for s, r in ja] == [(s, r.rid) for s, r in ta]
        for slot, req in ta:
            pr.agree()
            pr.both("ensure", slot, req.prompt_len, pool=True)
            pr.agree()
            first = int(rng.integers(0, 100))
            pr.both("started", slot, first)
            pr.agree()
        active = pr.tsched.active_mask()
        if not active.any():
            pr.both("idle_tick")
            guard -= 1
            assert guard > 0
            continue
        pos = pr.tsched.positions()
        if not spec_k:
            for i in np.flatnonzero(active):
                pr.both("ensure", int(i), int(pos[i]) + 1, pool=True)
                pr.agree()
            pr.both("tick", pool=True)
            pr.both("advance", rng.integers(0, 100, size=n_slots))
        else:
            remaining = np.asarray([0 if sl is None else sl.remaining
                                    for sl in pr.tsched._slots])
            # verify-span ensure: frontier + k + 1 capped at lifetime
            for i in np.flatnonzero(active):
                pr.both("ensure", int(i), int(min(
                    pos[i] + spec_k + 1, pos[i] + remaining[i])), pool=True)
                pr.agree()
            pr.both("tick", pool=True)
            committed = {}
            for i in np.flatnonzero(active):
                k_eff = min(spec_k, int(remaining[i]) - 1)
                n = int(rng.integers(1, k_eff + 2))
                committed[int(i)] = [int(t) for t in
                                     rng.integers(0, 100, size=n)]
                pr.both("truncate", int(i), int(pos[i]) + n, pool=True)
                pr.agree()
            pr.both("advance_spec", committed)
        pr.agree()
        guard -= 1
        assert guard > 0, "trace did not terminate"
    assert not pr.jsched.has_work()
    assert pr.tsched.results == pr.jsched.results
    assert pr.tsched.stats() == pr.jsched.stats()
    assert pr.tpool.allocated_total() == 0
    assert sorted(pr.tpool._free) == list(range(pr.tpool.n_pages))
    return pr.tsched.stats()


@pytest.mark.parametrize("sweep", range(N_SWEEPS))
def test_fuzz_random_traces_match_jax(sweep):
    rng = np.random.default_rng(7919 * sweep + 13)
    for _ in range(TRACES_PER_SWEEP):
        n_slots = int(rng.integers(1, 6))
        page_size = int(rng.integers(1, 9))
        max_pages = int(rng.integers(1, 9))
        n_pages = int(rng.integers(1, n_slots * max_pages + 2))
        n_reqs = int(rng.integers(1, 13))
        run_trace(rng, n_slots, page_size, n_pages, max_pages, n_reqs)


@pytest.mark.parametrize("sweep", range(N_SWEEPS))
def test_fuzz_spec_traces_match_jax(sweep):
    rng = np.random.default_rng(6700417 * sweep + 17)
    for _ in range(TRACES_PER_SWEEP):
        n_slots = int(rng.integers(1, 6))
        page_size = int(rng.integers(1, 9))
        max_pages = int(rng.integers(1, 9))
        n_pages = int(rng.integers(1, n_slots * max_pages + 2))
        n_reqs = int(rng.integers(1, 13))
        k = int(rng.integers(1, 6))
        run_trace(rng, n_slots, page_size, n_pages, max_pages, n_reqs,
                  spec_k=k)


def test_starved_pool_stalls_but_completes_as_jax():
    stats = run_trace(np.random.default_rng(99), n_slots=4, page_size=4,
                      n_pages=3, max_pages=3, n_reqs=16)
    assert stats["requests"] == 16
    assert stats["page_stalls"] > 0
    assert stats["paging"]["peak_pages"] <= 3


def test_device_table_is_cached_until_the_pool_changes():
    pool = PagePool(4, 6, 2, 3, device="cpu")
    t0 = pool.device_table()
    assert t0.dtype == torch.int32 and tuple(t0.shape) == (2, 3)
    assert (t0 == pool.scratch_page).all()
    assert pool.device_table() is t0           # clean: the same object
    pool.reserve(1, 9)
    assert pool.device_table() is t0           # a reservation maps nothing
    pool.ensure(1, 5)
    t1 = pool.device_table()
    assert t1 is not t0
    assert t1[1, :2].tolist() == pool.slot_pages(1)
    pool.release(1)
    assert (pool.device_table() == pool.scratch_page).all()


@pytest.mark.parametrize("page_size", [1, 3, 16])
def test_pages_for_matches_jax(page_size):
    for n in range(-2, 70):
        assert pages_for(n, page_size) == j_pages_for(n, page_size)


@pytest.mark.parametrize("with_pool", [False, True])
def test_simulate_admission_matches_jax(with_pool):
    rng = np.random.default_rng(4)
    reqs = [(int(rng.integers(1, 20)), int(rng.integers(1, 12)),
             int(rng.integers(0, 10))) for _ in range(12)]
    jr = [JRequest(rid=i, tokens=np.zeros(p, np.int32), max_new_tokens=m,
                   arrival=a) for i, (p, m, a) in enumerate(reqs)]
    tr = [Request(rid=i, tokens=np.zeros(p, np.int32), max_new_tokens=m,
                  arrival=a) for i, (p, m, a) in enumerate(reqs)]
    jp = JPagePool(4, 12, 3, 8) if with_pool else None
    tp = PagePool(4, 12, 3, 8, device="cpu") if with_pool else None
    assert simulate_admission(3, tr, pool=tp, step_time_us=2.0) \
        == j_simulate(3, jr, pool=jp, step_time_us=2.0)


def test_pool_raises_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagePool(4, 6, 2, 3)

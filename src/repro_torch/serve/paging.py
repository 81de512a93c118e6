"""Paged KV/state cache: a block-pool allocator for serve slots.

The contiguous serve cache gives every decode slot the worst-case time
footprint (``n_slots x cache_len`` tokens) even when most requests are
short — the same waste the paper removes from *weights* by packing
irregular sparsity into fixed-size blocks (CSB §4). This module applies
that regular-block philosophy to *activations*: the cache becomes a pool
of fixed-size token **pages** shared by all slots, and each slot maps
its logical positions onto physical pages through a dense page table.

Design points (all jit-friendliness driven):

* The page table is a dense ``(n_slots, max_pages)`` int32 array —
  passed straight into the jitted decode step, no ragged host structure
  crosses the trace boundary. Free entries hold ``-1`` on the host;
  :meth:`device_table` maps them to a dedicated **scratch page** (index
  ``n_pages``, one extra physical page the pools allocate beyond the
  allocator's range) so inactive slots write/gather somewhere harmless
  without any masking inside the step.
* **Reservation-based admission**: a request reserves its own worst case
  (``ceil((prompt + max_new) / page_size)`` pages) when admitted, and
  physical pages are allocated lazily as the position advances
  (:meth:`ensure`). Admission is bounded by *per-request* need, not the
  global max length — mixed-length traces pack more concurrent requests
  into the same token budget than contiguous slots can — and a slot can
  never stall mid-decode waiting for a page (no deadlock by
  construction).
* Pages are freed the moment a request finishes (:meth:`release`),
  mid-decode, and immediately reusable. Freed pages are NOT zeroed: the
  decode mask (``kpos <= pos``) plus the write-before-unmask order means
  a successor can never attend a predecessor's stale KV (see
  serve.scheduler's eviction notes; per-slot SSM/conv state, which has
  no mask, is still zeroed by the engine).

Prefix sharing (``prefix_cache=True``) layers a radix cache on top:

* Every physical page carries a **refcount**; a page is free iff its
  refcount is zero. A prefix **trie** keyed on per-page token tuples
  owns one reference to each registered prompt page, so prompt KV
  outlives the request that computed it.
* :meth:`try_reserve` walks the trie with the new prompt. Matched pages
  map straight into the slot (refcount bumped, zero prefill compute for
  the matched span); the reservation then counts only the *unshared*
  worst case. Matching is token-granular: after the whole-page walk, a
  child page whose tokens extend the remaining prompt is mapped
  partially, so divergence mid-page still shares the common span.
* The first write into a partially-shared page triggers **copy-on-write**
  (:meth:`cow_if_needed`): a private page is allocated from the pool (its
  cost was part of the reservation), the engine copies the page contents
  device-side, and the shared original keeps serving its other readers.
* When the free list runs dry, :meth:`_alloc_page` **reclaims** trie
  pages no live slot maps, LRU leaf first — retention is best-effort,
  reservations always win.

Host-side only — the device half (paged write/gather, page-granular
insert/copy) lives in ``models.layers`` / ``serve.scheduler``.

A copy of ``repro.serve.paging`` with one change:
:meth:`PagePool.device_table` returns an int32 torch tensor on the pool's
``device`` (the JAX package returns a ``jnp`` array). The references to
jitting above say why the table is dense: the port's decode step takes it
as one tensor too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (0 tokens still needs 0 pages)."""
    return -(-max(n_tokens, 0) // page_size)


@dataclasses.dataclass
class PoolStats:
    """Running occupancy/fragmentation telemetry (sampled via tick())."""

    peak_pages: int = 0
    ticks: int = 0
    page_steps: int = 0          # sum over ticks of allocated pages
    frag_weighted: float = 0.0   # sum over ticks of internal-frag fraction

    def as_dict(self) -> dict:
        return {
            "peak_pages": self.peak_pages,
            "mean_pages": round(self.page_steps / self.ticks, 2)
            if self.ticks else 0.0,
            "internal_fragmentation": round(
                self.frag_weighted / self.ticks, 4) if self.ticks else 0.0,
        }


@dataclasses.dataclass(frozen=True)
class SharedInfo:
    """Outcome of a prefix-cache admission (try_reserve).

    ``shared_tokens``— prompt tokens whose KV is already in the pool.
    ``shared_pages`` — physical pages mapped from the trie.
    ``suffix_start`` — first position prefill must compute. Capped at
                       ``prompt_len - 1`` so even a fully-matched prompt
                       re-prefills its last token (the engine needs its
                       logits to sample from).
    ``needs_cow``    — the suffix starts inside the last shared page, so
                       the engine must :meth:`PagePool.cow_if_needed` +
                       copy before any write.
    """

    shared_tokens: int = 0
    shared_pages: int = 0
    suffix_start: int = 0
    needs_cow: bool = False


class _TrieNode:
    """One page of a registered prompt: ``tokens`` (a page_size tuple)
    keyed under the parent, owning one refcount on ``page``."""

    __slots__ = ("tokens", "page", "children", "parent", "last_use")

    def __init__(self, tokens, page, parent):
        self.tokens = tokens
        self.page = page
        self.children = {}
        self.parent = parent
        self.last_use = 0


class PagePool:
    """Fixed-size token-page allocator behind the serve decode slots.

    ``n_pages``  — allocatable pool capacity (the scratch page the device
                   pools carry at index ``n_pages`` is NOT part of it).
    ``max_pages``— page-table width: the most pages one slot may ever
                   hold (``ceil(cache_len / page_size)``); bounds the
                   logical time extent the decode step gathers.
    ``prefix_cache`` — retain prompt pages in a refcounted radix trie and
                   share them across requests (see module docstring).
    ``device``   — where :meth:`device_table` puts the table (``None``
                   means the card).
    """

    def __init__(self, page_size: int, n_pages: int, n_slots: int,
                 max_pages: int, prefix_cache: bool = False, device=None):
        if page_size < 1 or n_pages < 1 or n_slots < 1 or max_pages < 1:
            raise ValueError("page_size, n_pages, n_slots, max_pages "
                             "must all be >= 1")
        self.page_size = page_size
        self.n_pages = n_pages
        self.n_slots = n_slots
        self.max_pages = max_pages
        self.prefix_cache = prefix_cache
        self.device = resolve_device(device)
        # LIFO free list: recently freed pages are reused first (their
        # device-side contents are hottest in cache)
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._ref = [0] * n_pages         # refcount per physical page
        self._table = [[-1] * max_pages for _ in range(n_slots)]
        self._n_alloc = [0] * n_slots     # physical pages held per slot
        self._n_shared = [0] * n_slots    # leading trie-shared pages
        self._reserved = [0] * n_slots    # admission reservation per slot
        self._tokens = [0] * n_slots      # tokens ensure()d per slot
        self._write_floor = [0] * n_slots  # first position writes may touch
        self._info: list[SharedInfo | None] = [None] * n_slots
        self._root = _TrieNode(None, -1, None)
        self._clock = 0                   # LRU stamp for trie nodes
        self.cow_copies = 0
        self.trie_evictions = 0
        self.stats = PoolStats()
        self._dirty = True
        self._device_table = None

    # -- capacity / admission ------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    def reserved_total(self) -> int:
        return sum(self._reserved)

    def allocated_total(self) -> int:
        return self.n_pages - len(self._free)

    def _outstanding(self) -> int:
        """Pages already promised but not yet privately allocated."""
        return sum(
            max(self._reserved[s]
                - (self._n_alloc[s] - self._n_shared[s]), 0)
            for s in range(self.n_slots))

    def _evictable(self) -> int:
        """Trie pages reclaimable by repeated LRU leaf eviction: a node
        counts iff no slot maps its page AND its whole subtree counts."""
        def walk(node):
            cnt, whole = 0, True
            for ch in node.children.values():
                c, w = walk(ch)
                cnt += c
                whole = whole and w
            if node is self._root:
                return cnt, whole
            if whole and self._ref[node.page] == 1:
                return cnt + 1, True
            return cnt, False
        return walk(self._root)[0]

    def available(self) -> int:
        """Pages admission may still promise. Free pages plus reclaimable
        trie pages, minus what existing reservations may yet claim —
        reduces to ``n_pages - reserved_total()`` for trie-less pools."""
        return len(self._free) + self._evictable() - self._outstanding()

    def fits_ever(self, n_tokens: int) -> bool:
        """Could a request of this total length EVER be admitted?"""
        need = self.pages_needed(n_tokens)
        return need <= min(self.n_pages, self.max_pages)

    def can_admit(self, n_tokens: int) -> bool:
        need = self.pages_needed(n_tokens)
        return need <= self.max_pages and need <= self.available()

    # -- slot lifecycle ------------------------------------------------------
    def reserve(self, slot: int, n_tokens: int) -> None:
        """Admission: promise the slot its worst-case page count."""
        if self._reserved[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        need = self.pages_needed(n_tokens)
        if not self.can_admit(n_tokens):
            raise RuntimeError(
                f"cannot reserve {need} pages for slot {slot}: "
                f"{self.available()} available, max_pages={self.max_pages}")
        self._reserved[slot] = need
        self._write_floor[slot] = 0
        self._info[slot] = None

    def try_reserve(self, slot: int, n_tokens: int,
                    tokens=None) -> SharedInfo | None:
        """Prefix-aware admission. Matches ``tokens`` (the prompt) against
        the trie, maps the shared span into the slot, and reserves only
        the unshared worst case (plus one page when divergence lands
        inside a shared page — the CoW copy). Atomic: on failure nothing
        is mapped or reserved and ``None`` is returned."""
        if self._reserved[slot] or self._n_alloc[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        need_total = self.pages_needed(n_tokens)
        if need_total > self.max_pages:
            return None
        path, matched = ([], 0)
        if self.prefix_cache and tokens is not None:
            path, matched = self._match([int(t) for t in tokens])
        plen = len(tokens) if tokens is not None else 0
        while True:
            suffix_start = min(matched, plen - 1) if matched else 0
            if suffix_start <= 0:
                path, matched, suffix_start = [], 0, 0
            sp = len(path)
            cow = bool(sp) and suffix_start < sp * self.page_size
            need_priv = need_total - sp + (1 if cow else 0)
            # pin the path first: pinned nodes stop being evictable, and
            # the capacity check must see that
            for nd in path:
                self._ref[nd.page] += 1
            if need_priv <= len(self._free) + self._evictable() \
                    - self._outstanding():
                break
            for nd in path:
                self._ref[nd.page] -= 1
            if not path:
                return None
            # Sharing must never admit LESS than not sharing: a partial
            # match pays a CoW page while pinning the matched span out of
            # the evictable supply, so on a tight pool the shared plan
            # can exceed capacity where the unshared one fits (found by
            # the paging fuzz as a permanent FIFO stall). Retreat to the
            # whole-page boundary first (drops the CoW cost), then give
            # up sharing entirely before reporting failure.
            if cow:
                path = path[:-1]
                matched = len(path) * self.page_size
            else:
                path, matched = [], 0
        self._clock += 1
        for i, nd in enumerate(path):
            self._table[slot][i] = nd.page
            nd.last_use = self._clock
        self._n_alloc[slot] = sp
        self._n_shared[slot] = sp
        self._reserved[slot] = need_priv
        self._tokens[slot] = suffix_start
        self._write_floor[slot] = suffix_start
        info = SharedInfo(shared_tokens=matched, shared_pages=sp,
                          suffix_start=suffix_start, needs_cow=cow)
        self._info[slot] = info
        if sp:
            self._dirty = True
            obs_trace.instant("serve/pool/prefix_hit",
                              args={"slot": slot, "shared_pages": sp,
                                    "shared_tokens": matched})
            reg = obs_metrics.get()
            if reg is not None:
                reg.counter("serve/pool/prefix_hits").inc()
                reg.counter("serve/pool/shared_pages").inc(sp)
        return info

    def shared_info(self, slot: int) -> SharedInfo | None:
        """SharedInfo recorded by the slot's try_reserve (None after a
        plain reserve)."""
        return self._info[slot]

    def cow_if_needed(self, slot: int):
        """Copy-on-write the slot's last shared page if prefill/decode
        will write into it. Remaps the slot to a private page and returns
        ``(src, dst)`` for the engine's device-side page copy, or None
        when the write floor sits at/after the shared span already."""
        sp = self._n_shared[slot]
        if sp == 0 or self._write_floor[slot] >= sp * self.page_size:
            return None
        src = self._table[slot][sp - 1]
        dst = self._alloc_page()
        self._table[slot][sp - 1] = dst
        self._n_shared[slot] = sp - 1
        self._unref(src)
        self.cow_copies += 1
        self._dirty = True
        obs_trace.instant("serve/pool/cow",
                          args={"slot": slot, "src": src, "dst": dst})
        reg = obs_metrics.get()
        if reg is not None:
            reg.counter("serve/pool/cow_copies").inc()
        return (src, dst)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow the slot's allocation to cover ``n_tokens`` positions.
        Returns True when the page table changed (new pages mapped)."""
        need = self.pages_needed(n_tokens)
        if need - self._n_shared[slot] > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: ensure({n_tokens}) needs "
                f"{need - self._n_shared[slot]} private pages but only "
                f"{self._reserved[slot]} are reserved")
        if n_tokens > self._write_floor[slot] \
                and self._write_floor[slot] \
                < self._n_shared[slot] * self.page_size:
            raise RuntimeError(
                f"slot {slot}: write into a shared page — call "
                "cow_if_needed() and copy the page first")
        self._tokens[slot] = max(self._tokens[slot], n_tokens)
        self._write_floor[slot] = max(self._write_floor[slot],
                                      self._tokens[slot])
        grew = False
        while self._n_alloc[slot] < need:
            page = self._alloc_page()
            self._table[slot][self._n_alloc[slot]] = page
            self._n_alloc[slot] += 1
            grew = True
        if grew:
            self._dirty = True
        return grew

    def truncate(self, slot: int, n_tokens: int) -> list[int]:
        """Roll the slot's logical length back to ``n_tokens``
        (speculative rollback past a rejected draft position). Whole tail
        pages beyond ``pages_needed(n_tokens)`` are unmapped; trie-held
        pages survive (prefix cache), purely private ones return to the
        free list. The boundary page — committed and stale KV mixed —
        stays mapped: stale entries sit at positions >= n_tokens, and the
        ``kpos <= pos`` decode mask never attends them, so no device-side
        zeroing is needed. ``write_floor`` is NOT lowered — those
        positions were legitimately written and the next verify step will
        overwrite them. Returns the pages actually freed."""
        if n_tokens > self._tokens[slot]:
            raise ValueError(
                f"slot {slot}: truncate({n_tokens}) beyond current "
                f"length {self._tokens[slot]}")
        if n_tokens < self._n_shared[slot] * self.page_size:
            raise ValueError(
                f"slot {slot}: truncate({n_tokens}) into the shared "
                f"prefix span ({self._n_shared[slot]} pages)")
        keep = self.pages_needed(n_tokens)
        freed = []
        while self._n_alloc[slot] > keep:
            self._n_alloc[slot] -= 1
            page = self._table[slot][self._n_alloc[slot]]
            self._table[slot][self._n_alloc[slot]] = -1
            if self._ref[page] == 1:
                freed.append(page)
            self._unref(page)
        self._tokens[slot] = n_tokens
        if freed:
            self._dirty = True
            obs_trace.instant("serve/pool/truncate",
                              args={"slot": slot, "n_tokens": n_tokens,
                                    "freed": len(freed)})
        return freed

    def register_prefix(self, slot: int, tokens) -> int:
        """Insert the slot's (fully prefilled) prompt pages into the trie
        so later requests can share them. Only whole pages register; the
        trie takes one reference per newly-registered page. Returns the
        number of pages added. No-op unless ``prefix_cache``."""
        if not self.prefix_cache:
            return 0
        toks = [int(t) for t in tokens]
        psz = self.page_size
        node = self._root
        self._clock += 1
        added = 0
        for i in range(len(toks) // psz):
            key = tuple(toks[i * psz:(i + 1) * psz])
            ch = node.children.get(key)
            if ch is None:
                page = self._table[slot][i]
                assert 0 <= page < self.n_pages, \
                    f"slot {slot}: registering unmapped page {i}"
                ch = _TrieNode(key, page, node)
                node.children[key] = ch
                self._ref[page] += 1
                added += 1
            ch.last_use = self._clock
            node = ch
        return added

    def slot_pages(self, slot: int) -> list[int]:
        """Physical pages currently mapped for the slot, in logical order."""
        return self._table[slot][: self._n_alloc[slot]]

    def slot_row(self, slot: int):
        """np int32 ``(max_pages,)`` physical row; unmapped -> scratch."""
        row = np.asarray(self._table[slot], np.int32)
        row[row < 0] = self.scratch_page
        return row

    def release(self, slot: int) -> list[int]:
        """Finish/evict: drop the slot's references and reservation. Pages
        the trie still holds survive (that is the prefix cache); the rest
        return to the free list. Returns the pages actually freed."""
        freed = []
        for p in self.slot_pages(slot):
            self._ref[p] -= 1
            if self._ref[p] == 0:
                freed.append(p)
        self._free.extend(reversed(freed))
        had = self._n_alloc[slot] > 0
        self._table[slot] = [-1] * self.max_pages
        self._n_alloc[slot] = 0
        self._n_shared[slot] = 0
        self._reserved[slot] = 0
        self._tokens[slot] = 0
        self._write_floor[slot] = 0
        self._info[slot] = None
        if had:
            self._dirty = True
        return freed

    def drop_prefix_cache(self) -> int:
        """Evict every trie page no live slot maps. Returns pages freed."""
        freed = 0
        while True:
            victim = self._lru_evictable_leaf()
            if victim is None:
                return freed
            self._evict_node(victim)
            freed += 1

    # -- page allocation / reclaim -------------------------------------------
    def _alloc_page(self) -> int:
        """Pop a free page, reclaiming from the trie when the list is dry
        (reservation accounting guarantees one exists)."""
        if not self._free:
            victim = self._lru_evictable_leaf()
            if victim is None:
                raise RuntimeError("page pool exhausted: reservation "
                                   "accounting violated (no reclaimable "
                                   "trie page)")
            self._evict_node(victim)
        page = self._free.pop()
        self._ref[page] = 1
        self.stats.peak_pages = max(self.stats.peak_pages,
                                    self.allocated_total())
        return page

    def _lru_evictable_leaf(self):
        best = None
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif self._ref[nd.page] == 1 and (
                    best is None or nd.last_use < best.last_use):
                best = nd
        return best

    def _evict_node(self, node) -> None:
        node.parent.children.pop(node.tokens)
        self._unref(node.page)
        self.trie_evictions += 1

    def _unref(self, page: int) -> None:
        self._ref[page] -= 1
        assert self._ref[page] >= 0, f"page {page} refcount underflow"
        if self._ref[page] == 0:
            self._free.append(page)

    def _match(self, toks):
        """Longest trie match: whole pages first, then a token-granular
        partial match against one child of the last matched node."""
        psz = self.page_size
        node = self._root
        path, matched = [], 0
        n_full = len(toks) // psz
        i = 0
        while i < n_full:
            ch = node.children.get(tuple(toks[i * psz:(i + 1) * psz]))
            if ch is None:
                break
            path.append(ch)
            node = ch
            matched += psz
            i += 1
        rem = toks[i * psz:]
        best, best_r = None, 0
        for ch in node.children.values():
            r = 0
            lim = min(len(rem), psz)
            while r < lim and ch.tokens[r] == rem[r]:
                r += 1
            if r > best_r:
                best, best_r = ch, r
        if best is not None:
            path.append(best)
            matched += best_r
        return path, matched

    # -- device view ---------------------------------------------------------
    @property
    def scratch_page(self) -> int:
        """Physical index of the write-sink page (see module docstring)."""
        return self.n_pages

    def device_table(self) -> torch.Tensor:
        """(n_slots, max_pages) int32 tensor on the pool's device; free
        entries -> scratch. Cached between calls (the same object) until
        an alloc/release dirties it."""
        if self._dirty or self._device_table is None:
            t = np.asarray(self._table, np.int32)
            t[t < 0] = self.scratch_page
            self._device_table = torch.from_numpy(t).to(self.device)
            self._dirty = False
        return self._device_table

    # -- telemetry -----------------------------------------------------------
    def tick(self) -> None:
        """Sample occupancy/fragmentation once per decode step. With
        :mod:`repro_torch.obs.metrics` enabled, each sample also lands in
        the ``serve/pool/*`` gauge timelines — occupancy over the run, not
        just the end-of-run summary averages."""
        alloc = self.allocated_total()
        used = sum(self._tokens)
        cap = alloc * self.page_size
        self.stats.ticks += 1
        self.stats.page_steps += alloc
        frag = (1.0 - used / cap) if cap else 0.0
        if cap:
            self.stats.frag_weighted += frag
        reg = obs_metrics.get()
        if reg is not None:
            reg.gauge("serve/pool/pages").set(alloc)
            reg.gauge("serve/pool/free_pages").set(len(self._free))
            reg.gauge("serve/pool/fragmentation").set(round(frag, 4))
            if self.prefix_cache:
                reg.gauge("serve/pool/trie_pages").set(self.trie_pages())

    def fragmentation(self) -> float:
        """Instantaneous internal fragmentation: the fraction of
        allocated page capacity not holding a live token."""
        cap = self.allocated_total() * self.page_size
        return (1.0 - sum(self._tokens) / cap) if cap else 0.0

    def trie_pages(self) -> int:
        """Physical pages the trie currently holds a reference on."""
        cnt, stack = 0, list(self._root.children.values())
        while stack:
            nd = stack.pop()
            cnt += 1
            stack.extend(nd.children.values())
        return cnt

    def summary(self) -> dict:
        out = {
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "max_pages": self.max_pages,
            **self.stats.as_dict(),
        }
        if self.prefix_cache:
            out.update(prefix_cache=True, trie_pages=self.trie_pages(),
                       cow_copies=self.cow_copies,
                       trie_evictions=self.trie_evictions)
        return out

    # -- invariants (the fuzz suite's oracle) --------------------------------
    def check(self) -> None:
        """Assert every allocator invariant; raises AssertionError on the
        first violation. Called after every event by the property tests,
        cheap enough to leave on in simulations."""
        from collections import Counter

        live = [p for row, n in zip(self._table, self._n_alloc)
                for p in row[:n]]
        # walk the trie: structural sanity + the set of trie-owned pages
        trie = []
        stack = [(self._root, key, ch)
                 for key, ch in self._root.children.items()]
        while stack:
            parent, key, nd = stack.pop()
            assert nd.parent is parent and nd.tokens == key
            assert len(nd.tokens) == self.page_size, "partial page in trie"
            assert 0 <= nd.page < self.n_pages
            trie.append(nd.page)
            stack.extend((nd, k, c) for k, c in nd.children.items())
        tset = set(trie)
        assert len(trie) == len(tset), "page owned by two trie nodes"
        # refcount conservation: ref == slot mappings + trie ownership
        expect = Counter(live)
        expect.update(trie)
        for p in range(self.n_pages):
            assert self._ref[p] == expect.get(p, 0), \
                f"page {p}: refcount {self._ref[p]} != {expect.get(p, 0)}"
        # free list <=> refcount zero; no duplicates; no leak
        free = set(self._free)
        assert len(free) == len(self._free), "free list duplicate"
        assert all(self._ref[p] == 0 for p in free), \
            "referenced page on the free list"
        held = {p for p in range(self.n_pages) if self._ref[p] > 0}
        assert not (free & held)
        assert len(free) + len(held) == self.n_pages, "page leaked"
        # sharing happens ONLY through the trie (a CoW'd page must not
        # stay aliased): any page mapped by >1 slot is trie-owned
        for p, c in Counter(live).items():
            assert c == 1 or p in tset, "page aliased outside the trie"
        for s in range(self.n_slots):
            row = self._table[s]
            n = self._n_alloc[s]
            assert all(0 <= p < self.n_pages for p in row[:n])
            assert len(set(row[:n])) == n, "page mapped twice in one slot"
            assert all(p == -1 for p in row[n:]), "stale table entry"
            assert 0 <= self._n_shared[s] <= n
            assert all(p in tset for p in row[:self._n_shared[s]]), \
                "shared-mapped page lost its trie node"
            # write isolation: a slot's writes span [suffix_start,
            # write_floor). Once that span is non-empty, every shared page
            # must sit strictly below it (CoW must have run first).
            info = self._info[s]
            floor0 = info.suffix_start if info is not None else 0
            if self._write_floor[s] > floor0:
                assert self._n_shared[s] * self.page_size <= floor0, \
                    f"slot {s}: write into shared pages without CoW"
            priv = n - self._n_shared[s]
            assert priv <= self._reserved[s]
            assert self._reserved[s] <= self.max_pages
            assert self.pages_needed(self._tokens[s]) <= n
        # admission never over-promises: every outstanding private claim
        # is coverable by free + reclaimable pages (no deadlock)
        assert self._outstanding() <= len(self._free) + self._evictable(), \
            "over-admitted"


__all__ = ["PagePool", "PoolStats", "SharedInfo", "pages_for"]

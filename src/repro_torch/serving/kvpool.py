"""Paged KV-cache pool: block tables, prefix sharing, copy-on-write.

Counterpart of ``repro.serving.kvpool``, line for line in numpy. The
continuous engine's ring cache gives every slot a whole power-of-two
capacity even when most requests are short or share a long system prompt.
This module is the host-side memory manager of the paged alternative
(``ServeConfig(cache_kind="paged")``): the device holds ONE pool of
fixed-height KV pages per cache family, and each slot owns a *block table*
mapping its logical pages ``(pos // R) % maxpages`` to physical pool pages.
Everything here is plain Python and numpy bookkeeping; the device side is
``models/layers.py::attn_decode_paged`` and
``models/lm.py::lm_decode_block_paged``, one block step replayed from a CUDA
graph on the card.

Page geometry comes from ``kernels/layout.py`` (``KV_PAGE_ROWS``, a
power-of-two multiple of ``KV_PAGE_ROW_MULTIPLE``).

Three cooperating pieces:

* :class:`PagePool`: a free-list allocator with per-page refcounts.
  ``alloc`` pops a page at refcount 1; ``decref`` returns it to the free
  list at 0. ``defer_free=True`` parks freed pages in limbo until
  ``flush()`` (the SSM snapshot pool: a snapshot freed at tick start may
  still be read by this tick's block step, so its page must not be
  rewritten until the next tick).
* :class:`PrefixTrie`: prompt prefixes at page granularity. Full-page
  edges are keyed by their R-token tuple; a node's *partial* entries hold
  a sub-page tail (< R tokens). Entries reference the physical page
  holding those rows (refcounted: the trie is a sharer like any slot) and
  optionally an SSM state-snapshot page valid at exactly that boundary.
  ``match`` returns the deepest shareable boundary; ``evict`` reclaims
  least-recently-used leaves under pool pressure.
* :class:`PagedKVManager`: the engine-facing facade. Admission matches the
  trie, maps shared pages into the slot's block table (incref), and
  *reserves* the worst-case number of new pages the request can touch; if
  free + evictable pages cannot cover the reservation the admission is
  **deferred** (back-pressure instead of crashing). Pages are allocated
  lazily by ``plan_tick`` as the slot's writes reach them; writing a page
  with refcount > 1 triggers **copy-on-write** (a fresh page plus a
  device-side page-copy entry, so divergence never corrupts a sharer).
  Prompt pages are registered back into the trie when prefill completes,
  so later requests share them until eviction.

Sharing semantics per family:

* attention (dense): any common prefix shares its full pages, plus the
  longest common sub-page run of the first divergent page (that page CoWs
  on the sharer's first write).
* SSM state (ssm): a state snapshot is only valid at exactly the boundary
  it was captured, so sharing requires the sharer's prompt to extend the
  *whole* registered prompt. Snapshots are captured at the first tick
  after prefill completes (device state then equals state-after-prompt)
  into the snapshot pool.

With an observability session active (``repro_torch.obs``) the manager
emits the reference's ``kv_evict``, ``kv_defer``, ``kv_alloc`` and
``kv_cow`` events, counts ``repro_kvpool_defer_total`` and
``repro_kvpool_cow_total``, and :meth:`PagedKVManager.emit_gauges` sets the
pool's gauges; ``stats()`` carries the same counters with or without one.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.kernels.layout import KV_PAGE_ROW_MULTIPLE, KV_PAGE_ROWS
# families with a paged attention KV pool / with SSM conv+state snapshots
from repro_torch.models.lm import KV_FAMILIES, STATE_FAMILIES
from repro_torch.obs import runtime as _obs

__all__ = ["KV_PAGE_ROWS", "PagePool", "PrefixTrie", "PagedKVManager",
           "cow_pairs", "validate_page_rows"]


def validate_page_rows(rows: int) -> int:
    """Page height must be a power-of-two multiple of
    ``KV_PAGE_ROW_MULTIPLE`` so pages divide every power-of-two capacity
    bucket (``engine._bucket``)."""
    m = KV_PAGE_ROW_MULTIPLE
    if rows < m or rows % m or rows & (rows - 1):
        raise ValueError(
            f"page_rows must be a power-of-two multiple of {m}, got {rows}")
    return rows


def cow_pairs(kv_copy: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The copy-on-write entries of a ``plan_tick`` page plan as ``n`` fixed
    (source, destination) pairs: ``kv_copy`` is the identity but where a
    fresh page ``d`` takes a copy of page ``kv_copy[d]``. The padding
    repeats the first real pair (or copies page 0 onto itself when there is
    none), so every write to a page carries the same value and the pairs
    can be applied in any order."""
    dst = np.flatnonzero(kv_copy != np.arange(len(kv_copy)))
    if len(dst) > n:
        raise ValueError(f"{len(dst)} copy-on-write pages in one tick, the "
                         f"step takes at most {n}")
    src = kv_copy[dst]
    pad = n - len(dst)
    first = (int(src[0]), int(dst[0])) if len(dst) else (0, 0)
    return (np.concatenate([src, np.full(pad, first[0])]).astype(np.int64),
            np.concatenate([dst, np.full(pad, first[1])]).astype(np.int64))


# ---------------------------------------------------------------------------
# page pool


class PagePool:
    """Free-list page allocator with per-page refcounts."""

    def __init__(self, n_pages: int, *, defer_free: bool = False):
        if n_pages < 1:
            raise ValueError(f"pool needs >= 1 page, got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))   # stack: pops page 0
        self._ref = [0] * n_pages
        self._limbo: list[int] = []                     # freed, unflushed
        self._defer = defer_free
        self.peak_in_use = 0
        self.total_allocs = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self._free) - len(self._limbo)

    def shared_count(self) -> int:
        return sum(1 for r in self._ref if r > 1)

    def refcount(self, pid: int) -> int:
        return self._ref[pid]

    def alloc(self) -> int | None:
        """Pop a free page at refcount 1; None when exhausted."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._ref[pid] = 1
        self.total_allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pid

    def incref(self, pid: int) -> None:
        assert self._ref[pid] > 0, f"incref of free page {pid}"
        self._ref[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when the page returned to the free
        list (or limbo, under ``defer_free``)."""
        assert self._ref[pid] > 0, f"decref of free page {pid}"
        self._ref[pid] -= 1
        if self._ref[pid]:
            return False
        (self._limbo if self._defer else self._free).append(pid)
        return True

    def flush(self) -> None:
        """Make limbo pages allocatable (end of tick: no in-flight device
        read can still target them)."""
        self._free.extend(self._limbo)
        self._limbo.clear()


# ---------------------------------------------------------------------------
# prefix trie


class _Entry:
    """One stored page of prompt tokens hanging off a trie node.

    ``tokens`` has exactly ``page_rows`` entries for a full-page edge (then
    ``child`` is the next node) or fewer for a partial tail. ``kv_page`` is
    the physical pool page holding those rows (None for pure-SSM families);
    ``state_page`` is a snapshot valid after the entry's last token (None
    when only KV is shared)."""

    __slots__ = ("tokens", "kv_page", "state_page", "child", "last_used")

    def __init__(self, tokens, kv_page, state_page, child=None):
        self.tokens = tokens
        self.kv_page = kv_page
        self.state_page = state_page
        self.child = child
        self.last_used = 0


class _Node:
    __slots__ = ("children", "partials")

    def __init__(self):
        self.children: dict[tuple, _Entry] = {}   # full-page edges
        self.partials: list[_Entry] = []          # sub-page tails


@dataclasses.dataclass
class Match:
    """Result of a trie lookup: the shareable prefix for one prompt."""
    length: int = 0                       # shared tokens (slot start pos)
    kv_pages: list = dataclasses.field(default_factory=list)  # (pid, rows)
    state_page: int | None = None         # snapshot at exactly `length`


class PrefixTrie:
    def __init__(self, page_rows: int):
        self.page_rows = page_rows
        self.root = _Node()
        self._clock = 0                   # LRU ticks (match/register bump)
        self.n_entries = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: tuple, *, need_state: bool,
              max_len: int) -> Match:
        """Deepest shareable boundary for ``tokens``, capped at ``max_len``
        (the engine passes ``plen - 1`` so an admitted sharer always has at
        least one prompt token left to process: the next-token logits come
        from that token's forward pass).

        ``need_state=False`` (attention only): every full-page edge is a
        boundary, plus the longest common sub-page run of one partial.
        ``need_state=True`` (ssm): only boundaries carrying a state snapshot
        qualify, and a partial entry must match *in full* (a snapshot is
        valid at exactly its capture length)."""
        r = self.page_rows
        now = self._tick()
        node, i = self.root, 0
        chain: list[_Entry] = []
        best = Match()

        def candidate(length, tail_entry=None, tail_rows=0):
            kv = [(e.kv_page, r) for e in chain]
            st = None
            if tail_entry is not None:
                if tail_entry.kv_page is not None:
                    kv.append((tail_entry.kv_page, tail_rows))
                st = tail_entry.state_page
            elif chain:
                st = chain[-1].state_page
            if need_state and st is None:
                return
            if any(p is None for p, _ in kv):
                kv = []                   # pure-SSM: no pages to map
            best.length = length
            best.kv_pages = kv
            best.state_page = st

        while i + r <= max_len:
            ent = node.children.get(tuple(tokens[i:i + r]))
            if ent is None:
                break
            ent.last_used = now
            chain.append(ent)
            i += r
            candidate(i)
            node = ent.child

        # partial tails hanging off the deepest matched node
        rem = tokens[i:]
        for ent in node.partials:
            et = ent.tokens
            if need_state:
                # full-entry prefix match only, boundary within max_len
                if (i + len(et) <= max_len and len(et) <= len(rem)
                        and tuple(rem[:len(et)]) == tuple(et)):
                    ent.last_used = now
                    if i + len(et) > best.length:
                        candidate(i + len(et), ent, len(et))
            else:
                lcp = 0
                limit = min(len(et), len(rem), max_len - i)
                while lcp < limit and et[lcp] == rem[lcp]:
                    lcp += 1
                if lcp > 0 and i + lcp > best.length:
                    ent.last_used = now
                    candidate(i + lcp, ent, lcp)
        return best

    def has_state_at(self, tokens: tuple) -> bool:
        """True when a snapshot for exactly ``tokens`` is registered."""
        r = self.page_rows
        node, i = self.root, 0
        while i + r <= len(tokens):
            ent = node.children.get(tuple(tokens[i:i + r]))
            if ent is None:
                return False
            if i + r == len(tokens):
                return ent.state_page is not None
            node, i = ent.child, i + r
        rem = tuple(tokens[i:])
        return any(tuple(e.tokens) == rem and e.state_page is not None
                   for e in node.partials)

    def register(self, tokens: tuple, kv_pages, state_page, pool,
                 *, tail_rows: int) -> tuple[int, bool]:
        """Insert a prompt's page chain. ``kv_pages[j]`` holds tokens
        ``[j*R, (j+1)*R)`` (None entries for pure-SSM); the last entry may
        be a partial tail of ``tail_rows`` rows. The trie increfs every KV
        page it stores (it is a sharer). Pre-existing edges keep their
        pages (first writer wins: identical content by determinism).
        Returns (pages newly referenced, whether the tail/state landed)."""
        r = self.page_rows
        now = self._tick()
        node, i, j, newly = self.root, 0, 0, 0
        while i + r <= len(tokens):
            key = tuple(tokens[i:i + r])
            ent = node.children.get(key)
            if ent is None:
                pid = kv_pages[j] if kv_pages else None
                if pid is not None:
                    pool.incref(pid)
                    newly += 1
                ent = _Entry(key, pid, None, _Node())
                node.children[key] = ent
                self.n_entries += 1
            ent.last_used = now
            is_last = i + r == len(tokens)
            if is_last and state_page is not None and ent.state_page is None:
                ent.state_page = state_page
                state_page = None         # consumed
            node, i, j = ent.child, i + r, j + 1
        rem = tuple(tokens[i:])
        if rem:
            for ent in node.partials:
                if tuple(ent.tokens) == rem:
                    ent.last_used = now
                    if state_page is not None and ent.state_page is None:
                        ent.state_page = state_page
                        state_page = None
                    return newly, state_page is None
            pid = kv_pages[j] if kv_pages and j < len(kv_pages) else None
            if pid is not None:
                pool.incref(pid)
                newly += 1
            ent = _Entry(rem, pid, state_page, None)
            ent.last_used = now
            node.partials.append(ent)
            self.n_entries += 1
            state_page = None
        return newly, state_page is None

    # -- eviction ----------------------------------------------------------

    def _leaves(self):
        """(parent-node, key-or-None, entry) for every evictable entry: a
        full-page edge whose subtree is empty, or any partial tail."""
        out = []

        def walk(node):
            for key, ent in node.children.items():
                if ent.child.children or ent.child.partials:
                    walk(ent.child)
                else:
                    out.append((node, key, ent))
            for ent in node.partials:
                out.append((node, None, ent))

        walk(self.root)
        return out

    def evict(self, pool, state_pool, *, need_kv: int = 0,
              need_state: int = 0, protect=()) -> tuple[int, int]:
        """Drop LRU leaves until ``need_kv`` KV pages / ``need_state``
        snapshot pages came back to their free lists (a decref only frees
        at refcount 0: pages a live slot still maps are merely un-shared).
        ``protect`` entries (ids) are skipped: an admission must not evict
        the prefix it just matched. Returns pages freed."""
        freed_kv = freed_state = 0
        sess = _obs.ACTIVE
        while freed_kv < need_kv or freed_state < need_state:
            leaves = [(n, k, e) for n, k, e in self._leaves()
                      if id(e) not in protect]
            if not leaves:
                break
            node, key, ent = min(leaves, key=lambda t: t[2].last_used)
            if key is None:
                node.partials.remove(ent)
            else:
                del node.children[key]
            self.n_entries -= 1
            if ent.kv_page is not None and pool.decref(ent.kv_page):
                freed_kv += 1
            if ent.state_page is not None and \
                    state_pool.decref(ent.state_page):
                freed_state += 1
            if sess is not None:
                sess.emit("kv_evict", tokens=len(ent.tokens),
                          kv_page=ent.kv_page, state_page=ent.state_page)
        return freed_kv, freed_state


# ---------------------------------------------------------------------------
# manager


@dataclasses.dataclass
class _SlotRec:
    uid: int
    prompt: tuple
    budget: int
    start: int                       # shared tokens skipped at admission
    pos: int                         # device-side absolute position
    reserved: int                    # worst-case pages not yet allocated
    load_state: int = -1             # snapshot to load at the reset tick
    pending_capture: bool = False    # snapshot state-after-prompt next tick
    prefilled: bool = False


class PagedKVManager:
    """Host-side authority for one engine's paged caches: block tables,
    reservations, lazy allocation, CoW planning, trie registration."""

    def __init__(self, *, slots: int, page_rows: int, maxpages: int,
                 pool_pages: int, family: str, state_pages: int = 0,
                 sharing: bool = True):
        validate_page_rows(page_rows)
        self.slots = slots
        self.page_rows = page_rows
        self.maxpages = maxpages
        self.family = family
        self.has_kv = family in KV_FAMILIES
        self.has_state = family in STATE_FAMILIES
        self.sharing = sharing
        self.kv = PagePool(pool_pages) if self.has_kv else None
        self.state = (PagePool(state_pages, defer_free=True)
                      if self.has_state and state_pages > 0 else None)
        self.trie = PrefixTrie(page_rows)
        self.tables = np.full((slots, maxpages), -1, np.int32)
        self._reset_pos = np.zeros(slots, np.int32)
        self._recs: list[_SlotRec | None] = [None] * slots
        self._outstanding = 0            # sum of live reservations
        self.stats_counters = {"cow_copies": 0, "defers": 0, "allocs": 0,
                               "evictions": 0, "shared_tokens": 0,
                               "snapshots": 0}

    # -- admission ---------------------------------------------------------

    def _pages_needed(self, plen: int, budget: int, shared_len: int) -> int:
        """Worst-case NEW pages a request can touch: every page up to its
        last written position, minus full shared pages it never rewrites,
        unless it wraps the table, where every entry gets recycled (and
        shared entries CoW), so the bound is the whole table."""
        end = -(-(plen + budget) // self.page_rows)     # ceil
        if end > self.maxpages:
            return self.maxpages
        return max(0, end - shared_len // self.page_rows)

    def admit(self, slot: int, prompt, budget: int, *,
              uid: int = -1) -> int | None:
        """Try to admit a request into ``slot``. On success maps shared
        prefix pages into the block table, reserves worst-case new pages,
        and returns the start position (shared tokens to skip). Returns
        None when the pool cannot guarantee the reservation even after
        eviction: the engine defers the admission (back-pressure)."""
        assert self._recs[slot] is None, f"slot {slot} busy"
        tok = tuple(int(t) for t in prompt)
        plen = len(tok)
        m = Match()
        if self.sharing and plen > 1:
            m = self.trie.match(tok, need_state=self.has_state,
                                max_len=plen - 1)
        needed = 0
        if self.has_kv:
            needed = self._pages_needed(plen, budget, m.length)
            headroom = self.kv.free_count - self._outstanding
            if needed > headroom:
                protect = {id(e) for e in self._match_entries(m)}
                self.trie.evict(self.kv, self.state or _NULL_POOL,
                                need_kv=needed - headroom, protect=protect)
                self.stats_counters["evictions"] += 1
                headroom = self.kv.free_count - self._outstanding
            if needed > headroom:
                self.stats_counters["defers"] += 1
                sess = _obs.ACTIVE
                if sess is not None:
                    sess.emit("kv_defer", uid=uid, slot=slot,
                              needed=needed, free=self.kv.free_count,
                              outstanding=self._outstanding)
                    sess.counter("repro_kvpool_defer_total",
                                 "admissions deferred on pool pressure"
                                 ).inc()
                return None
            for idx, (pid, _rows) in enumerate(m.kv_pages):
                self.kv.incref(pid)
                self.tables[slot, idx] = pid
            self._outstanding += needed
        self._recs[slot] = _SlotRec(
            uid=uid, prompt=tok, budget=budget, start=m.length,
            pos=m.length, reserved=needed,
            load_state=(m.state_page if m.state_page is not None else -1))
        self._reset_pos[slot] = m.length
        self.stats_counters["shared_tokens"] += m.length
        return m.length

    def _match_entries(self, m: Match):
        """Entries whose pages a Match maps (eviction protection): during
        admit's evict the matched pages are still at trie-only refcount, so
        walk the trie for the entries holding them."""
        pids = {pid for pid, _ in m.kv_pages}
        if m.state_page is not None:
            pids.add(("s", m.state_page))
        out = []

        def walk(node):
            for ent in list(node.children.values()) + node.partials:
                if ent.kv_page in pids or ("s", ent.state_page) in pids:
                    out.append(ent)
                if ent.child is not None:
                    walk(ent.child)

        if pids:
            walk(self.trie.root)
        return out

    # -- per-tick planning -------------------------------------------------

    def _alloc_kv(self, rec: _SlotRec, slot: int, why: str) -> int:
        pid = self.kv.alloc()
        if pid is None:
            self.trie.evict(self.kv, self.state or _NULL_POOL, need_kv=1)
            pid = self.kv.alloc()
        if pid is None:
            raise RuntimeError(
                "KV page pool exhausted despite reservations: "
                f"pool_pages={self.kv.n_pages} cannot cover the active "
                f"slots (raise ServeConfig.pool_pages; {why} page of slot "
                f"{slot})")
        if rec.reserved > 0:
            rec.reserved -= 1
            self._outstanding -= 1
        self.stats_counters["allocs"] += 1
        sess = _obs.ACTIVE
        if sess is not None:
            sess.emit("kv_alloc", slot=slot, uid=rec.uid, page=pid,
                      why=why)
        return pid

    def plan_tick(self, takes: dict[int, int]) -> dict[str, np.ndarray]:
        """Plan one block step: lazily allocate the pages each slot's
        ``take`` tokens will write, CoW any shared page about to be
        written, and schedule SSM snapshot captures/loads. Returns the
        page-table inputs of the paged block step."""
        out: dict[str, np.ndarray] = {
            "reset_pos": self._reset_pos.copy()}
        r, mp = self.page_rows, self.maxpages
        sess = _obs.ACTIVE
        if self.has_kv:
            copy = np.arange(self.kv.n_pages, dtype=np.int32)
            for slot, take in takes.items():
                rec = self._recs[slot]
                if rec is None or take <= 0:
                    continue
                first, last = rec.pos, rec.pos + take - 1
                for lp in range(first // r, last // r + 1):
                    li = lp % mp
                    pid = int(self.tables[slot, li])
                    if pid < 0:
                        self.tables[slot, li] = self._alloc_kv(
                            rec, slot, "new")
                    elif self.kv.refcount(pid) > 1:
                        # first divergent write into a shared page:
                        # copy-on-write, sharers keep the original
                        new = self._alloc_kv(rec, slot, "cow")
                        copy[new] = pid
                        self.kv.decref(pid)
                        self.tables[slot, li] = new
                        self.stats_counters["cow_copies"] += 1
                        if sess is not None:
                            sess.emit("kv_cow", slot=slot, uid=rec.uid,
                                      src=pid, dst=new)
                            sess.counter(
                                "repro_kvpool_cow_total",
                                "copy-on-write page copies").inc()
                    # else: sole owner, append/ring-overwrite in place
            out["tables"] = np.maximum(self.tables, 0)
            out["kv_copy"] = copy
        if self.has_state:
            save = np.full(self.slots, -1, np.int32)
            load = np.full(self.slots, -1, np.int32)
            for slot in takes:
                rec = self._recs[slot]
                if rec is None:
                    continue
                if rec.load_state >= 0:
                    load[slot] = rec.load_state   # consumed at reset tick
                    rec.load_state = -1
                if rec.pending_capture:
                    rec.pending_capture = False
                    if rec.pos == len(rec.prompt):  # device state is
                        sp = self._capture(rec, slot)  # state-after-prompt
                        if sp is not None:
                            save[slot] = sp
            out["snap_save"] = save
            out["snap_load"] = load
        return out

    def _capture(self, rec: _SlotRec, slot: int) -> int | None:
        """Allocate a snapshot page and register the prompt (KV chain +
        state) in the trie. None = skipped (dup / no room / wrapped)."""
        if not self.sharing or self.state is None:
            return None
        plen = len(rec.prompt)
        if plen > self.maxpages * self.page_rows:
            return None                   # prompt itself wrapped the table
        if self.trie.has_state_at(rec.prompt):
            return None                   # first writer already landed
        if self.has_kv and self.kv.free_count - self._outstanding < 1:
            return None   # registering the tail makes the owner's next
            #               append CoW it; without headroom, skip
        sp = self.state.alloc()
        if sp is None:
            self.trie.evict(self.kv or _NULL_POOL, self.state,
                            need_state=1)
            sp = self.state.alloc()
        if sp is None:
            return None
        kv_pages = None
        tail = plen % self.page_rows or self.page_rows
        if self.has_kv:
            n_pg = -(-plen // self.page_rows)
            kv_pages = [int(self.tables[slot, j % self.maxpages])
                        for j in range(n_pg)]
        _, landed = self.trie.register(rec.prompt, kv_pages, sp, self.kv,
                                       tail_rows=tail)
        if not landed:                    # raced a dup: return the page
            self.state.decref(sp)
            return None
        if self.has_kv and plen % self.page_rows:
            rec.reserved += 1             # owner CoWs its tail next write
            self._outstanding += 1
        self.stats_counters["snapshots"] += 1
        return sp

    # -- bookkeeping -------------------------------------------------------

    def advance(self, slot: int, consumed: int) -> None:
        rec = self._recs[slot]
        if rec is not None:
            rec.pos += consumed

    def mark_prefilled(self, slot: int) -> None:
        """Engine callback when a slot's prompt is fully consumed (end of
        the tick): attention-only families register the prompt's pages
        now; stateful families schedule a snapshot capture for the next
        tick (device state then equals state-after-prompt)."""
        rec = self._recs[slot]
        if rec is None or rec.prefilled or not self.sharing:
            return
        rec.prefilled = True
        if self.has_state:
            rec.pending_capture = True    # registration rides the capture
            return
        plen = len(rec.prompt)
        if plen < 2 or plen > self.maxpages * self.page_rows:
            return
        tail = plen % self.page_rows
        if tail and self.kv.free_count - self._outstanding < 1:
            # registering the partial tail forces the owner to CoW it on
            # its next append; without headroom register full pages only
            full = plen - tail
            if full:
                pages = [int(self.tables[slot, j % self.maxpages])
                         for j in range(full // self.page_rows)]
                self.trie.register(rec.prompt[:full], pages, None, self.kv,
                                   tail_rows=self.page_rows)
            return
        n_pg = -(-plen // self.page_rows)
        pages = [int(self.tables[slot, j % self.maxpages])
                 for j in range(n_pg)]
        self.trie.register(rec.prompt, pages, None, self.kv,
                           tail_rows=tail or self.page_rows)
        if tail:
            rec.reserved += 1
            self._outstanding += 1

    def release(self, slot: int) -> None:
        """Slot finished: return its block-table references (pages the
        trie still shares stay alive) and drop the unused reservation."""
        rec = self._recs[slot]
        if rec is None:
            return
        if self.has_kv:
            for li in range(self.maxpages):
                pid = int(self.tables[slot, li])
                if pid >= 0:
                    self.kv.decref(pid)
            self.tables[slot, :] = -1
        self._outstanding -= rec.reserved
        self._recs[slot] = None

    def end_tick(self) -> None:
        """Post-step hook: limbo snapshot pages become allocatable (no
        in-flight read can target them any more)."""
        if self.state is not None:
            self.state.flush()

    def stats(self) -> dict[str, Any]:
        out = dict(self.stats_counters)
        out["trie_entries"] = self.trie.n_entries
        if self.kv is not None:
            out.update(
                pages_total=self.kv.n_pages, pages_in_use=self.kv.in_use,
                pages_free=self.kv.free_count,
                pages_shared=self.kv.shared_count(),
                peak_pages_in_use=self.kv.peak_in_use,
                share_ratio=round(
                    self.kv.shared_count() / max(self.kv.in_use, 1), 4))
        if self.state is not None:
            out.update(state_pages_total=self.state.n_pages,
                       state_pages_in_use=self.state.in_use,
                       peak_state_pages_in_use=self.state.peak_in_use)
        return out

    def emit_gauges(self) -> None:
        sess = _obs.ACTIVE
        if sess is None or self.kv is None:
            return
        g = sess.gauge("repro_kvpool_pages", "KV pool pages by state")
        g.set(self.kv.in_use, state="in_use")
        g.set(self.kv.free_count, state="free")
        g.set(self.kv.shared_count(), state="shared")
        sess.gauge("repro_kvpool_share_ratio",
                   "shared / in-use KV pages").set(
            self.kv.shared_count() / max(self.kv.in_use, 1))
        sess.gauge("repro_kvpool_cow_copies",
                   "cumulative copy-on-write page copies").set(
            self.stats_counters["cow_copies"])
        sess.gauge("repro_kvpool_peak_pages_in_use",
                   "high-water mark of KV pages in use").set(
            self.kv.peak_in_use)


class _NullPool:
    """Stand-in for an absent pool so trie eviction can decref blindly."""

    def decref(self, pid):
        return False


_NULL_POOL = _NullPool()

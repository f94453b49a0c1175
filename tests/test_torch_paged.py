"""Parity of the PyTorch port's paged KV pool with the JAX package.

The host manager (``repro_torch.serving.kvpool``, numpy) against the
reference's ``repro.serving.kvpool``: its unit tests (``tests/
test_kvpool.py``) ported one for one, then one admit / plan / advance /
release sequence through both managers with identical tables, copy plans,
snapshot plans and stats. The paged block step (``lm_decode_block_paged``)
against the reference's on mamba2 SMOKE and llama SMOKE in f32 with the
reference's weights carried over by ``params_from_numpy``: logits and every
cache tensor within 1e-5 of the largest absolute value. The paged engine
against the port's ring engine and the reference's paged engine: tokens,
trace and pool counters (``tests/test_serving.py``'s paged tests, ported).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as jllama
from repro.configs import mamba2_1_3b as jmamba
from repro.kernels import layout as jlayout
from repro.models import build as jbuild
from repro.models.common import init_params
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import kvpool as jkvpool
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import mamba2_1_3b as tmamba
from repro_torch.kernels import layout as tlayout
from repro_torch.launch import serve as tserve
from repro_torch.models import build_lm
from repro_torch.models.common import params_from_numpy
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.kvpool import (
    PagedKVManager,
    PagePool,
    PrefixTrie,
    cow_pairs,
    validate_page_rows,
)

R = tlayout.KV_PAGE_ROWS
TOL = 1e-5          # of the largest absolute value, f32 on both sides
ARCHS = {"llama": (jllama, tllama), "mamba": (jmamba, tmamba)}
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# geometry


def test_page_rows_come_from_layout():
    """KV_PAGE_ROWS lives in kernels/layout.py, keeps the reference's value
    and passes its own validator: a power-of-two multiple of
    KV_PAGE_ROW_MULTIPLE, the reference's sublane tile."""
    assert R == jlayout.KV_PAGE_ROWS
    assert tlayout.KV_PAGE_ROW_MULTIPLE == jlayout.SUBLANES
    assert validate_page_rows(R) == R
    assert R % tlayout.KV_PAGE_ROW_MULTIPLE == 0
    m = tlayout.KV_PAGE_ROW_MULTIPLE
    for bad in (0, m - 1, m * 3, m + 1):
        with pytest.raises(ValueError, match="power-of-two"):
            validate_page_rows(bad)


# ---------------------------------------------------------------------------
# page pool


def test_pool_alloc_free_refcount():
    pool = PagePool(3)
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (0, 1)               # deterministic: page 0 first
    assert pool.in_use == 2 and pool.free_count == 1
    pool.incref(a)
    assert pool.refcount(a) == 2 and pool.shared_count() == 1
    assert not pool.decref(a)             # still referenced
    assert pool.decref(a)                 # now free again
    assert pool.free_count == 2
    c, d = pool.alloc(), pool.alloc()
    assert c is not None and d is not None
    assert pool.alloc() is None           # exhausted -> None, not raise
    assert pool.peak_in_use == 3
    pool.decref(b)
    with pytest.raises(AssertionError):
        pool.decref(b)                    # double free is a bug


def test_pool_defer_free_limbo():
    """defer_free pools park freed pages in limbo until flush(): a snapshot
    freed this tick may still be read by this tick's block step, so its
    page must not be reallocated before end_tick."""
    pool = PagePool(1, defer_free=True)
    a = pool.alloc()
    assert pool.decref(a)
    assert pool.alloc() is None           # in limbo, not allocatable
    pool.flush()
    assert pool.alloc() == a


# ---------------------------------------------------------------------------
# prefix trie


def _toks(n, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(int(t) for t in rng.integers(3, 250, size=n))


def test_trie_match_register_full_and_partial():
    pool = PagePool(8)
    trie = PrefixTrie(R)
    prompt = _toks(2 * R + 3)
    pages = [pool.alloc() for _ in range(3)]
    trie.register(prompt, pages, None, pool, tail_rows=3)
    # the trie increfs what it stores: owner release must not free them
    assert all(pool.refcount(p) == 2 for p in pages)

    # identical prompt, capped at plen-1: both full pages + a 2-row lcp of
    # the partial tail
    m = trie.match(prompt, need_state=False, max_len=len(prompt) - 1)
    assert m.length == 2 * R + 2
    assert m.kv_pages == [(pages[0], R), (pages[1], R), (pages[2], 2)]

    # divergence inside page 1: only page 0 shared (full pages are
    # all-or-nothing boundaries; sub-page runs only match on the tail)
    div = prompt[:R + 1] + (255,) + prompt[R + 2:]
    m = trie.match(div, need_state=False, max_len=len(div) - 1)
    assert m.length == R and m.kv_pages == [(pages[0], R)]

    # need_state: no snapshot registered anywhere -> no match at all
    m = trie.match(prompt, need_state=True, max_len=len(prompt) - 1)
    assert m.length == 0 and m.state_page is None


def test_trie_state_requires_exact_boundary():
    """A snapshot is valid only at exactly its capture length: sharers must
    extend the whole registered prompt, and a partial entry matches in full
    or not at all."""
    kv_pool, st_pool = PagePool(4), PagePool(2, defer_free=True)
    trie = PrefixTrie(R)
    prompt = _toks(R + 5)
    pages = [kv_pool.alloc(), kv_pool.alloc()]
    sp = st_pool.alloc()
    trie.register(prompt, pages, sp, kv_pool, tail_rows=5)
    assert trie.has_state_at(prompt)

    # extension of the whole prompt: state boundary at plen
    ext = prompt + _toks(4, seed=9)
    m = trie.match(ext, need_state=True, max_len=len(ext) - 1)
    assert m.length == len(prompt) and m.state_page == sp

    # diverging inside the partial tail: no full-entry match -> nothing
    div = prompt[:-1] + (255, 7)
    m = trie.match(div, need_state=True, max_len=len(div) - 1)
    assert m.length == 0
    # ... though attention-only matching still shares the lcp
    m = trie.match(div, need_state=False, max_len=len(div) - 1)
    assert m.length == R + 4


def test_trie_register_first_writer_wins():
    pool = PagePool(8)
    trie = PrefixTrie(R)
    prompt = _toks(R)
    a = pool.alloc()
    trie.register(prompt, [a], None, pool, tail_rows=R)
    b = pool.alloc()
    newly, _ = trie.register(prompt, [b], None, pool, tail_rows=R)
    assert newly == 0                     # duplicate: b not referenced
    assert pool.refcount(a) == 2 and pool.refcount(b) == 1
    m = trie.match(prompt + (9,), need_state=False, max_len=R)
    assert m.kv_pages == [(a, R)]


def test_trie_evict_lru_respects_protection():
    pool = PagePool(4)
    trie = PrefixTrie(R)
    old, new = _toks(R, seed=1), _toks(R, seed=2)
    p_old, p_new = pool.alloc(), pool.alloc()
    trie.register(old, [p_old], None, pool, tail_rows=R)
    trie.register(new, [p_new], None, pool, tail_rows=R)
    pool.decref(p_old), pool.decref(p_new)    # owners released
    # protect the LRU entry: eviction must take the newer one instead
    ent = trie.root.children[old]
    freed, _ = trie.evict(pool, PagePool(1), need_kv=1, protect={id(ent)})
    assert freed == 1
    assert old in trie.root.children          # protected entry survives
    assert new not in trie.root.children


def test_trie_evict_does_not_free_live_pages():
    """Eviction drops the trie entry but a page a live slot still maps is
    merely un-shared, never returned to the free list."""
    pool = PagePool(2)
    trie = PrefixTrie(R)
    p = pool.alloc()
    trie.register(_toks(R), [p], None, pool, tail_rows=R)   # trie: rc 2
    freed, _ = trie.evict(pool, PagePool(1), need_kv=1)
    assert freed == 0 and trie.n_entries == 0
    assert pool.refcount(p) == 1              # the "slot" still owns it


# ---------------------------------------------------------------------------
# manager


def _mgr(pool_pages=8, maxpages=4, slots=2, **kw):
    return PagedKVManager(slots=slots, page_rows=R, maxpages=maxpages,
                          pool_pages=pool_pages, family="dense", **kw)


def test_manager_admit_reserves_and_allocates_lazily():
    mgr = _mgr()
    start = mgr.admit(0, _toks(R + 2), budget=4, uid=7)
    assert start == 0                     # empty trie: nothing shared
    assert mgr.kv.in_use == 0             # allocation is lazy
    assert mgr._outstanding == 2          # ceil((R+2+4)/R) pages reserved
    plan = mgr.plan_tick({0: R})          # first prefill chunk
    assert mgr.kv.in_use == 1 and mgr._outstanding == 1
    assert plan["tables"].shape == (2, 4)
    assert (plan["kv_copy"] == np.arange(8)).all()   # no CoW yet
    mgr.advance(0, R)
    mgr.plan_tick({0: 2})
    assert mgr.kv.in_use == 2 and mgr._outstanding == 0
    mgr.advance(0, 2)
    mgr.release(0)
    assert mgr.kv.in_use == 0 and mgr._outstanding == 0


def test_manager_defers_when_pool_cannot_cover():
    mgr = _mgr(pool_pages=3, maxpages=4)
    assert mgr.admit(0, _toks(R), budget=2 * R) is not None   # 3 pages
    assert mgr.admit(1, _toks(R, seed=5), budget=0) is None   # deferred
    assert mgr.stats()["defers"] == 1
    # the freed reservation makes the retry succeed
    mgr.release(0)
    assert mgr.admit(1, _toks(R, seed=5), budget=0) is not None


def test_manager_eviction_recycles_trie_pages():
    """Pages held only by the trie are evicted to cover a new admission;
    pages a live slot maps survive eviction."""
    mgr = _mgr(pool_pages=2, maxpages=2, slots=1)
    prompt = _toks(R)
    mgr.admit(0, prompt, budget=0)
    mgr.plan_tick({0: R})
    mgr.advance(0, R)
    mgr.mark_prefilled(0)                 # full page registered in trie
    mgr.release(0)
    assert mgr.kv.in_use == 1             # trie keeps the prompt page
    # a different prompt needing 2 pages: must evict the trie entry
    assert mgr.admit(0, _toks(R, seed=4), budget=R) is not None
    assert mgr.stats()["evictions"] == 1
    assert mgr.trie.n_entries == 0


def test_manager_shared_prefix_and_cow():
    """A sharer maps registered pages without new allocations; its first
    write into the shared partial-tail page triggers CoW with a device-copy
    entry, and the trie's original page stays intact."""
    mgr = _mgr(pool_pages=6, maxpages=4)
    prompt = _toks(R + 2)                 # full page + 2-row tail
    mgr.admit(0, prompt, budget=0, uid=0)
    mgr.plan_tick({0: R + 2})
    p0, p1 = int(mgr.tables[0, 0]), int(mgr.tables[0, 1])
    mgr.advance(0, R + 2)
    mgr.mark_prefilled(0)                 # registers page + partial tail
    mgr.release(0)
    assert mgr.kv.refcount(p0) == 1 and mgr.kv.refcount(p1) == 1

    # sharer extends the registered prompt: full page + 2-row tail map
    sharer = prompt + _toks(3, seed=8)
    start = mgr.admit(1, sharer, budget=2, uid=1)
    assert start == R + 2
    assert int(mgr.tables[1, 0]) == p0 and int(mgr.tables[1, 1]) == p1
    assert mgr.kv.refcount(p0) == 2       # trie + sharer
    assert mgr.stats()["shared_tokens"] == R + 2

    # the sharer's remaining prompt rows land in the tail page: CoW
    plan = mgr.plan_tick({1: len(sharer) - start})
    new = int(mgr.tables[1, 1])
    assert new != p1
    assert plan["kv_copy"][new] == p1     # device copies old -> new
    assert mgr.kv.refcount(p1) == 1       # trie keeps the original
    assert mgr.stats()["cow_copies"] == 1
    assert int(mgr.tables[1, 0]) == p0    # untouched page still shared
    mgr.release(1)
    assert mgr.kv.refcount(p0) == 1       # trie only: alive for reuse


def test_manager_exhaustion_raises_only_without_reservation():
    """The RuntimeError path is a genuine invariant breach (allocating past
    every reservation), not reachable through admit's deferral."""
    mgr = _mgr(pool_pages=1, maxpages=4, slots=1)
    rec_prompt = _toks(2)
    assert mgr.admit(0, rec_prompt, budget=1) is not None
    mgr.plan_tick({0: 2})
    # forge an out-of-contract allocation: no pages left, empty trie
    rec = mgr._recs[0]
    with pytest.raises(RuntimeError, match="pool_pages"):
        mgr._alloc_kv(rec, 0, "new")


def test_manager_wrap_reuses_table_entries():
    """Generation past maxpages*R ring-recycles the block table in place
    (sole owner): no extra pages, pos keeps counting."""
    mgr = _mgr(pool_pages=4, maxpages=2, slots=1)
    mgr.admit(0, _toks(4), budget=4 * R)  # wraps: reservation = maxpages
    assert mgr._outstanding == 2
    pos = 0
    for take in (4,) + (R,) * 3:
        mgr.plan_tick({0: take})
        mgr.advance(0, take)
        pos += take
    assert mgr.kv.in_use == 2             # table is full, recycled in place
    assert mgr._recs[0].pos == pos


# ---------------------------------------------------------------------------
# the manager against the reference's, one sequence through both


def drive_both(family: str, seed: int, *, slots=3, page_rows=8, maxpages=6,
               pool_pages=14, state_pages=3, chunk=5, n_req=14):
    """An engine-like loop over both managers on the same requests: prompts
    that share prefixes of whole and partial pages, extend earlier prompts,
    or stand alone; returns how many ticks planned each thing."""
    rng = np.random.default_rng(seed)
    kw = dict(slots=slots, page_rows=page_rows, maxpages=maxpages,
              pool_pages=pool_pages, family=family, state_pages=state_pages)
    ref, got = jkvpool.PagedKVManager(**kw), PagedKVManager(**kw)
    base = [tuple(int(t) for t in rng.integers(3, 60, 23)) for _ in range(2)]
    queue = []
    for uid in range(n_req):
        kind = rng.integers(3)
        if kind == 0 or not queue:        # a prefix of a base, a new tail
            b = base[rng.integers(2)][:int(rng.integers(4, 24))]
        else:                             # an earlier prompt, extended
            b = queue[int(rng.integers(len(queue)))][1]
        tail = tuple(int(t) for t in rng.integers(3, 60, rng.integers(1, 9)))
        queue.append((uid, b + tail, int(rng.integers(1, 12))))
    slot = [None] * slots
    seen = {"cow": 0, "save": 0, "load": 0, "defer": 0, "ticks": 0}
    while queue or any(slot):
        for i in range(slots):
            if slot[i] is not None or not queue:
                continue
            uid, prompt, budget = queue[0]
            a = ref.admit(i, np.array(prompt), budget, uid=uid)
            assert got.admit(i, np.array(prompt), budget, uid=uid) == a
            if a is None:
                seen["defer"] += 1
                break                     # head of line blocks
            queue.pop(0)
            slot[i] = [prompt, a, budget, 0]      # prompt, pos, budget, made
        takes = {}
        for i, s in enumerate(slot):
            if s is not None:
                takes[i] = (min(chunk, len(s[0]) - s[1])
                            if s[1] < len(s[0]) else 1)
        if not takes:
            break
        pa, pb = ref.plan_tick(takes), got.plan_tick(takes)
        assert pa.keys() == pb.keys()
        for k in pa:
            np.testing.assert_array_equal(pb[k], pa[k], err_msg=k)
        np.testing.assert_array_equal(got.tables, ref.tables)
        if "kv_copy" in pa:
            seen["cow"] += int((pa["kv_copy"] != np.arange(
                pool_pages)).any())
        if "snap_save" in pa:
            seen["save"] += int((pa["snap_save"] >= 0).any())
            seen["load"] += int((pa["snap_load"] >= 0).any())
        for i, take in takes.items():
            s = slot[i]
            for m in (ref, got):
                m.advance(i, take)
            if s[1] < len(s[0]):
                s[1] += take
                if s[1] >= len(s[0]):
                    for m in (ref, got):
                        m.mark_prefilled(i)
                    s[3] += 1             # the prompt's first token
            else:
                s[1] += take
                s[3] += 1
            if s[3] >= s[2]:
                for m in (ref, got):
                    m.release(i)
                slot[i] = None
        for m in (ref, got):
            m.end_tick()
        assert got.stats() == ref.stats()
        seen["ticks"] += 1
    assert got.stats() == ref.stats()
    return seen


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_manager_sequence_matches_reference(family, seed):
    """Tables, copy plans, snapshot saves and loads, and every counter of
    ``stats()`` identical to the reference's manager, tick by tick."""
    seen = drive_both(family, seed)
    assert seen["ticks"] > 10
    if family == "dense":
        assert seen["cow"] > 0
    else:
        assert seen["save"] > 0 and seen["load"] > 0


def test_manager_sequence_under_pool_pressure_matches_reference():
    """The same on a pool too small for every slot at once: admissions
    defer and the trie evicts, identically on both sides."""
    seen = drive_both("dense", 7, pool_pages=7, maxpages=4)
    assert seen["defer"] > 0


def test_cow_pairs_cover_the_plan():
    """The fixed pairs the paged step takes apply the plan's copies, and
    their padding repeats a real pair (or copies page 0 onto itself)."""
    plan = np.arange(9, dtype=np.int32)
    src, dst = cow_pairs(plan, 4)
    assert (src == 0).all() and (dst == 0).all()
    plan[5], plan[2] = 7, 1
    src, dst = cow_pairs(plan, 4)
    assert list(zip(src, dst)) == [(1, 2), (7, 5), (1, 2), (1, 2)]
    pool = np.arange(9.0)[:, None] * np.ones((1, 3))
    pool[dst] = pool[src]
    np.testing.assert_array_equal(pool[:, 0], np.arange(9.0)[plan])
    with pytest.raises(ValueError, match="copy-on-write"):
        cow_pairs(plan, 1)


# ---------------------------------------------------------------------------
# the paged block step


def reference(jmod, **overrides):
    cfg = dataclasses.replace(jmod.SMOKE, policy="fused", **overrides)
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    return bundle, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def weights():
    """The reference's bundle, params and numpy params, per arch."""
    return {name: reference(jmod) for name, (jmod, _) in ARCHS.items()}


def port(np_params, tmod, policy=None, **overrides):
    cfg = dataclasses.replace(tmod.SMOKE, policy=policy, **overrides)
    return build_lm(cfg), params_from_numpy(np_params, cfg, device="cpu")


def close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def shapes(tree):
    """(shape, dtype name) of every PSpec of either package."""
    def leaf(ps):
        if ps.dtype is None:
            return tuple(ps.shape), None
        if isinstance(ps.dtype, torch.dtype):
            return tuple(ps.shape), str(ps.dtype).split(".")[-1]
        return tuple(ps.shape), np.dtype(ps.dtype).name

    return jax.tree.map(leaf, tree, is_leaf=lambda x: hasattr(x, "shape"))


@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_paged_cache_pspec_matches_reference(arch):
    jmod, tmod = ARCHS[arch]
    kw = dict(per_slot_pos=True, kind="paged", pool_pages=7, page_rows=8,
              state_pages=5)
    want = shapes(jbuild(jmod.SMOKE).cache_pspec(3, 32, **kw))
    got = shapes(build_lm(tmod.SMOKE).cache_pspec(3, 32, **kw))
    assert got == want
    with pytest.raises(ValueError, match="continuous"):
        build_lm(tmod.SMOKE).cache_pspec(3, 32, kind="paged", pool_pages=7,
                                         page_rows=8, state_pages=5)


def paged_cache(jb, rng, b, mp, r, pages, state_pages):
    """A random paged cache of the reference's layout, as numpy."""
    return jax.tree.map(
        lambda a: (np.array([0, 5, 6, 17], np.int32)[:b]
                   if np.asarray(a).dtype == np.int32 else
                   rng.standard_normal(np.asarray(a).shape).astype(
                       np.float32)),
        init_params(jax.random.PRNGKey(0), jb.cache_pspec(
            b, mp * r, per_slot_pos=True, kind="paged", pool_pages=pages,
            page_rows=r, state_pages=state_pages), jnp.float32))


@pytest.mark.parametrize("policy", [None, "fused"])
@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_decode_block_paged_matches_reference(weights, arch, policy):
    """Two chained steps (T = 4, then T = 1) on a random pool of 4-row
    pages: slots that consume 0, 1, 3 and T tokens, one reset onto a shared
    start position, positions that wrap the table of 4 pages, a
    copy-on-write page, and for mamba snapshot saves and a load; the logits
    of the valid slots and every cache tensor."""
    jb, jp, npp = weights[arch]
    tb, tp = port(npp, ARCHS[arch][1], policy)
    rng = np.random.default_rng(7)
    b, mp, r, pages, n_snap = 4, 4, 4, 18, 3
    npc = paged_cache(jb, rng, b, mp, r, pages, n_snap)
    jc = jax.tree.map(jnp.asarray, npc)
    tc = jax.tree.map(lambda a: torch.from_numpy(a.copy()), npc)
    steps = ((4, [0, 1, 3, 4], [False, True, False, False],
              [-1, -1, 2, -1], [-1, 1, -1, -1]),
             (1, [1, 1, 0, 1], [False] * 4, [0, -1, -1, -1],
              [-1, -1, -1, -1]))
    for t_len, n_valid, reset, save, load in steps:
        tok = rng.integers(3, 256, (b, t_len)).astype(np.int32)
        nv, rs = np.array(n_valid, np.int32), np.array(reset)
        page = {"reset_pos": np.array([0, 2, 0, 0], np.int32)}
        tpage = dict(page)
        if tb.cfg.family == "dense":
            tables = rng.permutation(pages)[:b * mp].reshape(b, mp)
            copy = np.arange(pages, dtype=np.int32)
            copy[tables[2, 1]] = tables[0, 3]      # a page copied on write
            page.update(tables=tables.astype(np.int32), kv_copy=copy)
            src, dst = cow_pairs(copy, b * 2)
            tpage.update(tables=tables, kv_src=src, kv_dst=dst)
        else:
            page.update(snap_save=np.array(save, np.int32),
                        snap_load=np.array(load, np.int32))
            tpage.update(page)
        jl, jc = jb.decode_block_paged(
            jp, jc, {"tokens": jnp.asarray(tok)}, n_valid=jnp.asarray(nv),
            reset_mask=jnp.asarray(rs),
            page={k: jnp.asarray(v) for k, v in page.items()})
        tl, tc2 = tb.decode_block_paged(
            tp, tc, {"tokens": torch.from_numpy(tok)},
            n_valid=torch.from_numpy(nv), reset_mask=torch.from_numpy(rs),
            page={k: torch.from_numpy(np.asarray(v)) for k, v in
                  tpage.items()})
        assert tc2 is tc                 # updated in place
        live = nv > 0
        close(tl[torch.from_numpy(live)], np.asarray(jl)[live])
        for path, want in jax.tree_util.tree_leaves_with_path(jc):
            got = tc
            for key in path:
                got = got[key.key]
            if got.dtype == torch.int32:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                close(got, want)


def paged_engine(np_params, tmod, **cfg_kw):
    tb, tp = port(np_params, tmod)
    return ServingEngine(tb, tp, ServeConfig(cache_kind="paged", **cfg_kw))


@pytest.mark.parametrize("t_len", [4, 1])
@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_idle_paged_step_is_an_exact_no_op(weights, arch, t_len):
    """The step the CUDA graph's warm-up runs (every n_valid 0, no reset, an
    identity copy plan, no snapshot saved or loaded) leaves the KV pool, the
    live state, the snapshot pool and the positions exactly as they
    were."""
    eng = paged_engine(weights[arch][2], ARCHS[arch][1], slots=3,
                       page_rows=8)
    eng.queue.append(Request(uid=0, prompt=np.arange(5, 40)))
    eng._ensure_cache()
    gen = torch.Generator().manual_seed(0)
    leaves = [t for sub in eng._cache.values() if isinstance(sub, dict)
              for t in sub.values()]
    for t in leaves:
        t.normal_(generator=gen)
    eng._cache["pos"].copy_(torch.tensor([3, 21, 40]))
    before = [t.clone() for t in leaves]
    eng._block_step(eng._idle_inputs(t_len))
    for t, was in zip(leaves, before):
        assert torch.equal(t, was)
    assert eng._cache["pos"].tolist() == [3, 21, 40]


# ---------------------------------------------------------------------------
# the engine: the reference's paged tests (tests/test_serving.py), ported,
# each held against the port's ring engine and the reference's paged engine


def serve_three(ref, tmod, reqs, **cfg_kw):
    """The same requests through the reference's paged engine, the port's
    paged engine and the port's ring engine: (reference results, paged
    results, ring results, reference engine, paged engine)."""
    jb, jp, npp = ref
    jeng = JServingEngine(jb, jp, JServeConfig(
        scheduler="continuous", policy="fused", cache_kind="paged",
        **cfg_kw))
    want = jeng.run([JRequest(uid=u, prompt=p, max_new=m)
                     for u, p, m in reqs])
    tb, tp = port(npp, tmod)
    out = []
    for kind in ("paged", "ring"):
        kw = dict(cfg_kw)
        if kind == "ring":
            for k in ("pool_pages", "page_rows", "prefix_sharing"):
                kw.pop(k, None)
        eng = ServingEngine(tb, tp, ServeConfig(cache_kind=kind, **kw))
        out.append((eng.run([Request(uid=u, prompt=p, max_new=m)
                             for u, p, m in reqs]), eng))
    (paged, teng), (ring, _) = out
    return want, paged, ring, jeng, teng


def same_serving(want, paged, ring, jeng, teng):
    assert [r.tokens for r in paged] == [r.tokens for r in ring]
    assert [r.tokens for r in paged] == [r.tokens for r in want]
    assert teng.trace == jeng.trace
    assert teng.kv_stats() == jeng.kv_stats()


@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_paged_matches_ring_token_for_token(weights, arch):
    """cache_kind='paged' is a memory-layout change, not a model change:
    greedy tokens match the ring cache exactly for attention and SSM, with
    chunked prefill and more requests than slots so slots recycle; the
    pool's counters match the reference's paged engine."""
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(3, 256, size=plen, dtype=np.int32), 5)
            for i, plen in enumerate((5, 19, 11, 26, 8, 14))]
    out = serve_three(weights[arch], ARCHS[arch][1], reqs, slots=3,
                      max_new=5, eos_token=-1, prefill_chunk=6)
    same_serving(*out)
    kv = out[4].kv_stats()
    if arch == "llama":                   # pure-SSM: no KV pages at all
        assert kv["allocs"] > 0
    else:
        assert kv["snapshots"] > 0


def test_paged_wrap_beyond_capacity_matches_ring(weights):
    """Sliding-window wrap: for capacity S the paged gather row ``((p // R)
    % MP) * R + p % R`` equals ``p % S``, so the paged tokens equal the
    ring's, overwrite order included. The admission overflow warns once and
    is traced."""
    reqs = [(0, np.arange(5, 17, dtype=np.int32), 24)]
    with pytest.warns(UserWarning, match="sliding-window"):
        out = serve_three(weights["llama"], tllama, reqs, slots=1,
                          max_new=24, eos_token=-1, prefill_chunk=8,
                          max_context=16)
    same_serving(*out)
    assert [e for e in out[4].trace if e["event"] == "swa_degrade"]
    assert len(out[1][0].tokens) == 24


def test_paged_shared_prefix_shares_pages_and_matches_ring(weights):
    """A shared-prefix workload under the paged cache (a) gives exactly the
    ring cache's tokens, (b) maps prompt pages shared (shared_tokens > 0,
    CoW on divergence), and (c) peaks at fewer physical pages than n_req
    full contexts."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(3, 256, size=40, dtype=np.int32)
    reqs = [(i, np.concatenate([prefix, rng.integers(
        3, 256, size=4, dtype=np.int32)]), 4) for i in range(6)]
    out = serve_three(weights["llama"], tllama, reqs, slots=2, max_new=4,
                      eos_token=-1, prefill_chunk=8, max_context=64)
    same_serving(*out)
    eng = out[4]
    kv = eng.kv_stats()
    assert kv["shared_tokens"] > 0        # later slots mapped the prefix
    assert kv["cow_copies"] > 0           # divergent tails CoW'd
    full_ctx_pages = 6 * (eng._capacity // R)
    assert kv["peak_pages_in_use"] < full_ctx_pages
    # a shared slot starts at the shared length: the trace says where
    starts = [e["start"] for e in eng.trace if e["event"] == "admit"]
    assert max(starts) > 0


def test_paged_multi_turn_loads_snapshots_and_matches_ring(weights):
    """mamba: second turns that extend a first turn's whole prompt load its
    state snapshot and start after it; tokens equal the ring's and the
    reference's, and shared_tokens counts the first turns shared."""
    rng = np.random.default_rng(11)
    first = [rng.integers(3, 256, size=n, dtype=np.int32)
             for n in (13, 22, 9)]
    reqs = [(i, p, 3) for i, p in enumerate(first)]
    reqs += [(3 + i, np.concatenate([p, rng.integers(
        3, 256, size=5, dtype=np.int32)]), 3) for i, p in enumerate(first)]
    out = serve_three(weights["mamba"], tmamba, reqs, slots=3, max_new=3,
                      eos_token=-1, prefill_chunk=4)
    same_serving(*out)
    kv = out[4].kv_stats()
    assert 0 < kv["shared_tokens"] <= sum(len(p) for p in first)
    assert kv["snapshots"] >= len(first)
    starts = {e["uid"]: e["start"] for e in out[4].trace
              if e["event"] == "admit"}
    assert kv["shared_tokens"] == sum(starts.values())
    assert all(starts[3 + i] in (0, len(p)) for i, p in enumerate(first))


def test_paged_pool_exhaustion_defers_then_completes(weights):
    """A pool too small for every queued request at once back-pressures:
    admissions defer until releases free pages, every request still
    completes, and the tokens still match the ring cache."""
    rng = np.random.default_rng(7)
    reqs = [(i, rng.integers(3, 256, size=18, dtype=np.int32), 4)
            for i in range(4)]
    # 18 + 4 tokens -> 2 pages per request; 3 pages covers one slot plus
    # nothing to spare, so the second slot's admission must defer
    out = serve_three(weights["llama"], tllama, reqs, slots=2, max_new=4,
                      eos_token=-1, prefill_chunk=8, pool_pages=3,
                      prefix_sharing=False)
    same_serving(*out)
    assert len(out[1]) == 4               # nothing dropped
    assert out[4].kv_stats()["defers"] > 0


def test_paged_pool_too_small_raises(weights):
    """When even an empty engine cannot reserve one request's worst case,
    deferral would livelock: the engine raises with the knob to turn."""
    eng = paged_engine(weights["llama"][2], tllama, slots=1, max_new=8,
                       eos_token=-1, pool_pages=1)
    with pytest.raises(RuntimeError, match="pool_pages"):
        eng.run([Request(uid=0, prompt=np.arange(5, 45, dtype=np.int32))])


def test_paged_page_rows_validated(weights):
    eng = paged_engine(weights["llama"][2], tllama, slots=1, max_new=2,
                       eos_token=-1, page_rows=12)
    with pytest.raises(ValueError, match="power-of-two"):
        eng.run([Request(uid=0, prompt=np.arange(5, 10, dtype=np.int32))])
    with pytest.raises(ValueError, match="cache_kind"):
        ServeConfig(slots=1, max_new=2, cache_kind="flat")
    with pytest.raises(ValueError, match="continuous"):
        ServeConfig(cache_kind="paged", scheduler="wave")


# ---------------------------------------------------------------------------
# the launcher


def test_serve_cli_paged_open_loop(capsys):
    """``--cache paged --pool-pages --page-rows --arrival-rate``: the paged
    pool's line and the open-loop latency line, as the reference prints
    them."""
    tserve.main(["--arch", "llama3.2-1b", "--config", "smoke", "--device",
                 "cpu", "--requests", "4", "--max-new", "3", "--prompt-len",
                 "40", "--cache", "paged", "--pool-pages", "40",
                 "--page-rows", "8", "--arrival-rate", "200"])
    out = capsys.readouterr().out
    assert "4 requests" in out and "scheduler=continuous" in out
    assert "paged KV pool: peak" in out and "/40 pages" in out
    assert "open loop @ 200.0 req/s: token latency p50=" in out


def test_make_requests_draws_arrivals_like_the_reference_launcher():
    """With an arrival rate each request draws its exponential gap before
    its prompt, from the one generator, as the reference's launcher does."""
    reqs = tserve.make_requests(5, 32, 256, seed=3, arrival_rate=4.0)
    rng = np.random.default_rng(3)
    arrival = 0.0
    for r in reqs:
        arrival += float(rng.exponential(1.0 / 4.0))
        want = rng.integers(3, 256, size=rng.integers(4, 33), dtype=np.int32)
        np.testing.assert_array_equal(r.prompt, want)
        assert r.arrival_s == arrival
    assert reqs[-1].arrival_s > reqs[0].arrival_s > 0


def test_paged_modules_and_scripts_import_neither_jax_nor_repro():
    """The paged pool's modules load without JAX, and no module of the port
    nor the card scripts import JAX or the JAX package."""
    code = ("import sys\n"
            "import repro_torch.serving.kvpool, repro_torch.serving.engine\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
    paths = [*(ROOT / "src" / "repro_torch").rglob("*.py"),
             ROOT / "chip_smoke.py", ROOT / "time_ssd.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0].rstrip(",")
                assert top not in ("jax", "jaxlib", "repro"), (path, line)

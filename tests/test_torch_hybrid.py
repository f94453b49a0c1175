"""Parity of the PyTorch port's hybrid (zamba2) and vlm (internvl2)
families with the JAX package.

The reference's weights (``init_params(PRNGKey(0))`` at each SMOKE config,
f32) go into the port through ``params_from_numpy``; the inputs are made
from numpy seeds. The reference runs under ``policy="fused"``, the port on
its default path (on a CPU tensor each kernel's plain version) and where
stated on ``fused`` and ``baseline`` too. Tolerances, of the largest
absolute value of the reference's tensor (``close``):

* zamba2 SMOKE (4 Mamba layers, the shared block after layers 2 and 4):
  ``lm_apply`` logits and the collected cache, and three decode steps from
  it, 1e-5; the ring block step (``lm_decode_block``) and the paged one
  (``lm_decode_block_paged``: block tables, a copy-on-write page, snapshot
  saves and a load in one plan), logits and every cache tensor, 1e-5; the
  continuous engine's greedy tokens, its admit/finish trace and the paged
  pool's ``kv_stats()`` equal to the reference engine's; ``lm_loss`` rtol
  1e-5 and every gradient leaf, the shared block's included, rtol 1e-4,
  atol 1e-6, under each remat policy (as ``test_torch_training.py``);
* internvl2 SMOKE (the stub prefix of 8 x 32): ``lm_apply`` with a stub,
  its cache and three decode steps, 1e-5; ``lm_loss`` over the text tail
  and its gradients as above; the continuous engine's text-only tokens
  equal to the reference's; the wave engine refuses a request without a
  stub (the reference fails on the missing key, the port raises a
  ``ValueError`` naming it, before any launch).
"""
from __future__ import annotations

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import internvl2_76b as jvlm
from repro.configs import zamba2_2_7b as jzamba
from repro.configs.common import smoke_batch
from repro.models import build as jbuild
from repro.models import lm as jlm
from repro.models.common import count_pspec_params, init_params
from repro.optim import OptConfig as JOptConfig
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import _pad_cache_seq
from repro.training import init_train_state as jinit_train_state
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import internvl2_76b as tvlm
from repro_torch.configs import zamba2_2_7b as tzamba
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import build_lm
from repro_torch.models import lm as tlm
from repro_torch.models.common import (
    params_from_numpy,
    params_to_numpy,
    tree_from_numpy,
)
from repro_torch.optim import OptConfig
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.kvpool import cow_pairs
from repro_torch.training import init_train_state, make_train_step

ARCHS = {"zamba2": (jzamba, tzamba), "internvl2": (jvlm, tvlm)}
TOL = 1e-5          # of the largest absolute value, f32 on both sides
PORT_PATHS = ("tile", "fused", "baseline")


def t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def reference(arch, **overrides):
    """The reference's SMOKE bundle, params and numpy params (f32)."""
    cfg = dataclasses.replace(ARCHS[arch][0].SMOKE, policy="fused",
                              **overrides)
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    return bundle, params, jax.tree.map(np.asarray, params)


def port(arch, policy=None, **overrides):
    cfg = dataclasses.replace(ARCHS[arch][1].SMOKE, policy=policy,
                              **overrides)
    return build_lm(cfg), params_from_numpy(reference(arch)[2], cfg,
                                            device="cpu")


def close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def assert_cache_close(tc, jc):
    """Every tensor of the port's cache against the reference's, by key;
    int32 positions exactly."""
    for path, want in jax.tree_util.tree_leaves_with_path(jc):
        got = tc
        for key in path:
            got = got[key.key]
        if isinstance(got, int):
            assert got == int(want)
        elif got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            close(got, want)


# ---------------------------------------------------------------------------
# the forward, its cache and the wave decode


def stub_of(arch, b, seed=1):
    cfg = ARCHS[arch][1].SMOKE
    if not cfg.stub_tokens:
        return {}
    rng = np.random.default_rng(seed)
    return {"stub": rng.standard_normal(
        (b, cfg.stub_tokens, cfg.stub_dim)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def ref_model(arch):
    """The reference's prefill (logits, cache) of a (2, 24) batch (and a
    stub for the vlm), and three decode steps from its cache."""
    jb, params, _ = reference(arch)
    cfg = jb.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             **stub_of(arch, 2)}
    steps = rng.integers(0, cfg.vocab, (3, 2, 1)).astype(np.int32)
    logits, _, cache = jax.jit(lambda p, b: jlm.lm_apply(
        p, cfg, b, collect_cache=True))(params, batch)
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    decoded = []
    cache = _pad_cache_seq(cache, len(steps))
    decode = jax.jit(jb.decode)
    for tok in steps:
        lg, cache = decode(params, cache, {"tokens": tok})
        decoded.append(np.asarray(lg))
    return dict(batch=batch, steps=steps, prefill=prefill, decoded=decoded,
                final=jax.tree.map(np.asarray, cache))


@pytest.mark.parametrize("path", PORT_PATHS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_apply_cache_and_decode_match_jax(arch, path):
    """Logits and the collected cache of the forward (the vlm's over stub
    and tokens), then three decode steps from it: the logits and the final
    cache."""
    ref = ref_model(arch)
    bundle, params = port(arch, path)
    logits, aux, cache = tlm.lm_apply(
        params, bundle.cfg, {k: t(v).long() if k == "tokens" else t(v)
                             for k, v in ref["batch"].items()},
        collect_cache=True)
    want_logits, want_cache = ref["prefill"]
    close(logits, want_logits)
    assert aux.item() == 0.0
    assert_cache_close(cache, want_cache)
    cache = tlm.pad_cache_seq(cache, len(ref["steps"]))
    for tok, want in zip(ref["steps"], ref["decoded"]):
        lg, cache = bundle.decode(params, cache, {"tokens": t(tok).long()})
        close(lg, want)
    assert_cache_close(cache, ref["final"])


def test_hybrid_prefill_last_and_kv_layers():
    """``prefill_last`` gives the forward's last position; the hybrid's KV
    cache holds one layer a group, its Mamba cache every layer."""
    bundle, params = port("zamba2")
    cfg = bundle.cfg
    tokens = t(ref_model("zamba2")["batch"]["tokens"]).long()
    full, _, _ = tlm.lm_apply(params, cfg, {"tokens": tokens})
    last, cache = bundle.prefill_last(params, {"tokens": tokens})
    torch.testing.assert_close(last, full[:, -1:], rtol=0, atol=1e-6)
    assert tlm.n_groups(cfg) == cfg.n_layers // cfg.shared_attn_every == 2
    assert cache["attn"]["k"].shape[0] == tlm.n_groups(cfg)
    assert cache["mamba"]["state"].shape[0] == cfg.n_layers


def test_hybrid_decode_consistent_with_full_forward():
    """The reference's ``test_decode_consistent_with_full_forward``: the
    logits of a decode step from the prefill's cache equal the forward's
    at that position (the shared block's KV and the Mamba state carried
    across)."""
    bundle, params = port("zamba2")
    tokens = t(ref_model("zamba2")["batch"]["tokens"]).long()
    full, _, _ = tlm.lm_apply(params, bundle.cfg, {"tokens": tokens})
    _, cache = bundle.prefill_last(params, {"tokens": tokens[:, :-1]})
    cache = tlm.pad_cache_seq(cache, 1)
    lg, _ = bundle.decode(params, cache, {"tokens": tokens[:, -1:]})
    torch.testing.assert_close(lg[:, 0], full[:, -1], rtol=1e-5, atol=1e-5)


def test_hybrid_needs_whole_groups():
    cfg = dataclasses.replace(tzamba.SMOKE, n_layers=5)
    with pytest.raises(ValueError, match="shared_attn_every"):
        build_lm(cfg)


def test_vlm_without_stub_raises_before_any_launch():
    """The vlm's forward needs the stub prefix; the port names it before
    it embeds anything (the reference fails on the missing key)."""
    bundle, params = port("internvl2")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="stub"):
        bundle.prefill_last(params, {"tokens": tokens})
    jb, jp, _ = reference("internvl2")
    with pytest.raises(KeyError, match="stub"):
        jb.prefill_last(jp, {"tokens": np.zeros((1, 4), np.int32)})


# ---------------------------------------------------------------------------
# the block steps


def random_cache(jb, rng, b, smax, **kind):
    """A random continuous cache of the reference's layout, numpy."""
    return jax.tree.map(
        lambda a: (np.array([0, 5, 6, 17], np.int32)[:b]
                   if np.asarray(a).dtype == np.int32 else
                   rng.standard_normal(np.asarray(a).shape).astype(
                       np.float32)),
        init_params(jax.random.PRNGKey(0), jb.cache_pspec(
            b, smax, per_slot_pos=True, **kind), jnp.float32))


# two chained steps (T = 4, then T = 1): slots that consume 0, 1, 3 and T
# tokens, one reset (onto a shared start position on the paged pool),
# positions that wrap the ring or the page table; on the paged pool a
# copy-on-write page, snapshot saves and a load
STEPS = ((4, [0, 1, 3, 4], [False, True, False, False], [-1, -1, 2, -1],
          [-1, 1, -1, -1]),
         (1, [1, 1, 0, 1], [False] * 4, [0, -1, -1, -1], [-1, -1, -1, -1]))


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("policy", [None, "fused"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_block_matches_jax(arch, kind, policy):
    """The ring step on a ring of 8 rows and the paged step on 4-row pages:
    the logits of the valid slots and every cache tensor, updated in
    place."""
    jb, jp, _ = reference(arch)
    tb, tp = port(arch, policy)
    rng = np.random.default_rng(7)
    b, mp, r, pages, n_snap = 4, 4, 4, 18, 3
    if kind == "ring":
        npc = random_cache(jb, rng, b, 8)
    else:
        npc = random_cache(jb, rng, b, mp * r, kind="paged",
                           pool_pages=pages, page_rows=r,
                           state_pages=n_snap)
    jc = jax.tree.map(jnp.asarray, npc)
    tc = jax.tree.map(lambda a: torch.from_numpy(a.copy()), npc)
    for t_len, n_valid, reset, save, load in STEPS:
        tok = rng.integers(3, 256, (b, t_len)).astype(np.int32)
        nv, rs = np.array(n_valid, np.int32), np.array(reset)
        jkw = dict(n_valid=jnp.asarray(nv), reset_mask=jnp.asarray(rs))
        tkw = dict(n_valid=t(nv), reset_mask=t(rs))
        if kind == "ring":
            jl, jc = jb.decode_block(jp, jc, {"tokens": jnp.asarray(tok)},
                                     **jkw)
            tl, tc2 = tb.decode_block(tp, tc, {"tokens": t(tok)}, **tkw)
        else:
            page = {"reset_pos": np.array([0, 2, 0, 0], np.int32)}
            tpage = dict(page)
            tables = rng.permutation(pages)[:b * mp].reshape(b, mp)
            copy = np.arange(pages, dtype=np.int32)
            copy[tables[2, 1]] = tables[0, 3]      # a page copied on write
            page.update(tables=tables.astype(np.int32), kv_copy=copy)
            src, dst = cow_pairs(copy, b * 2)
            tpage.update(tables=tables, kv_src=src, kv_dst=dst)
            if arch == "zamba2":
                snaps = dict(snap_save=np.array(save, np.int32),
                             snap_load=np.array(load, np.int32))
                page.update(snaps)
                tpage.update(snaps)
            jl, jc = jb.decode_block_paged(
                jp, jc, {"tokens": jnp.asarray(tok)}, **jkw,
                page={k: jnp.asarray(v) for k, v in page.items()})
            tl, tc2 = tb.decode_block_paged(
                tp, tc, {"tokens": t(tok)}, **tkw,
                page={k: t(v) for k, v in tpage.items()})
        assert tc2 is tc                    # updated in place
        live = nv > 0
        close(tl[t(live)], np.asarray(jl)[live])
        assert_cache_close(tc, jc)


def test_cache_pspec_matches_reference():
    """The hybrid's ring and paged declarations: every Mamba layer's conv
    and state, the snapshot pool, and a KV layer a group."""
    def shapes(tr):
        def leaf(ps):
            dt = ps.dtype
            name = (None if dt is None else str(dt).split(".")[-1]
                    if isinstance(dt, torch.dtype) else np.dtype(dt).name)
            return tuple(ps.shape), name
        return jax.tree.map(leaf, tr, is_leaf=lambda x: hasattr(x, "shape"))

    for kw in (dict(per_slot_pos=True),
               dict(per_slot_pos=True, kind="paged", pool_pages=7,
                    page_rows=8, state_pages=5)):
        want = shapes(jbuild(jzamba.SMOKE).cache_pspec(3, 32, **kw))
        got = shapes(build_lm(tzamba.SMOKE).cache_pspec(3, 32, **kw))
        assert got == want


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("t_len", [4, 1])
def test_idle_step_is_an_exact_no_op(kind, t_len):
    """The step a CUDA graph's warm-up runs (every n_valid 0, no reset, an
    identity copy plan, no snapshot saved or loaded) leaves the KV pool,
    the Mamba state, the snapshots and the positions exactly as they
    were."""
    tb, tp = port("zamba2")
    eng = ServingEngine(tb, tp, ServeConfig(slots=3, cache_kind=kind,
                                            page_rows=8))
    eng.queue.append(Request(uid=0, prompt=np.arange(5, 40)))
    eng._ensure_cache()
    gen = torch.Generator().manual_seed(0)
    leaves = [v for sub in eng._cache.values() if isinstance(sub, dict)
              for v in sub.values()]
    for v in leaves:
        v.normal_(generator=gen)
    eng._cache["pos"].copy_(torch.tensor([3, 21, 40]))
    before = [v.clone() for v in leaves]
    eng._block_step(eng._idle_inputs(t_len))
    for v, was in zip(leaves, before):
        assert torch.equal(v, was)
    assert eng._cache["pos"].tolist() == [3, 21, 40]


# ---------------------------------------------------------------------------
# the engines


def recycle_requests(seed=3):
    """The reference's six-request recycle case (tests/test_serving.py):
    more requests than slots, chunked prefill."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(3, 256, size=plen, dtype=np.int32), 5)
            for i, plen in enumerate((5, 19, 11, 26, 8, 14))]


def serve_both(arch, reqs, **kw):
    """The same requests through the reference's and the port's continuous
    engines: (reference engine, results; port engine, results)."""
    jb, jp, _ = reference(arch)
    jeng = JServingEngine(jb, jp, JServeConfig(scheduler="continuous",
                                               policy="fused", **kw))
    want = jeng.run([JRequest(uid=u, prompt=p, max_new=m)
                     for u, p, m in reqs])
    tb, tp = port(arch)
    teng = ServingEngine(tb, tp, ServeConfig(**kw))
    got = teng.run([Request(uid=u, prompt=p, max_new=m) for u, p, m in reqs])
    return jeng, want, teng, got


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_tokens_match_jax(arch, kind):
    """Greedy tokens, the admit/finish trace and the paged pool's counters
    of the port's continuous engine equal the reference engine's (the vlm
    served text-only, as the reference's block step embeds tokens only)."""
    kw = dict(slots=3, max_new=5, eos_token=-1, prefill_chunk=6,
              cache_kind=kind)
    jeng, want, teng, got = serve_both(arch, recycle_requests(), **kw)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(len(r.tokens) == 5 for r in got)
    assert teng.trace == jeng.trace
    assert teng.kv_stats() == jeng.kv_stats()


def test_hybrid_paged_matches_ring_token_for_token():
    """The reference's ``test_paged_matches_ring_token_for_token`` for the
    hybrid: the paged pool is a layout, not a model change; its tokens equal
    the ring's with slots recycled, and it allocates KV pages and takes
    state snapshots."""
    reqs = recycle_requests()
    kw = dict(slots=3, max_new=5, eos_token=-1, prefill_chunk=6)
    _, _, _, ring = serve_both("zamba2", reqs, cache_kind="ring", **kw)
    _, _, teng, paged = serve_both("zamba2", reqs, cache_kind="paged", **kw)
    assert [r.tokens for r in paged] == [r.tokens for r in ring]
    kv = teng.kv_stats()
    assert kv["allocs"] > 0 and kv["snapshots"] > 0


def test_hybrid_shared_prefix_is_shared_only_at_a_snapshot():
    """Prefix sharing in the hybrid needs a state snapshot at the boundary:
    a request that extends a finished prompt by whole pages shares it (KV
    pages and state), and its tokens equal the ring's and the
    reference's."""
    rng = np.random.default_rng(5)
    first = rng.integers(3, 256, 16, dtype=np.int32)
    reqs = [(0, first, 4),
            (1, np.concatenate([first, rng.integers(3, 256, 8,
                                                    dtype=np.int32)]), 4)]
    kw = dict(slots=1, max_new=4, eos_token=-1, prefill_chunk=8,
              page_rows=8)
    jeng, want, teng, paged = serve_both("zamba2", reqs, cache_kind="paged",
                                         **kw)
    kw.pop("page_rows")
    _, _, _, ring = serve_both("zamba2", reqs, cache_kind="ring", **kw)
    assert [r.tokens for r in paged] == [r.tokens for r in ring] == \
        [r.tokens for r in want]
    assert teng.kv_stats() == jeng.kv_stats()
    assert teng.kv_stats()["shared_tokens"] == len(first)


def test_continuous_matches_manual_decode_hybrid():
    """The reference's ``test_continuous_matches_manual_decode_ssm`` for the
    hybrid: the engine's tokens equal the port's own prefill and greedy
    decode steps."""
    bundle, params = port("zamba2")
    prompt = np.arange(5, 14, dtype=np.int32)
    eng = ServingEngine(bundle, params, ServeConfig(
        slots=2, max_new=3, eos_token=-1, prefill_chunk=4))
    got = eng.run([Request(uid=0, prompt=prompt)])[0].tokens
    tokens = t(prompt).long()[None]
    logits, cache = bundle.prefill_last(params, {"tokens": tokens})
    cache = tlm.pad_cache_seq(cache, 3)
    want = [int(torch.argmax(logits[0, -1]))]
    for _ in range(2):
        logits, cache = bundle.decode(
            params, cache, {"tokens": torch.tensor([[want[-1]]])})
        want.append(int(torch.argmax(logits[0, -1])))
    assert got == want


def test_vlm_wave_engine_raises_on_the_missing_stub():
    """The wave scheduler prefills through ``lm_apply``, which needs the
    stub; the engine passes none, so the port raises a ``ValueError`` that
    names it, and the reference's engine fails on the key."""
    reqs = recycle_requests()[:2]
    jb, jp, _ = reference("internvl2")
    jeng = JServingEngine(jb, jp, JServeConfig(scheduler="wave",
                                               policy="fused", slots=2,
                                               max_new=3))
    with pytest.raises(KeyError, match="stub"):
        jeng.run([JRequest(uid=u, prompt=p, max_new=m) for u, p, m in reqs])
    tb, tp = port("internvl2")
    teng = ServingEngine(tb, tp, ServeConfig(scheduler="wave", slots=2,
                                             max_new=3))
    with pytest.raises(ValueError, match="stub"):
        teng.run([Request(uid=u, prompt=p, max_new=m) for u, p, m in reqs])
    assert teng.prefills == 0


# ---------------------------------------------------------------------------
# training


@functools.lru_cache(maxsize=None)
def reference_grads(arch, remat):
    jb, _, npp = reference(arch, remat_policy=remat)
    params = jax.tree.map(jnp.asarray, npp)
    batch = jax.tree.map(np.asarray, smoke_batch(ARCHS[arch][0].SMOKE))
    loss, grads = jax.jit(jax.value_and_grad(jb.loss))(params, batch)
    return batch, float(loss), grads


@pytest.mark.parametrize("remat", ["off", "none", "dots"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_loss_and_gradients_match_jax(arch, remat):
    """The loss (the vlm's over the text tail) within rtol 1e-5 and every
    gradient leaf of the stacked parameters within rtol 1e-4, atol 1e-6 of
    ``jax.grad`` of the reference's ``bundle.loss`` under the same remat
    policy: the shared block's leaves sum the gradients of each of its
    uses, and ``stub_proj`` takes the prefix's."""
    batch, want_loss, want_grads = reference_grads(arch, remat)
    bundle = build_lm(dataclasses.replace(ARCHS[arch][1].SMOKE,
                                          remat_policy=remat))
    params = tree_from_numpy(reference(arch)[2], device="cpu")
    leaves = [v.requires_grad_() for v in tree.leaves(params)]
    got = bundle.loss(params, {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), want_loss, rtol=1e-5)
    grads = tree.unflatten(params, torch.autograd.grad(got, leaves))
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(want_grads)}
    got_g = dict(tree.items(grads))
    assert got_g.keys() == want.keys()
    extra = "['shared']" if arch == "zamba2" else "['stub_proj']"
    assert any(k.startswith(extra) for k in got_g)
    for k, v in got_g.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_vlm_loss_covers_the_text_tail():
    """The vlm's loss is the cross-entropy of the logits after the stub
    prefix against the labels."""
    bundle, params = port("internvl2")
    batch = {k: t(v) for k, v in jax.tree.map(
        np.asarray, smoke_batch(jvlm.SMOKE)).items()}
    logits, _, _ = tlm.lm_apply(params, bundle.cfg, batch)
    assert logits.shape[1] == tvlm.SMOKE.stub_tokens + batch["labels"].shape[1]
    tail = tlm.cross_entropy(logits[:, tvlm.SMOKE.stub_tokens:],
                             batch["labels"])
    torch.testing.assert_close(tlm.lm_loss(params, bundle.cfg, batch), tail)


# ---------------------------------------------------------------------------
# parameters, checkpoints, configs and the CLIs


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_carry_shared_and_stub_proj_both_ways(arch):
    """``params_from_numpy`` splits the stacked ``blocks`` only: the
    hybrid's ``shared`` tree and the vlm's ``stub_proj`` come across as
    they are, and ``params_to_numpy`` gives the reference's tree back bit
    for bit."""
    npp = reference(arch)[2]
    cfg = ARCHS[arch][1].SMOKE
    params = params_from_numpy(npp, cfg, device="cpu")
    assert len(params["blocks"]) == cfg.n_layers
    key = "shared" if arch == "zamba2" else "stub_proj"
    assert key in params and key in build_lm(cfg).params_pspec
    back = params_to_numpy(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(npp))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("arch", list(ARCHS))
def test_checkpoint_round_trip_keeps_shared_and_stub_proj(tmp_path, arch):
    """The port's train state of each SMOKE model through the checkpointer:
    its leaf keys are the reference's train state's (``shared`` and
    ``stub_proj`` among them), restored bit for bit, and a step from the
    restored state equals a step from the state in memory."""
    cfg = ARCHS[arch][1].SMOKE
    bundle = build_lm(cfg)
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    state = init_train_state(torch.Generator().manual_seed(0), bundle,
                             opt_cfg)
    ckpt.save(str(tmp_path), 1, state)
    with open(tmp_path / "step_1" / "manifest.json") as f:
        keys = set(json.load(f)["leaves"])
    jstate = jinit_train_state(jax.random.PRNGKey(0),
                               jbuild(ARCHS[arch][0].SMOKE), JOptConfig())
    want = {jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_leaves_with_path(jstate) if k[0].key != "rng"}
    assert want <= keys
    part = "['shared']" if arch == "zamba2" else "['stub_proj']"
    assert any(part in k for k in keys)
    restored = ckpt.restore(str(tmp_path), 1, state)
    for (k, a), b in zip(tree.items(state), tree.leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    batch = {k: t(v) for k, v in jax.tree.map(
        np.asarray, smoke_batch(ARCHS[arch][0].SMOKE)).items()}
    step = make_train_step(bundle, opt_cfg)
    s_a, m_a = step(state, batch)
    s_b, m_b = step(restored, batch)
    assert m_a["loss"].item() == m_b["loss"].item()
    for a, b in zip(tree.leaves(s_a["params"]), tree.leaves(s_b["params"])):
        assert torch.equal(a, b)


HYBRID_FIELDS = ("name", "family", "n_layers", "d_model", "vocab", "n_heads",
                 "n_kv_heads", "head_dim", "dh", "d_ff", "rope_theta",
                 "norm_eps", "swa_window", "tie_embeddings", "ssm_state",
                 "ssm_head_dim", "ssm_groups", "conv_kernel", "expand",
                 "ssd_chunk", "d_inner", "ssm_heads", "shared_attn_every",
                 "stub_tokens", "stub_dim", "remat_policy")


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "internvl2-76b"])
def test_configs_and_counts_match_the_reference(arch, size):
    from repro import configs as jconfigs

    jc, tc = (getattr(jconfigs.get(arch), size),
              getattr(tconfigs.get(arch), size))
    for field in HYBRID_FIELDS:
        assert getattr(tc, field) == getattr(jc, field), field
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    jb, tb = jbuild(jc), build_lm(tc)
    assert tb.n_params == jb.n_params == count_pspec_params(jb.params_pspec)
    assert tb.n_active_params == tb.n_params
    if (arch, size) == ("zamba2-2.7b", "FULL"):    # the whole model: 4.9 GB
        assert tb.n_params == 2_442_333_600


def test_serve_cli_serves_zamba2_on_cpu(capsys):
    """The README's CPU demos: zamba2 SMOKE on the ring, on the paged pool
    and on the wave."""
    for extra in ([], ["--cache", "paged"], ["--scheduler", "wave"]):
        eng = tserve.main(["--arch", "zamba2-2.7b", "--config", "smoke",
                           "--device", "cpu", "--requests", "3",
                           "--max-new", "3", "--prompt-len", "12", *extra])
        assert len(eng.results) == 3
        assert all(len(r.tokens) == 3 for r in eng.results)
    assert "3 requests, 9 tokens" in capsys.readouterr().out


def test_serve_cli_serves_internvl2_text_only_on_cpu():
    eng = tserve.main(["--arch", "internvl2-76b", "--config", "smoke",
                       "--device", "cpu", "--requests", "2", "--max-new",
                       "2", "--prompt-len", "8"])
    assert [len(r.tokens) for r in eng.results] == [2, 2]
    with pytest.raises(ValueError, match="stub"):
        tserve.main(["--arch", "internvl2-76b", "--config", "smoke",
                     "--device", "cpu", "--requests", "2", "--max-new", "2",
                     "--prompt-len", "8", "--scheduler", "wave"])


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "internvl2-76b"])
def test_train_cli_on_cpu(tmp_path, arch):
    """``launch/train.py`` takes both archs (the vlm's batches with a zero
    stub prefix, as the reference's): finite losses, a checkpoint."""
    losses = ttrain.main(["--arch", arch, "--config", "smoke", "--device",
                          "cpu", "--steps", "2", "--batch", "2", "--seq",
                          "32", "--ckpt-dir", str(tmp_path), "--resume",
                          "none"])
    assert sorted(losses) == [0, 1]
    assert all(np.isfinite(v) for v in losses.values())
    assert ckpt.latest_step(str(tmp_path)) == 2

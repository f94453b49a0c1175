"""Parity of the PyTorch port's MoE family with the JAX package.

The reference's weights (``init_params(PRNGKey(0))``, f32) and numpy inputs
made from a seed go through both packages; the reference runs under
``policy="fused"``, the port on each of its paths (on a CPU tensor the
``tile`` path runs each kernel's plain version, the capacity offsets
``tcu_scan.cu``'s). Routing is discontinuous and ``torch.topk`` promises no
order among ties where ``jax.lax.top_k`` takes the lower index: the seeded
inputs here have no ties. Tolerances:

* ``moe_apply_grouped``/``moe_apply_global`` at qwen3-moe and grok-1 SMOKE,
  output and aux: 1e-5 (f32, sums in another order);
* qwen3-moe SMOKE through ``repro.models.lm``: ``lm_apply``, its cache and
  four decode steps at ``TOL = 2e-4`` (as ``test_torch_models.py``); the
  ring and the paged block steps at 1e-5 of the largest value (as
  ``test_torch_continuous.py`` and ``test_torch_paged.py``), greedy tokens
  and the engines' traces identical; ``lm_loss`` rtol 1e-5 and its
  gradients rtol 1e-4, atol 1e-6 (as ``test_torch_training.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import grok_1_314b as jgrok
from repro.configs import qwen3_moe_235b_a22b as jqwen
from repro.configs.common import smoke_batch
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.common import count_pspec_params, init_params
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import _pad_cache_seq
from repro_torch import configs as tconfigs
from repro_torch import obs, tree
from repro_torch.configs import grok_1_314b as tgrok
from repro_torch.configs import qwen3_moe_235b_a22b as tqwen
from repro_torch.launch import serve as tserve
from repro_torch.models import build_lm
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.common import (
    params_from_numpy,
    swiglu,
    tree_from_numpy,
)
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.kvpool import cow_pairs

ARCHS = {"qwen3": (jqwen, tqwen), "grok": (jgrok, tgrok)}
PORT_PATHS = ("tile", "fused", "baseline")
TOL = 2e-4          # the model through 2 layers, as test_torch_models.py
STEP_TOL = 1e-5     # of the largest value, as test_torch_continuous.py
LAYER_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's SMOKE bundle, params and numpy params (f32)."""
    cfg = dataclasses.replace(ARCHS[arch][0].SMOKE, policy="fused")
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    return bundle, params, jax.tree.map(np.asarray, params)


def port(arch, policy=None, **overrides):
    cfg = dataclasses.replace(ARCHS[arch][1].SMOKE, policy=policy,
                              **overrides)
    return build_lm(cfg), params_from_numpy(reference(arch)[2], cfg,
                                            device="cpu")


def close(got: torch.Tensor, want, tol=STEP_TOL):
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().numpy().astype(np.float64) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------------------
# the layer


def layer_case(arch, seed=0):
    """Layer 0's MoE params of the reference's SMOKE init and an input
    (2, 24, d)."""
    npp = reference(arch)[2]
    p = {k: v[0] for k, v in npp["blocks"]["moe"].items()}
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, ARCHS[arch][1].SMOKE.d_model)).astype(np.float32)
    return p, x


# capacity: the default (no token dropped), and cut so that tokens drop
# (two groups of 24 tokens, capacity 8 a group and expert)
CAPACITY = {"ample": {}, "drops": dict(capacity_factor=0.01, moe_groups=2)}


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("impl", ["grouped", "global"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_layer_matches_jax(arch, impl, capacity):
    p, x = layer_case(arch)
    kw = dict(moe_impl=impl, **CAPACITY[capacity])
    jcfg = dataclasses.replace(ARCHS[arch][0].SMOKE, policy="fused", **kw)
    jfn = (jlayers.moe_apply_grouped if impl == "grouped"
           else jlayers.moe_apply_global)
    want, want_aux = jax.jit(lambda p, x: jfn(p, jcfg, x))(p, jnp.asarray(x))
    tp = {k: t(v) for k, v in p.items()}
    for path in PORT_PATHS:
        tcfg = dataclasses.replace(ARCHS[arch][1].SMOKE, policy=path, **kw)
        tfn = (tlayers.moe_apply_grouped if impl == "grouped"
               else tlayers.moe_apply_global)
        got, aux = tfn(tp, tcfg, t(x))
        assert got.shape == x.shape and aux.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LAYER_TOL, atol=LAYER_TOL)
        np.testing.assert_allclose(aux.item(), float(want_aux),
                                   rtol=LAYER_TOL)
        assert torch.equal(tlayers.moe_apply(tp, tcfg, t(x))[0], got)
    if capacity == "drops":       # the cut capacity changed the output
        roomy = dataclasses.replace(tcfg, capacity_factor=8.0)
        assert not torch.allclose(tfn(tp, roomy, t(x))[0], got, atol=1e-3)


@pytest.mark.parametrize("impl", ["grouped", "global"])
def test_identical_experts_equal_dense(impl):
    """The reference's ``test_moe_identical_experts_equals_dense``: with every
    expert the same SwiGLU and ample capacity, routing is irrelevant and
    the layer is the dense MLP (rtol, atol 1e-3, the reference's); and the
    port equals the reference on the same inputs (1e-5)."""
    cfg = dataclasses.replace(tqwen.SMOKE, capacity_factor=8.0,
                              moe_impl=impl)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    rng = np.random.default_rng(0)
    w_in = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    w_gate = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    w_out = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    p = {"router": rng.standard_normal((d, e)).astype(np.float32),
         "w_in": np.broadcast_to(w_in, (e, d, f)),
         "w_gate": np.broadcast_to(w_gate, (e, d, f)),
         "w_out": np.broadcast_to(w_out, (e, f, d))}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    got, aux = tlayers.moe_apply({k: t(v) for k, v in p.items()}, cfg, t(x))
    want = swiglu(t(x), t(w_in), t(w_gate), t(w_out))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)
    assert np.isfinite(aux.item())
    jcfg = dataclasses.replace(jqwen.SMOKE, capacity_factor=8.0,
                               moe_impl=impl)
    jgot, jaux = jax.jit(lambda p, x: jlayers.moe_apply(p, jcfg, x))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


def test_moe_resolutions_match_the_reference():
    """One layer under an obs session: the reference's dispatch-level
    resolutions, the ragged reduce of the counts, then the scan of the
    offsets."""
    p, x = layer_case("qwen3")
    jcfg = dataclasses.replace(jqwen.SMOKE, policy="fused")
    with jobs.using_obs() as jsess:     # resolved once, at the trace
        jax.jit(lambda p, x: jlayers.moe_apply(p, jcfg, x))(p, jnp.asarray(x))
    with obs.using_obs() as sess:
        tlayers.moe_apply({k: t(v) for k, v in p.items()},
                          dataclasses.replace(tqwen.SMOKE, policy="fused"),
                          t(x))
    keys = ("op", "n", "dtype", "band", "level", "chosen_path")
    want = [tuple(e[k] for k in keys)
            for e in jsess.events.events("resolution")]
    assert [tuple(e[k] for k in keys)
            for e in sess.events.events("resolution")] == want
    assert [w[0] for w in want] == ["ragged_reduce", "scan"]


# ---------------------------------------------------------------------------
# qwen3-moe SMOKE, the model


@pytest.fixture(scope="module")
def ref_model():
    jb, params, npp = reference("qwen3")
    cfg = jb.cfg
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (4, 2, 1)).astype(np.int32)
    logits, aux, cache = jax.jit(lambda p, tok: jlm.lm_apply(
        p, cfg, {"tokens": tok}, collect_cache=True))(params, tokens)
    prefill = (np.asarray(logits), float(aux),
               jax.tree.map(np.asarray, cache))
    decoded = []
    cache = _pad_cache_seq(cache, len(steps))
    decode = jax.jit(lambda p, c, tok: jlm.lm_decode(p, cfg, c,
                                                     {"tokens": tok}))
    for tok in steps:
        lg, cache = decode(params, cache, tok)
        decoded.append(np.asarray(lg))
    return dict(tokens=tokens, steps=steps, prefill=prefill, decoded=decoded,
                final=jax.tree.map(np.asarray, cache))


@pytest.mark.parametrize("path", PORT_PATHS)
def test_lm_apply_cache_and_decode_match_jax(ref_model, path):
    bundle, params = port("qwen3", path)
    cfg = bundle.cfg
    logits, aux, cache = tlm.lm_apply(
        params, cfg, {"tokens": t(ref_model["tokens"]).long()},
        collect_cache=True)
    want_logits, want_aux, want_cache = ref_model["prefill"]
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.item(), want_aux, rtol=TOL)
    assert aux.item() > 0
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["attn"][name].numpy(),
                                   want_cache["attn"][name], rtol=TOL,
                                   atol=TOL)
    cache = tlm.pad_cache_seq(cache, len(ref_model["steps"]))
    for tok, want in zip(ref_model["steps"], ref_model["decoded"]):
        lg, cache = bundle.decode(params, cache, {"tokens": t(tok).long()})
        np.testing.assert_allclose(lg.numpy(), want, rtol=TOL, atol=TOL)
    assert cache["pos"] == int(ref_model["final"]["pos"])
    np.testing.assert_allclose(cache["attn"]["k"].numpy(),
                               ref_model["final"]["attn"]["k"], rtol=TOL,
                               atol=TOL)


def ring_cache(jb, rng, b, smax):
    """A random continuous ring cache of the reference's layout, numpy."""
    return jax.tree.map(
        lambda a: (np.array([0, 5, 6, 17], np.int32)
                   if np.asarray(a).dtype == np.int32 else
                   rng.standard_normal(np.asarray(a).shape).astype(
                       np.float32)),
        init_params(jax.random.PRNGKey(0), jb.cache_pspec(
            b, smax, per_slot_pos=True), jnp.float32))


def paged_cache(jb, rng, b, mp, r, pages):
    return jax.tree.map(
        lambda a: (np.array([0, 5, 6, 17], np.int32)
                   if np.asarray(a).dtype == np.int32 else
                   rng.standard_normal(np.asarray(a).shape).astype(
                       np.float32)),
        init_params(jax.random.PRNGKey(0), jb.cache_pspec(
            b, mp * r, per_slot_pos=True, kind="paged", pool_pages=pages,
            page_rows=r), jnp.float32))


def assert_cache_close(tc, jc):
    for path, want in jax.tree_util.tree_leaves_with_path(jc):
        got = tc
        for key in path:
            got = got[key.key]
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            close(got, want)


# two chained steps (T = 4, then T = 1): slots that consume 0, 1, 3 and T
# tokens, one reset, positions that wrap the ring or the page table
STEPS = ((4, [0, 1, 3, 4], [False, True, False, False]),
         (1, [1, 1, 0, 1], [False] * 4))


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("policy", [None, "fused"])
def test_decode_block_matches_jax(kind, policy):
    """The ring step (``lm_decode_block``) on a ring of 8 rows, and the
    paged step (``lm_decode_block_paged``) on 4-row pages with a
    copy-on-write page: the logits of the valid slots and every cache
    tensor; the cache is updated in place."""
    jb, jp, _ = reference("qwen3")
    tb, tp = port("qwen3", policy)
    rng = np.random.default_rng(7)
    b, mp, r, pages = 4, 4, 4, 18
    npc = (ring_cache(jb, rng, b, 8) if kind == "ring"
           else paged_cache(jb, rng, b, mp, r, pages))
    jc = jax.tree.map(jnp.asarray, npc)
    tc = jax.tree.map(lambda a: torch.from_numpy(a.copy()), npc)
    for t_len, n_valid, reset in STEPS:
        tok = rng.integers(3, 256, (b, t_len)).astype(np.int32)
        nv, rs = np.array(n_valid, np.int32), np.array(reset)
        jkw = dict(n_valid=jnp.asarray(nv), reset_mask=jnp.asarray(rs))
        tkw = dict(n_valid=t(nv), reset_mask=t(rs))
        if kind == "ring":
            jl, jc = jb.decode_block(jp, jc, {"tokens": jnp.asarray(tok)},
                                     **jkw)
            tl, tc2 = tb.decode_block(tp, tc, {"tokens": t(tok)}, **tkw)
        else:
            tables = rng.permutation(pages)[:b * mp].reshape(b, mp)
            copy = np.arange(pages, dtype=np.int32)
            copy[tables[2, 1]] = tables[0, 3]      # a page copied on write
            src, dst = cow_pairs(copy, b * 2)
            reset_pos = np.array([0, 2, 0, 0], np.int32)
            jl, jc = jb.decode_block_paged(
                jp, jc, {"tokens": jnp.asarray(tok)}, **jkw,
                page={"reset_pos": jnp.asarray(reset_pos),
                      "tables": jnp.asarray(tables.astype(np.int32)),
                      "kv_copy": jnp.asarray(copy)})
            tl, tc2 = tb.decode_block_paged(
                tp, tc, {"tokens": t(tok)}, **tkw,
                page={"reset_pos": t(reset_pos), "tables": t(tables),
                      "kv_src": t(src), "kv_dst": t(dst)})
        assert tc2 is tc
        live = nv > 0
        close(tl[t(live)], np.asarray(jl)[live])
        assert_cache_close(tc, jc)


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("t_len", [4, 1])
def test_idle_step_is_an_exact_no_op(kind, t_len):
    """The step a CUDA graph's warm-up runs (every n_valid 0, deterministic
    zero tokens) routes its tokens through the MoE layers and leaves the
    cache exactly as it was."""
    tb, tp = port("qwen3")
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
    idle = eng._idle_inputs(t_len)
    assert not idle["tokens"].any() and not idle["n_valid"].any()
    eng._block_step(idle)
    for v, was in zip(leaves, before):
        assert torch.equal(v, was)
    assert eng._cache["pos"].tolist() == [3, 21, 40]


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_engine_tokens_match_jax(kind):
    """Greedy tokens of the port's continuous engine equal the reference
    engine's on the same requests (more requests than slots, chunked
    prefill), and so does the admit/finish trace."""
    jb, jp, _ = reference("qwen3")
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(3, 256, size=plen, dtype=np.int32), 5)
            for i, plen in enumerate((5, 19, 11, 26, 8))]
    kw = dict(slots=3, max_new=5, eos_token=-1, prefill_chunk=6,
              cache_kind=kind)
    jeng = JServingEngine(jb, jp, JServeConfig(scheduler="continuous",
                                               policy="fused", **kw))
    want = jeng.run([JRequest(uid=u, prompt=p, max_new=m)
                     for u, p, m in reqs])
    tb, tp = port("qwen3")
    teng = ServingEngine(tb, tp, ServeConfig(**kw))
    got = teng.run([Request(uid=u, prompt=p, max_new=m) for u, p, m in reqs])
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert teng.trace == jeng.trace


def test_lm_loss_and_gradients_match_jax():
    """The loss with ``MOE_AUX_WEIGHT`` times the aux loss, and every
    gradient leaf of the stacked parameters, against ``jax.grad`` of the
    reference's ``bundle.loss`` on its smoke batch."""
    jb, jp, npp = reference("qwen3")
    batch = jax.tree.map(np.asarray, smoke_batch(jqwen.SMOKE))
    loss, grads = jax.jit(jax.value_and_grad(jb.loss))(jp, batch)
    bundle = build_lm(tqwen.SMOKE)
    params = tree_from_numpy(npp, device="cpu")
    leaves = [v.requires_grad_() for v in tree.leaves(params)]
    tbatch = {k: t(v) for k, v in batch.items()}
    got = bundle.loss(params, tbatch)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert tlm.MOE_AUX_WEIGHT == jlm.MOE_AUX_WEIGHT
    ce = tlm.cross_entropy(tlm.lm_apply(tlm.unstack_blocks(params, bundle.cfg),
                                        bundle.cfg, tbatch)[0],
                           tbatch["labels"])
    assert got.item() > ce.item()         # the aux term is in the loss
    tgrads = tree.unflatten(params, torch.autograd.grad(got, leaves))
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(grads)}
    got_g = dict(tree.items(tgrads))
    assert got_g.keys() == want.keys()
    for k, v in got_g.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# parameters and configs


def test_params_from_numpy_splits_the_expert_leaves():
    """The reference's stacked ``(L, e, d, f)`` expert leaves become each
    layer's ``(e, d, f)`` views, bit for bit, with the declared shapes."""
    _, _, npp = reference("grok")
    cfg = tgrok.SMOKE
    params = params_from_numpy(npp, cfg, device="cpu")
    pspec = build_lm(cfg).params_pspec
    assert len(params["blocks"]) == cfg.n_layers
    for i, blk in enumerate(params["blocks"]):
        assert set(blk) == {"ln1", "attn", "ln2", "moe"}
        for name, leaf in blk["moe"].items():
            want = npp["blocks"]["moe"][name][i]
            assert tuple(leaf.shape) == pspec["blocks"][i]["moe"][name].shape
            assert np.array_equal(leaf.numpy(), want)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert [tuple(params["blocks"][0]["moe"][n].shape) for n in
            ("router", "w_in", "w_gate", "w_out")] == [
        (d, e), (e, d, f), (e, d, f), (e, f, d)]


MOE_FIELDS = ("name", "family", "n_layers", "d_model", "vocab", "n_heads",
              "n_kv_heads", "head_dim", "dh", "d_ff", "rope_theta",
              "norm_eps", "swa_window", "tie_embeddings", "n_experts",
              "experts_per_tok", "moe_d_ff", "capacity_factor", "moe_impl",
              "moe_groups", "remat_policy")


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_configs_and_counts_match_the_reference(arch, size):
    from repro import configs as jconfigs

    jc, tc = (getattr(jconfigs.get(arch), size),
              getattr(tconfigs.get(arch), size))
    for field in MOE_FIELDS:
        assert getattr(tc, field) == getattr(jc, field), field
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    jb, tb = jbuild(jc), build_lm(tc)
    assert tb.n_params == jb.n_params == count_pspec_params(jb.params_pspec)
    assert tb.n_active_params == jb.n_active_params < tb.n_params


def test_serve_cli_serves_qwen3_on_cpu(capsys):
    """The README's CPU demo, on the ring and on the paged cache."""
    for extra in ([], ["--cache", "paged"]):
        eng = tserve.main(["--arch", "qwen3-moe-235b-a22b", "--config",
                           "smoke", "--device", "cpu", "--requests", "3",
                           "--max-new", "3", "--prompt-len", "12", *extra])
        assert len(eng.results) == 3
        assert all(len(r.tokens) == 3 for r in eng.results)
    assert "3 requests, 9 tokens" in capsys.readouterr().out

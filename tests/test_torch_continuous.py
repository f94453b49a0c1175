"""Parity of the PyTorch port's continuous scheduler with the JAX package.

The reference's ``lm_decode_block`` and its continuous engine
(``scheduler="continuous"``, ``policy="fused"``) against the port's, on
mamba2 SMOKE and llama SMOKE in f32 with the reference's weights carried
over by ``params_from_numpy``: the block step's logits and every cache
tensor within 1e-5 of the largest absolute value, then greedy tokens and
the admit/finish trace identical. The reference's own scheduler tests
(``tests/test_serving.py``) follow, ported one for one. The CUDA graph's
replay is held against the eager step in ``tests/test_torch_graph.py``,
which imports no JAX, so that it runs on the card.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as jllama
from repro.configs import mamba2_1_3b as jmamba
from repro.models import build as jbuild
from repro.models.common import init_params
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import mamba2_1_3b as tmamba
from repro_torch.launch import serve as tserve
from repro_torch.models import build_lm
from repro_torch.models.common import init_params as tinit_params
from repro_torch.models.common import params_from_numpy
from repro_torch.models.lm import pad_cache_seq
from repro_torch.serving import Request, ServeConfig, ServingEngine

TOL = 1e-5          # of the largest absolute value, f32 on both sides
ARCHS = {"llama": (jllama, tllama), "mamba": (jmamba, tmamba)}


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


def prompts(n, seed, lo=5, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 256, int(rng.integers(lo, hi)), dtype=np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the block step


@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_cache_pspec_matches_reference(arch):
    jmod, tmod = ARCHS[arch]
    for swa in (None, 8):
        if swa is not None and tmod.SMOKE.family != "dense":
            continue
        jb = jbuild(dataclasses.replace(jmod.SMOKE, swa_window=swa))
        tb = build_lm(dataclasses.replace(tmod.SMOKE, swa_window=swa))
        for per_slot in (True, False):
            want = jax.tree.map(
                lambda ps: (tuple(ps.shape), np.dtype(ps.dtype).name
                            if ps.dtype is not None else None),
                jb.cache_pspec(3, 32, per_slot_pos=per_slot),
                is_leaf=lambda x: hasattr(x, "shape"))
            got = jax.tree.map(
                lambda ps: (tuple(ps.shape), None if ps.dtype is None
                            else str(ps.dtype).split(".")[-1]),
                tb.cache_pspec(3, 32, per_slot_pos=per_slot),
                is_leaf=lambda x: hasattr(x, "shape"))
            assert got == want, (swa, per_slot)
    # the paged kind is held against the reference in test_torch_paged.py
    with pytest.raises(ValueError, match="cache kind"):
        tb.cache_pspec(3, 32, per_slot_pos=True, kind="flat")


@pytest.mark.parametrize("policy", [None, "fused"])
@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_decode_block_matches_reference(weights, arch, policy):
    """Two chained steps (T = 4, then T = 1) on a random cache: slots that
    consume 0, 1, 3 and T tokens, one reset, positions that wrap the ring
    of 8 rows; the logits of the valid slots and every cache tensor."""
    jb, jp, npp = weights[arch]
    tb, tp = port(npp, ARCHS[arch][1], policy)
    rng = np.random.default_rng(7)
    b, smax = 4, 8

    def draw(a):
        if a.dtype == np.int32:
            return np.array([0, 5, 6, 17], np.int32)
        return rng.standard_normal(a.shape).astype(np.float32)

    npc = jax.tree.map(lambda a: draw(np.asarray(a)), init_params(
        jax.random.PRNGKey(0), jb.cache_pspec(b, smax, per_slot_pos=True),
        jnp.float32))
    jc = jax.tree.map(jnp.asarray, npc)
    tc = jax.tree.map(lambda a: torch.from_numpy(a.copy()), npc)
    for t_len, n_valid, reset in ((4, [0, 1, 3, 4], [False, True, False,
                                                     False]),
                                  (1, [1, 1, 0, 1], [False] * 4)):
        tok = rng.integers(3, 256, (b, t_len)).astype(np.int32)
        nv, rs = np.array(n_valid, np.int32), np.array(reset)
        jl, jc = jb.decode_block(jp, jc, {"tokens": jnp.asarray(tok)},
                                 n_valid=jnp.asarray(nv),
                                 reset_mask=jnp.asarray(rs))
        tl, tc2 = tb.decode_block(tp, tc, {"tokens": torch.from_numpy(tok)},
                                  n_valid=torch.from_numpy(nv),
                                  reset_mask=torch.from_numpy(rs))
        assert tc2 is tc                 # updated in place
        assert tl.shape == (b, tb.cfg.vocab)
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


@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_block_step_leaves_an_idle_cache_as_it_is(weights, arch):
    """n_valid 0 everywhere writes nothing (the CUDA graph's warm-up runs
    the step so)."""
    tb, tp = port(weights[arch][2], ARCHS[arch][1])
    gen = torch.Generator().manual_seed(0)
    cache = tinit_params(tb.cache_pspec(2, 16, per_slot_pos=True), gen,
                         torch.float32)
    body = cache["attn" if "attn" in cache else "mamba"]
    for t in body.values():
        t.normal_(generator=gen)
    cache["pos"].copy_(torch.tensor([3, 21]))
    before = {k: v.clone() for k, v in body.items()}
    tb.decode_block(tp, cache, {"tokens": torch.zeros((2, 4),
                                                      dtype=torch.long)},
                    n_valid=torch.zeros(2, dtype=torch.long),
                    reset_mask=torch.zeros(2, dtype=torch.bool))
    for k, v in before.items():
        assert torch.equal(body[k], v)
    assert cache["pos"].tolist() == [3, 21]


# ---------------------------------------------------------------------------
# the engine against the reference's


def serve_both(ref, tmod, reqs, *, policy=None, model=None, **cfg_kw):
    """The reference's continuous engine (``ref``: bundle, params, numpy
    params) and the port's (``tmod.SMOKE`` with ``model`` overrides) on the
    same requests: (reference results, port results, reference engine, port
    engine)."""
    jb, jp, npp = ref
    jeng = JServingEngine(jb, jp, JServeConfig(
        scheduler="continuous", policy="fused", **cfg_kw))
    want = jeng.run([JRequest(uid=i, prompt=p, max_new=m)
                     for i, (p, m) in enumerate(reqs)])
    tb, tp = port(npp, tmod, policy, **(model or {}))
    teng = ServingEngine(tb, tp, ServeConfig(**cfg_kw))
    got = teng.run([Request(uid=i, prompt=p, max_new=m)
                    for i, (p, m) in enumerate(reqs)])
    return want, got, jeng, teng


@pytest.mark.parametrize("policy", [None, "fused"])
@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_tokens_and_trace_match_reference(weights, arch, policy):
    """Five requests on two slots, per-request budgets, prompts longer than
    the chunk of 4; then the same with EOS set to a token the first run
    emitted."""
    reqs = list(zip(prompts(5, seed=1), [3, 6, 1, 5, 4]))
    for eos in (-1, None):
        if eos is None:
            eos = got[0].tokens[1]
        want, got, jeng, teng = serve_both(
            weights[arch], ARCHS[arch][1], reqs, policy=policy, slots=2,
            max_new=6, eos_token=eos, prefill_chunk=4)
        assert [g.tokens for g in got] == [w.tokens for w in want]
        assert teng.trace == jeng.trace
        assert [(g.admitted_tick, g.finish_tick) for g in got] == \
            [(w.admitted_tick, w.finish_tick) for w in want]
        assert teng.ticks == jeng.ticks
    assert len(got[0].tokens) == 1 and eos not in got[0].tokens


def test_windowed_dense_matches_reference():
    """llama SMOKE with a sliding window of 8 rows: the ring is the window,
    prompts longer than it wrap inside the prefill."""
    reqs = list(zip(prompts(3, seed=4, lo=9, hi=20), [5, 3, 4]))
    want, got, jeng, teng = serve_both(
        reference(jllama, swa_window=8), tllama, reqs,
        model={"swa_window": 8}, slots=2, max_new=5, eos_token=-1,
        prefill_chunk=4)
    assert teng._cache["attn"]["k"].shape[2] == 8
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert teng.trace == jeng.trace


def test_window_shorter_than_chunk_raises():
    """The reference sizes the chunk by the capacity bucket and the ring by
    the window, so a window under the chunk fails its step's assertion; the
    port raises a ValueError that says so before the first tick."""
    jb, jp, npp = reference(jllama, swa_window=8)
    reqs = [(np.arange(5, 25, dtype=np.int32), 2)]
    tb, tp = port(npp, tllama, swa_window=8)
    teng = ServingEngine(tb, tp, ServeConfig(slots=1, prefill_chunk=16))
    with pytest.raises(ValueError, match="swa_window"):
        teng.run([Request(uid=0, prompt=reqs[0][0], max_new=2)])
    jeng = JServingEngine(jb, jp, JServeConfig(slots=1, prefill_chunk=16,
                                               policy="fused"))
    with pytest.raises(AssertionError):
        jeng.run([JRequest(uid=0, prompt=reqs[0][0], max_new=2)])


def test_config_and_cli_default_to_continuous(capsys):
    cfg = ServeConfig()
    assert (cfg.scheduler, cfg.prefill_chunk, cfg.cache_kind) == (
        "continuous", 16, "ring")
    with pytest.raises(ValueError):
        ServeConfig(scheduler="other")
    tserve.main(["--config", "smoke", "--device", "cpu", "--requests", "3",
                 "--max-new", "3", "--prompt-len", "24"])
    out = capsys.readouterr().out
    assert "3 requests" in out and "scheduler=continuous" in out


# ---------------------------------------------------------------------------
# the reference's scheduler tests (tests/test_serving.py), ported


@pytest.fixture(scope="module")
def llama(weights):
    return port(weights["llama"][2], tllama)


def _reqs(n, vocab=256, maxp=20):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
        3, vocab, size=int(rng.integers(4, maxp)), dtype=np.int32))
        for i in range(n)]


def test_no_wave_barrier(llama):
    """Short requests admitted AFTER a long sequence finish BEFORE it: the
    freed slot is refilled while the long request keeps decoding."""
    eng = ServingEngine(*llama, ServeConfig(
        slots=2, max_new=4, eos_token=-1, prefill_chunk=8))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=0, prompt=rng.integers(3, 256, size=6,
                                               dtype=np.int32), max_new=48)]
    reqs += [Request(uid=i, prompt=rng.integers(3, 256, size=5,
                                                dtype=np.int32), max_new=2)
             for i in range(1, 5)]
    results = {r.uid: r for r in eng.run(reqs)}
    long_res = results[0]
    late_shorts = [r for uid, r in results.items()
                   if uid > 0 and r.admitted_tick > results[1].admitted_tick]
    assert late_shorts, "expected shorts admitted after the first wave"
    for r in late_shorts:
        assert r.admitted_tick > long_res.admitted_tick
        assert r.finish_tick < long_res.finish_tick


def test_evicted_slot_refilled_next_tick(llama):
    """Every finish with work still queued is followed by an admission into
    that slot on the very next tick."""
    eng = ServingEngine(*llama, ServeConfig(
        slots=2, max_new=3, eos_token=-1, prefill_chunk=8))
    eng.run(_reqs(6))
    admits = {(e["slot"], e["tick"]) for e in eng.trace
              if e["event"] == "admit"}
    finishes = [e for e in eng.trace if e["event"] == "finish"]
    last_admit_tick = max(t for _, t in admits)
    for e in finishes:
        if e["tick"] < last_admit_tick:   # queue was non-empty then
            assert (e["slot"], e["tick"] + 1) in admits


def test_compile_count_bounded_by_buckets(llama):
    """Across a mixed-length workload the block step runs at most two
    shapes per capacity bucket (T = prefill_chunk and T = 1); on a card
    that is the number of graphs captured."""
    eng = ServingEngine(*llama, ServeConfig(
        slots=2, max_new=4, eos_token=-1, prefill_chunk=4))
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(3, 256, size=plen,
                                               dtype=np.int32))
            for i, plen in enumerate((3, 5, 9, 14, 20, 11, 7))]
    eng.run(reqs)
    n = eng.compile_stats()["block"]
    assert 1 <= n <= 2, f"block step ran {n} shapes"


def test_continuous_matches_manual_decode(llama):
    """Chunked prefill + slot decode == the wave path's prefill and decode,
    with a chunk smaller than the prompt so several prefill ticks run."""
    bundle, params = llama
    prompt = np.arange(5, 13, dtype=np.int32)
    eng = ServingEngine(bundle, params, ServeConfig(
        slots=1, max_new=4, eos_token=-1, prefill_chunk=3))
    got = eng.run([Request(uid=0, prompt=prompt)])[0].tokens
    assert got == manual_decode(bundle, params, prompt, 4)


def manual_decode(bundle, params, prompt, n):
    toks = torch.from_numpy(prompt.astype(np.int64))[None, :]
    logits, cache = bundle.prefill_last(params, {"tokens": toks})
    cache = pad_cache_seq(cache, n)
    want = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        logits, cache = bundle.decode(
            params, cache, {"tokens": torch.tensor([[want[-1]]])})
        want.append(int(torch.argmax(logits[0, -1])))
    return want


def test_continuous_matches_manual_decode_ssm(weights):
    """The same for the SSM family: the masked recurrence must stop each
    slot's state exactly at its own length."""
    bundle, params = port(weights["mamba"][2], tmamba)
    prompt = np.arange(5, 14, dtype=np.int32)
    eng = ServingEngine(bundle, params, ServeConfig(
        slots=2, max_new=3, eos_token=-1, prefill_chunk=4))
    got = eng.run([Request(uid=0, prompt=prompt)])[0].tokens
    assert got == manual_decode(bundle, params, prompt, 3)


def test_ring_cache_wraps_beyond_capacity(weights, llama):
    """max_context caps the ring capacity; generation beyond it slides the
    attention window instead of failing, pos keeps counting, and the
    overflow is warned once and traced as the reference traces it."""
    prompt = np.arange(5, 17, dtype=np.int32)
    kw = dict(slots=1, max_new=24, eos_token=-1, prefill_chunk=8,
              max_context=16)
    eng = ServingEngine(*llama, ServeConfig(**kw))
    with pytest.warns(UserWarning, match="degrading"):
        res = eng.run([Request(uid=0, prompt=prompt)])[0]
    assert len(res.tokens) == 24          # 12 + 24 > 16: wrapped fine
    assert eng._capacity == 16
    # prompt (12) + every decode input (23: the final emitted token is
    # never fed back)
    assert int(eng._cache["pos"][0]) == 12 + 24 - 1
    jb, jp, _ = weights["llama"]
    jeng = JServingEngine(jb, jp, JServeConfig(
        scheduler="continuous", policy="fused", **kw))
    with pytest.warns(UserWarning, match="degrading"):
        want = jeng.run([JRequest(uid=0, prompt=prompt)])[0]
    degrade = [e for e in eng.trace if e["event"] == "swa_degrade"]
    assert degrade == [e for e in jeng.trace if e["event"] == "swa_degrade"]
    assert degrade == [{"tick": 0, "event": "swa_degrade", "uid": 0,
                        "slot": 0, "need": 36, "capacity": 16}]
    assert res.tokens == want.tokens


def test_continuous_per_request_max_new(llama):
    eng = ServingEngine(*llama, ServeConfig(slots=2, max_new=8,
                                            eos_token=-1))
    res = eng.run([Request(uid=0, prompt=np.arange(5, 10, dtype=np.int32),
                           max_new=2),
                   Request(uid=1, prompt=np.arange(5, 10, dtype=np.int32))])
    assert len(res[0].tokens) == 2 and len(res[1].tokens) == 8


def test_open_loop_arrivals_respected(llama):
    """Requests with a future arrival_s are not admitted before they
    arrive, and results carry latency bookkeeping."""
    eng = ServingEngine(*llama, ServeConfig(slots=2, max_new=2,
                                            eos_token=-1))
    reqs = [Request(uid=0, prompt=np.arange(5, 10, dtype=np.int32),
                    arrival_s=0.0),
            Request(uid=1, prompt=np.arange(5, 10, dtype=np.int32),
                    arrival_s=0.15)]
    res = eng.run(reqs)
    r1 = [r for r in res if r.uid == 1][0]
    assert r1.first_token_s is not None and r1.first_token_s >= 0.15
    assert len(r1.token_s) == len(r1.tokens)
    assert r1.finish_s >= r1.first_token_s

"""Parity of the port's last three dense configs with the JAX package:
internlm2-20b, deepseek-67b and h2o-danube-3-4b, whose sliding window the
wave path now takes.

The reference's weights (``init_params(PRNGKey(0))`` at each SMOKE config,
f32) go into the port through ``params_from_numpy``; the tokens come from
numpy seeds. The reference runs under ``policy="fused"``, the port on its
default path (on a CPU tensor each kernel's plain version) and on ``fused``
and ``baseline``. Tolerances, of the largest absolute value of the
reference's tensor (``close``): ``lm_apply`` logits and the collected
cache, then three decode steps, 1e-5.

h2o-danube SMOKE has a window of 32. Prompts of 20, 40 and 70 tokens are
prefilled and decoded three steps: 40 and 70 leave the ring of the last 32
rows, rolled so that position p sits at row ``p % 32``, which decode writes
and attends, and that ring is not grown; the cache of 20 rows is grown by
the three steps, which stay inside the window. Both are exact against the
forward over the longer sequence. Its continuous and paged engines give the
reference's tokens. Two uses are wrong in the reference, and refused by
the port: a ring grown by zero rows (the reference's wave grows every cache
by its budget) attends them, and a short cache not grown wraps onto its own
first row. The port's wave therefore raises where prompt and budget pass
the window.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import lm as jlm
from repro.models.common import count_pspec_params, init_params
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import _pad_cache_seq
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import build
from repro_torch.models import lm as tlm
from repro_torch.models.common import params_from_numpy
from repro_torch.serving import Request, ServeConfig, ServingEngine

DENSE = ("internlm2-20b", "deepseek-67b", "h2o-danube-3-4b")
DANUBE = "h2o-danube-3-4b"
TOL = 1e-5
PORT_PATHS = ("tile", "fused", "baseline")
# n_params of the reference's build at FULL
FULL_PARAMS = {"internlm2-20b": 19_861_149_696,
               "deepseek-67b": 67_425_001_472,
               "h2o-danube-3-4b": 3_961_839_360}


def t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def reference(arch):
    cfg = dataclasses.replace(jconfigs.get(arch).SMOKE, policy="fused")
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    return bundle, params, jax.tree.map(np.asarray, params)


def port(arch, policy=None):
    cfg = dataclasses.replace(tconfigs.get(arch).SMOKE, policy=policy)
    return build(cfg), params_from_numpy(reference(arch)[2], cfg,
                                         device="cpu")


def close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def assert_cache_close(tc, jc):
    assert tc["pos"] == int(jc["pos"])
    for n in ("k", "v"):
        close(tc["attn"][n], jc["attn"][n])


def inside_window(arch, s, steps=3):
    """The rows a prefill cache of ``s`` positions grows by for ``steps``
    decode steps: all of them, but never past the sliding window (a ring of
    the window's rows already takes every position)."""
    w = tconfigs.get(arch).SMOKE.swa_window
    return steps if w is None else max(0, min(s + steps, w) - s)


@functools.lru_cache(maxsize=None)
def ref_run(arch, s, pad):
    """The reference's forward over (2, s) tokens (logits and cache), then
    three decode steps from its cache grown by ``pad`` rows."""
    jb, params, _ = reference(arch)
    cfg = jb.cfg
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (3, 2, 1)).astype(np.int32)
    logits, _, cache = jax.jit(lambda p, b: jlm.lm_apply(
        p, cfg, b, collect_cache=True))(params, {"tokens": tokens})
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    if pad:
        cache = _pad_cache_seq(cache, pad)
    decode = jax.jit(jb.decode)
    decoded = []
    for tok in steps:
        lg, cache = decode(params, cache, {"tokens": tok})
        decoded.append(np.asarray(lg))
    return dict(tokens=tokens, steps=steps, prefill=prefill,
                decoded=decoded, final=jax.tree.map(np.asarray, cache))


def check_prefill_and_decode(arch, path, s, pad):
    ref = ref_run(arch, s, pad)
    bundle, params = port(arch, path)
    logits, _, cache = tlm.lm_apply(
        params, bundle.cfg, {"tokens": t(ref["tokens"]).long()},
        collect_cache=True)
    close(logits, ref["prefill"][0])
    assert_cache_close(cache, ref["prefill"][1])
    cache = tlm.pad_cache_seq(cache, pad)
    for tok, want in zip(ref["steps"], ref["decoded"]):
        lg, cache = bundle.decode(params, cache, {"tokens": t(tok).long()})
        close(lg, want)
    assert_cache_close(cache, ref["final"])
    return bundle, params, ref


@pytest.mark.parametrize("path", PORT_PATHS)
@pytest.mark.parametrize("arch", DENSE)
def test_lm_apply_and_decode_match_jax(arch, path):
    """Logits and cache of a 24-token forward, then three decode steps from
    the cache grown by three rows (danube's 24 + 3 stay in its window)."""
    check_prefill_and_decode(arch, path, 24, pad=3)


@pytest.mark.parametrize("path", PORT_PATHS)
@pytest.mark.parametrize("s", [20, 40, 70])
def test_windowed_prefill_and_ring_decode_match_jax(s, path):
    """danube SMOKE (window 32): the windowed prefill, its cache (the ring
    of the last 32 rows rolled by ``s % 32`` past the window) and three
    decode steps on it (the 20-row cache grown by three), against the
    reference's."""
    bundle, _, _ = check_prefill_and_decode(DANUBE, path, s,
                                            pad=inside_window(DANUBE, s))
    assert bundle.cfg.swa_window == 32


@pytest.mark.parametrize("s", [20, 40, 70])
def test_ring_decode_equals_the_longer_forward(s):
    """Teacher forcing: each decode step's logits on the ring equal the
    forward's over the prompt and the decoded tokens at that position. A
    wrong roll passes every prefill check and shows only here."""
    bundle, params = port(DANUBE)
    rng = np.random.default_rng(s)
    full = torch.from_numpy(rng.integers(0, 256, (2, s + 3))).long()
    want, _, _ = tlm.lm_apply(params, bundle.cfg, {"tokens": full})
    last, cache = bundle.prefill_last(params, {"tokens": full[:, :s]})
    assert cache["attn"]["k"].shape[2] == min(s, 32)
    cache = tlm.pad_cache_seq(cache, inside_window(DANUBE, s))
    close(last, want[:, s - 1:s].numpy())
    for i in range(3):
        lg, cache = bundle.decode(params, cache,
                                  {"tokens": full[:, s + i:s + i + 1]})
        close(lg, want[:, s + i:s + i + 1].numpy())


@pytest.mark.parametrize("s,pad", [(40, 3), (20, 0)])
def test_misused_caches_are_refused(s, pad):
    """A ring grown by zero rows (the reference's wave grows every cache by
    its budget) attends them, and a 20-row cache not grown wraps onto its
    own first row: the reference's decode is then off the exact one by more
    than 0.02 (limits of the reference, ROADMAP queue 3). The port raises
    on both before the step."""
    exact = ref_run(DANUBE, s, pad=inside_window(DANUBE, s))
    wrong = ref_run(DANUBE, s, pad=pad)
    assert np.abs(wrong["decoded"][0] - exact["decoded"][0]).max() > 0.02
    bundle, params = port(DANUBE)
    _, cache = bundle.prefill_last(params, {"tokens": t(wrong["tokens"])
                                            .long()})
    cache = tlm.pad_cache_seq(cache, pad)
    with pytest.raises(ValueError, match="window" if pad else "full"):
        bundle.decode(params, cache, {"tokens": t(wrong["steps"][0]).long()})


# ---------------------------------------------------------------------------
# the engines


def requests(seed=3):
    """Six requests on two slots, prompts and budgets past danube's window
    of 32, chunked prefill."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(3, 256, size=plen, dtype=np.int32), 6)
            for i, plen in enumerate((5, 40, 11, 29, 8, 70))]


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_windowed_engine_tokens_match_jax(kind):
    """The continuous engine on the ring (32 rows a slot: the window) and
    on the paged pool: greedy tokens and the admit/finish trace equal the
    reference engine's."""
    kw = dict(slots=2, max_new=6, eos_token=-1, prefill_chunk=8,
              cache_kind=kind)
    jb, jp, _ = reference(DANUBE)
    jeng = JServingEngine(jb, jp, JServeConfig(scheduler="continuous",
                                               policy="fused", **kw))
    reqs = requests()
    want = jeng.run([JRequest(uid=u, prompt=p, max_new=m)
                     for u, p, m in reqs])
    tb, tp = port(DANUBE)
    teng = ServingEngine(tb, tp, ServeConfig(**kw))
    got = teng.run([Request(uid=u, prompt=p, max_new=m) for u, p, m in reqs])
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(len(r.tokens) == 6 for r in got)
    assert teng.trace == jeng.trace
    assert teng.kv_stats() == jeng.kv_stats()


def test_windowed_wave_inside_the_window_matches_the_ring():
    """Inside the window the wave serves, and its tokens equal the
    continuous ring's; past it the wave raises before any prefill, naming
    the continuous scheduler."""
    tb, tp = port(DANUBE)
    rng = np.random.default_rng(4)
    inside = [Request(uid=i, prompt=rng.integers(3, 256, 12,
                                                 dtype=np.int32),
                      max_new=8) for i in range(2)]
    out = {}
    for sched in ("wave", "continuous"):
        eng = ServingEngine(tb, tp, ServeConfig(
            slots=2, max_new=8, eos_token=-1, scheduler=sched,
            prefill_chunk=8))
        out[sched] = [r.tokens for r in eng.run(inside)]
    assert out["wave"] == out["continuous"]
    eng = ServingEngine(tb, tp, ServeConfig(slots=2, max_new=8,
                                            scheduler="wave"))
    past = [Request(uid=0, prompt=np.arange(3, 30, dtype=np.int32))]
    with pytest.raises(ValueError, match="continuous scheduler"):
        eng.run(past)
    assert eng.prefills == 0


def test_serve_cli_serves_danube_on_every_scheduler(capsys):
    """The README's CPU demo on the ring, the paged pool and (inside the
    window) the wave."""
    for extra in ([], ["--cache", "paged"],
                  ["--scheduler", "wave", "--prompt-len", "12"]):
        eng = tserve.main(["--arch", DANUBE, "--config", "smoke", "--device",
                           "cpu", "--requests", "3", "--max-new", "3",
                           "--prompt-len", "40", *extra])
        assert [len(r.tokens) for r in eng.results] == [3, 3, 3]
    assert "3 requests, 9 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# configs


CONFIG_FIELDS = ("name", "family", "n_layers", "d_model", "vocab", "n_heads",
                 "n_kv_heads", "head_dim", "dh", "d_ff", "rope_theta",
                 "norm_eps", "swa_window", "tie_embeddings", "remat_policy")


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", DENSE)
def test_configs_and_counts_match_the_reference(arch, size):
    jc, tc = (getattr(jconfigs.get(arch), size),
              getattr(tconfigs.get(arch), size))
    for field in CONFIG_FIELDS:
        assert getattr(tc, field) == getattr(jc, field), field
    assert str(tc.dtype).split(".")[-1] == np.dtype(jc.dtype).name
    jb, tb = jbuild(jc), build(tc)
    assert tb.n_params == jb.n_params == count_pspec_params(jb.params_pspec)
    if size == "FULL":
        assert tb.n_params == FULL_PARAMS[arch]

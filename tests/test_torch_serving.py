"""Parity of the PyTorch port's wave serving engine with the JAX package.

The reference's engine with ``scheduler="wave"`` and ``policy="fused"`` and
the port's engine serve mamba2 SMOKE and llama SMOKE (f32, the reference's
weights carried over with ``params_from_numpy``) to the same requests with
greedy sampling; the generated tokens must be identical. The continuous
scheduler, the default, is held against the reference in
``tests/test_torch_continuous.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

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
from repro_torch.models.common import params_from_numpy
from repro_torch.serving import Request, ServeConfig, ServingEngine


@pytest.fixture(scope="module")
def ref_weights():
    cfg = dataclasses.replace(jmamba.SMOKE, policy="fused")
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    return bundle, params, jax.tree.map(np.asarray, params)


def prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, tmamba.SMOKE.vocab, int(rng.integers(4, 20)),
                         dtype=np.int32) for _ in range(n)]


def serve_both(ref_weights, reqs, *, slots, max_new, eos, policy,
               jax_policy="fused"):
    bundle, params, np_params = ref_weights
    jeng = JServingEngine(bundle, params, JServeConfig(
        slots=slots, max_new=max_new, eos_token=eos, scheduler="wave",
        policy=jax_policy))
    want = jeng.run([JRequest(uid=i, prompt=p, max_new=m)
                     for i, (p, m) in enumerate(reqs)])
    cfg = dataclasses.replace(tmamba.SMOKE, policy=policy)
    teng = ServingEngine(build_lm(cfg),
                         params_from_numpy(np_params, cfg, device="cpu"),
                         ServeConfig(slots=slots, max_new=max_new,
                                     eos_token=eos, scheduler="wave"))
    got = teng.run([Request(uid=i, prompt=p, max_new=m)
                    for i, (p, m) in enumerate(reqs)])
    return want, got, teng


@pytest.mark.parametrize("policy", [None, "fused", "ssd=tile_logdepth"])
def test_wave_greedy_tokens_identical_to_jax(ref_weights, policy):
    """Three requests in one wave; None is the port's default (the kernels,
    their plain versions on the CPU). Under ``ssd=tile_logdepth`` both
    engines prefill through their log-depth SSD (the reference's local
    kernels interpreted), so every decode step after the first token runs
    on the state that path handed over."""
    reqs = [(p, None) for p in prompts(3, seed=0)]
    logdepth = policy is not None and "tile_logdepth" in policy
    want, got, eng = serve_both(ref_weights, reqs, slots=4, max_new=8,
                                eos=2, policy=policy,
                                jax_policy=policy if logdepth else "fused")
    assert [r.uid for r in got] == [0, 1, 2]
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert g.prompt_len == w.prompt_len
    assert eng.prefills == 1 and eng.decodes >= 1
    if logdepth:
        assert eng.decodes >= 4 and max(len(g.tokens) for g in got) >= 5


def test_several_waves_and_budgets_identical_to_jax(ref_weights):
    """Five requests on two slots (three waves), per-request budgets, and
    no EOS so every budget runs out."""
    ps = prompts(5, seed=1)
    reqs = list(zip(ps, [3, 6, 1, 5, 4]))
    want, got, eng = serve_both(ref_weights, reqs, slots=2, max_new=6,
                                eos=-1, policy=None)
    for (p, m), w, g in zip(reqs, want, got):
        assert g.tokens == w.tokens
        assert len(g.tokens) == m
        assert g.first_token_s <= g.finish_s
        assert len(g.token_s) == m
    assert eng.prefills == 3


def test_unported_scheduler_names_the_roadmap():
    """The continuous scheduler is ported; its paged KV pool is not."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeConfig(cache_kind="paged")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.main(["--config", "smoke", "--device", "cpu",
                     "--cache", "paged"])


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--config", "smoke", "--device", "cpu", "--requests", "3",
                 "--max-new", "3", "--prompt-len", "12",
                 "--scheduler", "wave"])
    out = capsys.readouterr().out
    assert "3 requests" in out and "tok/s" in out
    assert "scheduler=wave" in out and "device=cpu" in out


def test_make_requests_draws_like_the_reference_launcher():
    """The reference's launch.serve draws prompt lengths and tokens from
    one numpy generator in this order."""
    reqs = tserve.make_requests(4, 32, 256, seed=7)
    rng = np.random.default_rng(7)
    for r in reqs:
        want = rng.integers(3, 256, size=rng.integers(4, 33), dtype=np.int32)
        np.testing.assert_array_equal(r.prompt, want)


# ---------------------------------------------------------------------------
# llama SMOKE (dense): the KV cache grows by the wave's budget after prefill


@pytest.fixture(scope="module")
def llama_weights():
    cfg = dataclasses.replace(jllama.SMOKE, policy="fused")
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    return bundle, params, jax.tree.map(np.asarray, params)


def serve_llama_both(weights, reqs, *, slots, max_new, eos, policy):
    bundle, params, np_params = weights
    jeng = JServingEngine(bundle, params, JServeConfig(
        slots=slots, max_new=max_new, eos_token=eos, scheduler="wave",
        policy="fused"))
    want = jeng.run([JRequest(uid=i, prompt=p, max_new=m)
                     for i, (p, m) in enumerate(reqs)])
    cfg = dataclasses.replace(tllama.SMOKE, policy=policy)
    teng = ServingEngine(build_lm(cfg),
                         params_from_numpy(np_params, cfg, device="cpu"),
                         ServeConfig(slots=slots, max_new=max_new,
                                     eos_token=eos, scheduler="wave"))
    got = teng.run([Request(uid=i, prompt=p, max_new=m)
                    for i, (p, m) in enumerate(reqs)])
    return want, got, teng


@pytest.mark.parametrize("policy", [None, "fused", "baseline"])
def test_llama_wave_greedy_tokens_identical_to_jax(llama_weights, policy):
    """Five uneven prompts on three slots (two waves, left padding), a
    budget of 7 (six decode steps past the prefill), per-request budgets,
    then the same run with EOS set to a token the first run emitted."""
    ps = prompts(5, seed=3)
    reqs = list(zip(ps, [None, 3, None, 1, 5]))
    want, got, eng = serve_llama_both(llama_weights, reqs, slots=3,
                                      max_new=7, eos=-1, policy=policy)
    assert len({len(p) for p in ps}) > 1
    for (p, m), w, g in zip(reqs, want, got):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert len(g.tokens) == (7 if m is None else m)
    assert eng.prefills == 2
    eos = got[0].tokens[2]
    want, got, _ = serve_llama_both(llama_weights, reqs, slots=3, max_new=7,
                                    eos=eos, policy=policy)
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert eos not in got[0].tokens and len(got[0].tokens) == 2


def test_llama_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "llama3.2-1b", "--config", "smoke", "--device",
                 "cpu", "--requests", "3", "--max-new", "3",
                 "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert "3 requests" in out and "device=cpu" in out

"""The continuous scheduler's block step replayed from its CUDA graph.

On a CUDA card the engine captures one graph per step shape over its cache,
the ring or the paged pool; each replay is held against the eager step on a
clone of the cache with the same inputs, the paged step's page plan among
them. Every test skips without a card. This file imports no JAX, so
that it runs on the card's machine:

    python -m pytest -q tests/test_torch_graph.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import h2o_danube_3_4b as tdanube
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import mamba2_1_3b as tmamba
from repro_torch.configs import qwen3_moe_235b_a22b as tqwen
from repro_torch.configs import zamba2_2_7b as tzamba
from repro_torch.kernels import ops as kops
from repro_torch.models import build_lm
from repro_torch.models.common import init_params
from repro_torch.models.lm import n_groups
from repro_torch.serving import Request, ServeConfig, ServingEngine

# danube's window of 32 makes its ring 32 rows a slot, and the mixed run's
# prompts (up to 32 tokens and 4 new) wrap it
CONFIGS = {"llama": tllama.SMOKE, "mamba": tmamba.SMOKE,
           "qwen3": tqwen.SMOKE, "zamba2": tzamba.SMOKE,
           "danube": tdanube.SMOKE}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card; the block step's CUDA "
                    "graph and its RMSNorm kernel have no CPU mode")
    return torch.device("cuda")


def rmsnorms_a_step(cfg):
    """RMSNorm launches of one step: two a layer and the final norm, and
    the hybrid's shared block two a use."""
    return 2 * cfg.n_layers + 2 * n_groups(cfg) + 1


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def leaves(tree):
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def engine_after_mixed_run(arch, device, cache_kind="ring"):
    cfg = CONFIGS[arch]
    bundle = build_lm(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    eng = ServingEngine(bundle, init_params(bundle.params_pspec, gen,
                                            cfg.dtype),
                        ServeConfig(slots=4, max_new=4, eos_token=-1,
                                    prefill_chunk=4, cache_kind=cache_kind,
                                    page_rows=8))
    rng = np.random.default_rng(1)
    prefix = rng.integers(3, 256, size=12)
    eng.run([Request(uid=i, prompt=np.concatenate(
        [prefix, rng.integers(3, 256, size=plen)]))
        for i, plen in enumerate((3, 5, 9, 14, 20, 11, 7))])
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("cache_kind", ["ring", "paged"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_graph_count_bounded_by_buckets(arch, cache_kind, cuda):
    """A mixed-length run captures one graph per step shape (T = chunk and
    T = 1) and a second run of the same bucket captures none."""
    eng = engine_after_mixed_run(arch, cuda, cache_kind)
    assert eng.compile_stats()["block"] == 2 and sorted(eng._graphs) == [1, 4]
    eng.run([Request(uid=9, prompt=np.arange(5, 35))])
    assert eng.compile_stats()["block"] == 2
    if (arch, cache_kind) == ("llama", "paged"):   # the common prefix
        assert eng.kv_stats()["shared_tokens"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_graph_replay_matches_eager_step(arch, cuda):
    """Each graph replayed on the engine's cache against the eager step on a
    clone of it with the same inputs: the same logits and cache. The
    replay counts its RMSNorm and scan launches, which their wrappers
    cannot."""
    eng = engine_after_mixed_run(arch, cuda)
    norms = rmsnorms_a_step(eng.bundle.cfg)
    # an MoE layer's capacity offsets: one tcu_scan.cu launch
    scans = eng.bundle.cfg.n_layers if eng.bundle.cfg.family == "moe" else 0
    rng = np.random.default_rng(3)
    for t_len, n_valid, reset in ((4, [4, 3, 1, 0], [True, False, False,
                                                     False]),
                                  (1, [1, 1, 0, 1], [False] * 4)):
        tok = rng.integers(3, 256, (4, t_len))
        nv, rs = np.array(n_valid), np.array(reset)
        inputs = eng._step_inputs(tok, nv, rs, None)
        clone = clone_tree(eng._cache)
        before = kops.launch_counts()
        got = eng._graphs[t_len].replay(inputs).clone()
        after = kops.launch_counts()
        assert after["rmsnorm"] == before["rmsnorm"] + norms
        assert after["tcu_scan"] == before["tcu_scan"] + scans
        want = eager_on(eng, clone, inputs)
        live = torch.from_numpy(nv > 0).to(cuda)
        torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-6)
        for g, w in zip(leaves(eng._cache), leaves(clone)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def eager_on(eng, cache, inputs):
    """The engine's eager block step on ``cache`` instead of its own."""
    own, eng._cache = eng._cache, cache
    try:
        with torch.inference_mode():
            return eng._eager_step({k: torch.from_numpy(
                np.asarray(v, np.int64)).to(eng.device)
                for k, v in inputs.items()})
    finally:
        eng._cache = own


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_paged_graph_replay_matches_eager_step(arch, cuda):
    """The paged step replayed with a page plan that resets a slot onto a
    shared prefix, copies a page on write, saves and loads snapshots,
    against the eager paged step on a clone of the pool: the same logits
    and cache."""
    eng = engine_after_mixed_run(arch, cuda, "paged")
    kv = eng._kv
    norms = rmsnorms_a_step(eng.bundle.cfg)
    # an MoE layer's capacity offsets: one tcu_scan.cu launch
    scans = eng.bundle.cfg.n_layers if eng.bundle.cfg.family == "moe" else 0
    rng = np.random.default_rng(3)
    nb = eng.cfg.slots
    for t_len, n_valid, reset in ((4, [4, 3, 1, 0], [True, False, False,
                                                     False]),
                                  (1, [1, 1, 0, 1], [False] * 4)):
        plan = {"reset_pos": np.array([5, 0, 0, 0])}
        if kv.has_kv:
            tables = rng.permutation(kv.kv.n_pages)[:nb * kv.maxpages]
            copy = np.arange(kv.kv.n_pages)
            copy[tables[0]] = tables[-1]          # one page copied on write
            plan.update(tables=tables.reshape(nb, kv.maxpages),
                        kv_copy=copy)
        if kv.has_state:
            plan.update(snap_save=np.array([-1, 1, -1, 2]),
                        snap_load=np.array([0, -1, -1, -1]))
        tok = rng.integers(3, 256, (nb, t_len))
        nv, rs = np.array(n_valid), np.array(reset)
        inputs = eng._step_inputs(tok, nv, rs, plan)
        clone = clone_tree(eng._cache)
        before = kops.launch_counts()
        got = eng._graphs[t_len].replay(inputs).clone()
        after = kops.launch_counts()
        assert after["rmsnorm"] == before["rmsnorm"] + norms
        assert after["tcu_scan"] == before["tcu_scan"] + scans
        want = eager_on(eng, clone, inputs)
        live = torch.from_numpy(nv > 0).to(cuda)
        torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-6)
        for g, w in zip(leaves(eng._cache), leaves(clone)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_new_capacity_recaptures_into_a_new_pool(cuda):
    """A request of another capacity bucket reallocates the cache and
    captures its graphs again, into a new memory pool, and replays them."""
    eng = engine_after_mixed_run("llama", cuda)
    pool = eng._pool
    res = eng.run([Request(uid=9, prompt=np.arange(5, 30), max_new=3)])
    assert eng._capacity == 32 and eng.compile_stats()["block"] == 4
    assert eng._pool is not None and eng._pool != pool
    assert len(res[0].tokens) == 3

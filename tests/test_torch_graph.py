"""The continuous scheduler's block step replayed from its CUDA graph.

On a CUDA card the engine captures one graph per step shape over its cache;
each replay is held against the eager step on a clone of the cache with the
same inputs. Every test skips without a card. This file imports no JAX, so
that it runs on the card's machine:

    python -m pytest -q tests/test_torch_graph.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import mamba2_1_3b as tmamba
from repro_torch.kernels import ops as kops
from repro_torch.models import build_lm
from repro_torch.models.common import init_params
from repro_torch.serving import Request, ServeConfig, ServingEngine

CONFIGS = {"llama": tllama.SMOKE, "mamba": tmamba.SMOKE}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card; the block step's CUDA "
                    "graph and its RMSNorm kernel have no CPU mode")
    return torch.device("cuda")


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def leaves(tree):
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def engine_after_mixed_run(arch, device):
    cfg = CONFIGS[arch]
    bundle = build_lm(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    eng = ServingEngine(bundle, init_params(bundle.params_pspec, gen,
                                            cfg.dtype),
                        ServeConfig(slots=4, max_new=4, eos_token=-1,
                                    prefill_chunk=4))
    rng = np.random.default_rng(1)
    eng.run([Request(uid=i, prompt=rng.integers(3, 256, size=plen))
             for i, plen in enumerate((3, 5, 9, 14, 20, 11, 7))])
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_graph_count_bounded_by_buckets(arch, cuda):
    """A mixed-length run captures one graph per step shape (T = chunk and
    T = 1) and a second run of the same bucket captures none."""
    eng = engine_after_mixed_run(arch, cuda)
    assert eng.compile_stats()["block"] == 2 and sorted(eng._graphs) == [1, 4]
    eng.run([Request(uid=9, prompt=np.arange(5, 30))])
    assert eng.compile_stats()["block"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_graph_replay_matches_eager_step(arch, cuda):
    """Each graph replayed on the engine's cache against the eager step on a
    clone of it with the same inputs: the same logits and cache. The
    replay counts its RMSNorm launches, which its wrapper cannot."""
    eng = engine_after_mixed_run(arch, cuda)
    norms = 2 * eng.bundle.cfg.n_layers + 1
    rng = np.random.default_rng(3)
    for t_len, n_valid, reset in ((4, [4, 3, 1, 0], [True, False, False,
                                                     False]),
                                  (1, [1, 1, 0, 1], [False] * 4)):
        tok = rng.integers(3, 256, (4, t_len))
        nv, rs = np.array(n_valid), np.array(reset)
        clone = clone_tree(eng._cache)
        before = kops.launch_counts()["rmsnorm"]
        got = eng._graphs[t_len].replay(tok, nv, rs).clone()
        assert kops.launch_counts()["rmsnorm"] == before + norms
        with torch.inference_mode():
            want, _ = eng.bundle.decode_block(
                eng.params, clone, {"tokens": torch.from_numpy(tok).to(cuda)},
                n_valid=torch.from_numpy(nv).to(cuda),
                reset_mask=torch.from_numpy(rs).to(cuda))
        live = torch.from_numpy(nv > 0).to(cuda)
        torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-6)
        for g, w in zip(leaves(eng._cache), leaves(clone)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)

"""Seeded sampling of the PyTorch port's serving engine.

``ServeConfig(greedy=False, temperature=..., seed=...)`` draws each token
from ``softmax(logits / temperature)`` with a ``torch.Generator`` seeded
from the config. The reference draws with ``jax.random.categorical`` from a
``PRNGKey`` of the same seed; the bits differ, so the two are compared in
distribution: both lie within a stated total variation distance of the
softmax on the same logits. The reference's seedable test
(``tests/test_serving.py``) is ported one for one.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.launch import serve as tserve
from repro_torch.models import build_lm
from repro_torch.models.common import init_params
from repro_torch.serving import Request, ServeConfig, ServingEngine

N_DRAWS = 1 << 16
# the expected total variation of 2^16 draws over 16 classes from their own
# distribution is about 0.006; 0.02 is more than three times that
TV_TOL = 0.02


@pytest.fixture(scope="module")
def llama():
    bundle = build_lm(tllama.SMOKE)
    gen = torch.Generator().manual_seed(0)
    return bundle, init_params(bundle.params_pspec, gen, tllama.SMOKE.dtype)


def _reqs(n, vocab=256, maxp=20):
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
        3, vocab, size=int(rng.integers(4, maxp)), dtype=np.int32))
        for i in range(n)]


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_sampling_rng_seedable(llama, scheduler):
    """ServeConfig.seed drives the sampling generator: same seed, same
    sampled tokens; a different seed diverges. The launcher's
    ``build_engine(seed=)`` threads the seed into the config, not just into
    the weights."""
    bundle, params = llama

    def sample(seed):
        eng = ServingEngine(bundle, params, ServeConfig(
            slots=2, max_new=6, eos_token=-1, greedy=False,
            temperature=1.0, seed=seed, scheduler=scheduler))
        return [r.tokens for r in eng.run(_reqs(3))]

    assert sample(7) == sample(7)
    assert sample(7) != sample(8)
    eng = tserve.build_engine("llama3.2-1b", "smoke", device="cpu", slots=2,
                              max_new=2, seed=5)
    assert eng.cfg.seed == 5


def softmax(logits, temperature):
    z = logits.astype(np.float64) / temperature
    p = np.exp(z - z.max())
    return p / p.sum()


def total_variation(draws, p) -> float:
    freq = np.bincount(np.asarray(draws), minlength=len(p)) / len(draws)
    return 0.5 * float(np.abs(freq - p).sum())


@pytest.mark.parametrize("temperature", [1.0, 0.5, 2.0])
def test_draws_follow_the_softmax_as_the_reference_does(llama, temperature):
    """2^16 draws over 16 fixed classes (logits from numpy seed 0): the
    port's engine and the reference's ``jax.random.categorical`` are each
    within TV_TOL of ``softmax(logits / temperature)``."""
    logits = 2.0 * np.random.default_rng(0).standard_normal(16).astype(
        np.float32)
    p = softmax(logits, temperature)
    eng = ServingEngine(*llama, ServeConfig(greedy=False,
                                            temperature=temperature, seed=0))
    ours = eng._sample(torch.from_numpy(logits).expand(N_DRAWS, 16))
    theirs = jax.random.categorical(
        jax.random.PRNGKey(0), jnp.asarray(logits) / temperature,
        shape=(N_DRAWS,))
    assert ours.shape == (N_DRAWS,)
    assert total_variation(ours, p) < TV_TOL
    assert total_variation(np.asarray(theirs), p) < TV_TOL


def test_each_row_draws_from_its_own_logits(llama):
    """A row whose logits put all the mass on one class always draws it;
    the draws of consecutive calls come from one advancing generator."""
    eng = ServingEngine(*llama, ServeConfig(greedy=False, seed=3))
    logits = torch.full((3, 8), -1e4)
    logits[0, 5] = logits[1, 2] = logits[2, 7] = 0.0
    for _ in range(4):
        assert eng._sample(logits).tolist() == [5, 2, 7]
    flat = torch.zeros(64, 8)
    assert (eng._sample(flat) != eng._sample(flat)).any()


def test_greedy_is_the_default_and_sampling_needs_a_temperature():
    cfg = ServeConfig()
    assert cfg.greedy and cfg.temperature == 1.0 and cfg.seed == 0
    with pytest.raises(ValueError, match="temperature"):
        ServeConfig(greedy=False, temperature=0.0)

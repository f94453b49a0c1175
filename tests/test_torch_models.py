"""Parity of the PyTorch port's mamba2 model with the JAX package.

mamba2 SMOKE (f32, 3 layers): the reference's ``init_params(PRNGKey(0))``
goes through ``params_from_numpy`` into the port; logits, the prefill cache
and four decode steps are compared with the reference under
``policy="fused"`` for every port path. Tolerances are stated at each test.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as jllama
from repro.configs import mamba2_1_3b as jmamba
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.common import count_pspec_params, init_params
from repro_torch import configs as tconfigs
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import mamba2_1_3b as tmamba
from repro_torch.models import build_lm
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.common import init_params as tinit_params
from repro_torch.models.common import params_from_numpy

PORT_PATHS = ("tile", "fused", "baseline")
# f32 through 3 layers: the port and the reference differ only in the order
# of f32 sums (and the SSD form on the tile/baseline paths)
TOL = 2e-4


@pytest.fixture(scope="module")
def ref_model():
    cfg = dataclasses.replace(jmamba.SMOKE, policy="fused")
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (4, 2, 1)).astype(np.int32)
    logits, _, cache = jlm.lm_apply(params, cfg, {"tokens": tokens},
                                    collect_cache=True)
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    decoded = []
    for tok in steps:
        lg, cache = jlm.lm_decode(params, cfg, cache, {"tokens": tok})
        decoded.append(np.asarray(lg))
    final = jax.tree.map(np.asarray, cache)
    return dict(cfg=cfg, params=params, np_params=np_params, tokens=tokens,
                steps=steps, prefill=prefill, decoded=decoded, final=final)


def port_cfg(path):
    return dataclasses.replace(tmamba.SMOKE, policy=path)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("path", PORT_PATHS)
def test_lm_apply_and_cache_match_jax(ref_model, path):
    cfg = port_cfg(path)
    params = params_from_numpy(ref_model["np_params"], cfg, device="cpu")
    tokens = torch.from_numpy(ref_model["tokens"].astype(np.int64))
    logits, _, cache = tlm.lm_apply(params, cfg, {"tokens": tokens},
                                    collect_cache=True)
    want_logits, want_cache = ref_model["prefill"]
    close(logits, want_logits)
    assert cache["pos"] == int(want_cache["pos"])
    close(cache["mamba"]["conv"], want_cache["mamba"]["conv"])
    close(cache["mamba"]["state"], want_cache["mamba"]["state"], tol=2e-3)
    last, _, _ = tlm.lm_apply(params, cfg, {"tokens": tokens},
                              last_only=True)
    close(last[:, 0], want_logits[:, -1])


@pytest.mark.parametrize("path", PORT_PATHS)
def test_four_decode_steps_match_jax(ref_model, path):
    cfg = port_cfg(path)
    params = params_from_numpy(ref_model["np_params"], cfg, device="cpu")
    tokens = torch.from_numpy(ref_model["tokens"].astype(np.int64))
    _, _, cache = tlm.lm_apply(params, cfg, {"tokens": tokens},
                               collect_cache=True)
    for tok, want in zip(ref_model["steps"], ref_model["decoded"]):
        logits, cache = tlm.lm_decode(
            params, cfg, cache, {"tokens": torch.from_numpy(
                tok.astype(np.int64))})
        close(logits, want)
    final = ref_model["final"]
    assert cache["pos"] == int(final["pos"])
    close(cache["mamba"]["conv"], final["mamba"]["conv"])
    close(cache["mamba"]["state"], final["mamba"]["state"], tol=2e-3)


@pytest.mark.parametrize("path", ["tile", "fused"])
def test_mamba_layer_matches_jax(ref_model, path):
    """One Mamba-2 layer alone, on a random input."""
    jcfg = ref_model["cfg"]
    cfg = port_cfg(path)
    lp = jax.tree.map(lambda a: a[0], ref_model["params"]["blocks"]["mamba"])
    tp = params_from_numpy(ref_model["np_params"], cfg,
                           device="cpu")["blocks"][0]["mamba"]
    x = np.random.default_rng(1).standard_normal((2, 40, 64)).astype(
        np.float32)
    want, wcache = jlayers.mamba_apply(lp, jcfg, jnp.asarray(x),
                                       collect_cache=True)
    got, cache = tlayers.mamba_apply(tp, cfg, torch.from_numpy(x),
                                     collect_cache=True)
    close(got, want)
    close(cache["state"], wcache["state"], tol=2e-3)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    want = jlayers._causal_conv(*map(jnp.asarray, (xbc, w, bias)))
    got = tlayers._causal_conv(*map(torch.from_numpy, (xbc, w, bias)))
    close(got, want, tol=1e-5)


def test_params_from_numpy_carries_bf16_bit_exactly():
    """ml_dtypes.bfloat16 leaves (which torch.from_numpy refuses) arrive as
    torch.bfloat16 with the same bits, split per layer."""
    cfg = tmamba.SMOKE
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.standard_normal(500) * 10.0 ** rng.integers(-30, 30, 500),
        [0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-39, 65504.0, 3.0e38]])
    bf = vals.astype(np.float32).astype(ml_dtypes.bfloat16)
    stacked = np.resize(bf, (cfg.n_layers, 4, 127))
    tree = {"embed": bf[:508].reshape(4, 127),
            "final_norm": np.ones(7, np.float32),
            "blocks": {"ln": stacked}}
    out = params_from_numpy(tree, cfg, device="cpu")
    assert out["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["embed"].view(torch.int16).numpy(),
        tree["embed"].view(np.int16))
    assert out["final_norm"].dtype == torch.float32
    assert len(out["blocks"]) == cfg.n_layers
    for i, blk in enumerate(out["blocks"]):
        assert blk["ln"].dtype == torch.bfloat16
        np.testing.assert_array_equal(blk["ln"].view(torch.int16).numpy(),
                                      stacked[i].view(np.int16))
    nan = np.full((cfg.n_layers, 2), np.nan, np.float32).astype(
        ml_dtypes.bfloat16)
    got = params_from_numpy({"blocks": {"x": nan}}, cfg, device="cpu")
    assert torch.isnan(got["blocks"][0]["x"].float()).all()


def test_params_from_numpy_rejects_wrong_depth():
    cfg = tmamba.SMOKE
    with pytest.raises(ValueError):
        params_from_numpy({"blocks": {"ln": np.zeros((cfg.n_layers + 1, 4),
                                                     np.float32)}},
                          cfg, device="cpu")


def test_init_params_follows_the_reference_rules(ref_model):
    """Same shapes and dtypes as the reference's tree, layer by layer, and
    the reference's init rules (values differ: torch draws its own)."""
    cfg = tmamba.SMOKE
    bundle = build_lm(cfg)
    gen = torch.Generator().manual_seed(0)
    params = tinit_params(bundle.params_pspec, gen, cfg.dtype)
    ref_shapes = params_from_numpy(ref_model["np_params"], cfg, device="cpu")
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)  # noqa: E731
    got = {jax.tree_util.keystr(k): v for k, v in flat(params)}
    want = {jax.tree_util.keystr(k): v for k, v in flat(ref_shapes)}
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
    m = params["blocks"][0]["mamba"]
    assert torch.all(m["conv_b"] == 0) and torch.all(m["norm_w"] == 1)
    assert torch.all(m["d_skip"] == 1)
    a = -torch.exp(m["a_log"])
    assert torch.all((a <= -1.0) & (a >= -16.0))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert torch.all((dt >= 1e-3 - 1e-6) & (dt <= 1e-1 + 1e-6))
    std = params["blocks"][0]["mamba"]["in_proj"].std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(params["embed"].std().item() - 0.02) < 0.002
    again = tinit_params(bundle.params_pspec,
                         torch.Generator().manual_seed(0), cfg.dtype)
    assert torch.equal(again["embed"], params["embed"])


def assert_reference_numbers(jc, tc):
    for f in ("name", "family", "n_layers", "d_model", "vocab", "norm_eps",
              "tie_embeddings", "ssm_state", "ssm_head_dim", "ssm_groups",
              "conv_kernel", "expand", "ssd_chunk", "d_inner", "ssm_heads",
              "n_heads", "n_kv_heads", "d_ff", "head_dim", "dh",
              "rope_theta", "swa_window"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    assert build_lm(tc).n_params == count_pspec_params(
        jbuild(jc).params_pspec)


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
def test_configs_have_the_reference_numbers(size):
    assert_reference_numbers(getattr(jmamba, size), getattr(tmamba, size))


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
def test_llama_configs_have_the_reference_numbers(size):
    assert_reference_numbers(getattr(jllama, size), getattr(tllama, size))
    if size == "FULL":   # about 1.24 B parameters, the embedding tied
        assert build_lm(tllama.FULL).n_params == 1_235_814_400


def test_unported_archs_and_families_name_the_roadmap():
    """Every arch of the reference is ported; an unknown arch is a
    ``KeyError`` and an unknown family a ``NotImplementedError``. A
    windowed model's wave prefill (logits and the ring it leaves) matches
    the reference's."""
    from repro import configs as jconfigs
    from repro_torch.models import build

    assert set(jconfigs.all_arch_ids()) <= set(tconfigs.ARCHS)
    for arch in jconfigs.all_arch_ids():
        assert tconfigs.get(arch).FULL.name == jconfigs.get(arch).FULL.name
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")
    with pytest.raises(NotImplementedError, match="family"):
        build(dataclasses.replace(tllama.SMOKE, family="no-such-family"))
    jcfg = dataclasses.replace(jllama.SMOKE, swa_window=8, policy="fused")
    jb = jbuild(jcfg)
    jp = init_params(jax.random.PRNGKey(0), jb.params_pspec, jcfg.dtype)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 20)).astype(np.int32)
    want, want_cache = jb.prefill_last(jp, {"tokens": tokens})
    swa = dataclasses.replace(tllama.SMOKE, swa_window=8)
    bundle = build_lm(swa)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), swa,
                               device="cpu")
    got, cache = bundle.prefill_last(
        params, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert cache["attn"]["k"].shape[2] == 8
    np.testing.assert_allclose(cache["attn"]["k"].numpy(),
                               np.asarray(want_cache["attn"]["k"]),
                               rtol=1e-5, atol=1e-5)



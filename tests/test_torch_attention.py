"""Parity of the PyTorch port's attention and dense (llama) model with the
JAX package.

The same numpy inputs, made from a seed, go through the reference (the
Pallas flash kernel in interpret mode, its oracle, ``chunked_attention``,
``decode_attention``, the llama layers and LM) and through the port on every
port path (``tile`` runs the flash kernel's plain version on the CPU,
``fused``, ``baseline``). llama SMOKE (f32, 2 layers) carries the
reference's ``init_params(PRNGKey(0))`` into the port through
``params_from_numpy``. Every tolerance is stated at its test; the
reference's own attention tolerance is ``rtol=atol=2e-3``
(``tests/test_kernels.py``), and these are tighter where f32 allows.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as jllama
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import xla_attention as jxla
from repro.models.common import init_params
from repro.serving.engine import _pad_cache_seq
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.core import dispatch as tdispatch
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import xla_attention as txla
from repro_torch.models.common import params_from_numpy

PORT_PATHS = ("tile", "fused", "baseline")
# f32 attention: the two sides differ only in the order of f32 sums
ATOL = 1e-5


def arrays(*shapes, seed=0):
    """numpy f32 inputs as (jax arrays, torch tensors) with equal values."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


def close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def kernel_layout(t):
    return t.transpose(1, 2)


# ---------------------------------------------------------------------------
# the flash kernel's plain version


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 128)])
def test_flash_ref_matches_the_interpreted_tpu_kernel(causal, window):
    """Block-aligned: Lq = Lk = 256, GQA 4/2, D = 64."""
    (jq, jk, jv), (tq, tk, tv) = arrays((1, 4, 256, 64), (1, 2, 256, 64),
                                        (1, 2, 256, 64), seed=1)
    want = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    close(got, want)
    # the wrapper and the tile path run the same plain version on the CPU
    m = [kernel_layout(t) for t in (tq, tk, tv)]
    close(kernel_layout(tkops.attention(*m, causal=causal, window=window)),
          want)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 50)])
def test_flash_ref_matches_the_jax_oracle_on_ragged_lengths(causal, window):
    """Lq < Lk, ends aligned by Lk - Lq, lengths on no block boundary."""
    (jq, jk, jv), (tq, tk, tv) = arrays((2, 4, 100, 32), (2, 2, 300, 32),
                                        (2, 2, 300, 32), seed=2)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    close(got, want)


def test_flash_ref_scale_and_bf16_output():
    (jq, jk, jv), (tq, tk, tv) = arrays((1, 2, 40, 16), (1, 1, 40, 16),
                                        (1, 1, 40, 16), seed=3)
    want = jref.flash_attention_ref(jq, jk, jv, scale=0.3)
    close(tref.flash_attention_ref(tq, tk, tv, scale=0.3), want)
    got = tref.flash_attention_ref(tq.bfloat16(), tk.bfloat16(),
                                   tv.bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape


# ---------------------------------------------------------------------------
# the fused path and decode attention


@pytest.mark.parametrize("sq,sk,hq,hkv,window", [
    (512, 512, 4, 2, None),
    (512, 512, 4, 2, 128),       # sliding-window branch
    (200, 200, 4, 4, None),      # one chunk shorter than 256
    (256, 512, 4, 2, None),      # Sq < Sk
    (256, 512, 4, 1, 100),
    (256, 2048, 2, 1, None),     # two KV chunks
])
def test_chunked_attention_matches_jax(sq, sk, hq, hkv, window):
    (jq, jk, jv), (tq, tk, tv) = arrays((2, sq, hq, 32), (2, sk, hkv, 32),
                                        (2, sk, hkv, 32), seed=sq + sk)
    want = jxla.chunked_attention(jq, jk, jv, causal=True, window=window)
    close(txla.chunked_attention(tq, tk, tv, causal=True, window=window),
          want)
    close(tdispatch.attention(tq, tk, tv, window=window, policy="fused"),
          want)
    # every path of the port agrees with the fused one
    for path in ("tile", "baseline"):
        close(tdispatch.attention(tq, tk, tv, window=window, policy=path),
              want)


def test_chunked_attention_non_causal_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = arrays((1, 256, 2, 16), (1, 256, 2, 16),
                                        (1, 256, 2, 16), seed=5)
    want = jxla.chunked_attention(jq, jk, jv, causal=False)
    close(txla.chunked_attention(tq, tk, tv, causal=False), want)


@pytest.mark.parametrize("sq", [300, 2100])
def test_fused_attention_raises_where_the_reference_cannot_reshape(sq):
    """The reference's fused path cuts the queries into min(256, Sq)-row
    chunks, so it cannot take Sq = 300 or 2100; the port says so, and the
    tile path takes any length."""
    _, (tq, tk, tv) = arrays((1, sq, 2, 16), (1, sq, 1, 16), (1, sq, 1, 16))
    with pytest.raises(ValueError, match="multiple"):
        txla.chunked_attention(tq, tk, tv)
    with pytest.raises(ValueError, match="multiple"):
        tdispatch.attention(tq, tk, tv, policy="fused")
    out = tdispatch.attention(tq, tk, tv, policy="tile")
    assert out.shape == tq.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("kind", ["scalar", "per_slot", "per_query"])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(kind, window):
    b, t, s = 3, 2, 24
    (jq, jk, jv), (tq, tk, tv) = arrays((b, t, 4, 16), (b, s, 2, 16),
                                        (b, s, 2, 16), seed=7)
    if kind == "scalar":
        cur = 17
    elif kind == "per_slot":
        cur = np.array([3, 24, 11], np.int32)
    else:
        cur = np.array([[3, 4], [20, 24], [1, 11]], np.int32)
    want = jxla.decode_attention(jq, jk, jv, jnp.asarray(cur), window=window)
    got = txla.decode_attention(
        tq, tk, tv, cur if kind == "scalar" else torch.from_numpy(cur),
        window=window)
    close(got, want)


# ---------------------------------------------------------------------------
# rope, swiglu, one layer


def test_rope_matches_jax():
    (jx,), (tx,) = arrays((2, 9, 3, 16), seed=8)
    pos = np.arange(9)[None].repeat(2, 0) + np.array([[0], [5]])
    want = jcommon.rope(jx, jnp.asarray(pos, jnp.int32), 5e5)
    close(tcommon.rope(tx, torch.from_numpy(pos), 5e5), want, tol=1e-6)
    got = tcommon.rope(tx.bfloat16(), torch.from_numpy(pos), 5e5)
    assert got.dtype == torch.bfloat16


def test_swiglu_matches_jax():
    (jx, jwi, jwg, jwo), (tx, twi, twg, two) = arrays(
        (2, 5, 16), (16, 32), (16, 32), (32, 16), seed=9)
    close(tcommon.swiglu(tx, twi, twg, two),
          jcommon.swiglu(jx, jwi, jwg, jwo))


@pytest.fixture(scope="module")
def ref_model():
    cfg = dataclasses.replace(jllama.SMOKE, policy="fused")
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (4, 2, 1)).astype(np.int32)
    logits, _, cache = jlm.lm_apply(params, cfg, {"tokens": tokens},
                                    collect_cache=True)
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    cache = _pad_cache_seq(cache, len(steps))
    decoded = []
    for tok in steps:
        lg, cache = jlm.lm_decode(params, cfg, cache, {"tokens": tok})
        decoded.append(np.asarray(lg))
    return dict(cfg=cfg, params=params,
                np_params=jax.tree.map(np.asarray, params), tokens=tokens,
                steps=steps, prefill=prefill, decoded=decoded,
                final=jax.tree.map(np.asarray, cache))


def port_cfg(path):
    return dataclasses.replace(tllama.SMOKE, policy=path)


@pytest.mark.parametrize("path", PORT_PATHS)
def test_attention_and_mlp_layer_match_jax(ref_model, path):
    jcfg, cfg = ref_model["cfg"], port_cfg(path)
    lp = jax.tree.map(lambda a: a[0], ref_model["params"]["blocks"])
    tp = params_from_numpy(ref_model["np_params"], cfg,
                           device="cpu")["blocks"][0]
    x = np.random.default_rng(1).standard_normal((2, 40, 64)).astype(
        np.float32)
    pos = np.arange(40)[None].repeat(2, 0)
    want, (wk, wv) = jlayers.attn_apply(
        lp["attn"], jcfg, jnp.asarray(x),
        positions=jnp.asarray(pos, jnp.int32))
    got, (k, v) = tlayers.attn_apply(tp["attn"], cfg, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos))
    close(got, want)
    close(k, wk)
    close(v, wv)
    close(tlayers.mlp_apply(tp["mlp"], cfg, torch.from_numpy(x)),
          jlayers.mlp_apply(lp["mlp"], jcfg, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# llama SMOKE: prefill logits and cache, then four decode steps

# f32 through 2 layers and a 256-way unembedding
TOL = 1e-4


@pytest.mark.parametrize("path", PORT_PATHS)
def test_llama_lm_apply_and_cache_match_jax(ref_model, path):
    cfg = port_cfg(path)
    params = params_from_numpy(ref_model["np_params"], cfg, device="cpu")
    tokens = torch.from_numpy(ref_model["tokens"].astype(np.int64))
    logits, _, cache = tlm.lm_apply(params, cfg, {"tokens": tokens},
                                    collect_cache=True)
    want_logits, want_cache = ref_model["prefill"]
    close(logits, want_logits, TOL)
    assert cache["pos"] == int(want_cache["pos"])
    assert cache["attn"]["k"].shape == want_cache["attn"]["k"].shape
    close(cache["attn"]["k"], want_cache["attn"]["k"], TOL)
    close(cache["attn"]["v"], want_cache["attn"]["v"], TOL)
    last, _, _ = tlm.lm_apply(params, cfg, {"tokens": tokens},
                              last_only=True)
    close(last[:, 0], want_logits[:, -1], TOL)


@pytest.mark.parametrize("path", PORT_PATHS)
def test_llama_four_decode_steps_match_jax(ref_model, path):
    cfg = port_cfg(path)
    params = params_from_numpy(ref_model["np_params"], cfg, device="cpu")
    tokens = torch.from_numpy(ref_model["tokens"].astype(np.int64))
    _, _, cache = tlm.lm_apply(params, cfg, {"tokens": tokens},
                               collect_cache=True)
    cache = tlm.pad_cache_seq(cache, len(ref_model["steps"]))
    for tok, want in zip(ref_model["steps"], ref_model["decoded"]):
        logits, cache = tlm.lm_decode(
            params, cfg, cache, {"tokens": torch.from_numpy(
                tok.astype(np.int64))})
        close(logits, want, TOL)
    final = ref_model["final"]
    assert cache["pos"] == int(final["pos"])
    close(cache["attn"]["k"], final["attn"]["k"], TOL)
    close(cache["attn"]["v"], final["attn"]["v"], TOL)
    with pytest.raises(ValueError, match="full"):
        tlm.lm_decode(params, cfg, cache, {"tokens": torch.zeros(
            (2, 1), dtype=torch.int64)})


def test_params_from_numpy_splits_the_dense_tree(ref_model):
    cfg = tllama.SMOKE
    np_params = ref_model["np_params"]
    out = params_from_numpy(np_params, cfg, device="cpu")
    assert set(out) == {"embed", "final_norm", "blocks"}     # tied head
    assert len(out["blocks"]) == cfg.n_layers
    for i, blk in enumerate(out["blocks"]):
        assert set(blk) == {"ln1", "attn", "ln2", "mlp"}
        assert set(blk["attn"]) == {"wq", "wk", "wv", "wo"}
        assert set(blk["mlp"]) == {"w_in", "w_gate", "w_out"}
        np.testing.assert_array_equal(blk["attn"]["wq"].numpy(),
                                      np_params["blocks"]["attn"]["wq"][i])
        np.testing.assert_array_equal(blk["ln2"].numpy(),
                                      np_params["blocks"]["ln2"][i])


def test_llama_init_params_follow_the_reference_tree(ref_model):
    cfg = tllama.SMOKE
    bundle = tlm.build_lm(cfg)
    params = tcommon.init_params(bundle.params_pspec,
                                 torch.Generator().manual_seed(0), cfg.dtype)
    ref_tree = params_from_numpy(ref_model["np_params"], cfg, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path
    got = {jax.tree_util.keystr(k): v for k, v in flat(params)}
    want = {jax.tree_util.keystr(k): v for k, v in flat(ref_tree)}
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    assert torch.all(params["blocks"][0]["ln1"] == 1)


def test_wrapper_runs_the_plain_version_on_cpu_and_differentiates():
    _, (tq, tk, tv) = arrays((2, 30, 4, 16), (2, 30, 2, 16), (2, 30, 2, 16),
                             seed=11)
    tkops.reset_launches()
    torch.testing.assert_close(
        tkops.attention(tq, tk, tv, window=7),
        tkops.attention_plain(tq, tk, tv, window=7), rtol=0, atol=0)
    assert tkops.launch_counts()["flash_attention"] == 0
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    g = torch.autograd.grad(tkops.attention(*ins).square().sum(), ins)
    ins2 = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    gr = torch.autograd.grad(tkops.attention_plain(*ins2).square().sum(),
                             ins2)
    for a, b in zip(g, gr):
        torch.testing.assert_close(a, b)

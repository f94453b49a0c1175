"""Parity of the PyTorch port's encoder-decoder (seamless-m4t) with the JAX
package.

The reference's weights (``init_params(PRNGKey(0))`` at the SMOKE config,
f32) go into the port through ``params_from_numpy``; frames and tokens are
made from numpy seeds. The reference runs under ``policy="fused"``, the port
on its default path (on a CPU tensor each kernel's plain version) and on
``fused`` and ``baseline``. Tolerances, of the largest absolute value of
the reference's tensor (``close``): the encoder's memory, the prefill's
logits and its four caches, 1e-5; three decode steps from the prefill's
self cache grown by ``pad_cache_seq`` (as the reference's engine grows it),
1e-5, and equal to a teacher-forced forward; ``encdec_loss`` rtol 1e-5 and
every gradient leaf rtol 1e-4, atol 1e-6 under each remat policy; one train
step's loss and grad norm rtol 1e-5.

Two limits of the reference are pinned where the port differs: its decode
on a full self cache clamps the write onto the last row (the port raises),
and its engine's wave fails on the missing ``frames`` key (the port raises a
``ValueError`` that names them, before any launch).
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

from repro.configs import seamless_m4t_medium as jseam
from repro.models import build as jbuild
from repro.models import encdec as jencdec
from repro.models.common import init_params
from repro.optim import OptConfig as JOptConfig
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import _pad_cache_seq
from repro.training import init_train_state as jinit_train_state
from repro.training import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import seamless_m4t_medium as tseam
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import build
from repro_torch.models import encdec as tencdec
from repro_torch.models.common import (
    params_from_numpy,
    params_to_numpy,
    tree_from_numpy,
)
from repro_torch.models.lm import pad_cache_seq
from repro_torch.optim import OptConfig
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.training import init_train_state, make_train_step

TOL = 1e-5
PORT_PATHS = ("tile", "fused", "baseline")
B, S_ENC, S_DEC = 2, 16, 12


def t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def reference(**overrides):
    """The reference's SMOKE bundle, params and numpy params (f32)."""
    cfg = dataclasses.replace(jseam.SMOKE, policy="fused", **overrides)
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    return bundle, params, jax.tree.map(np.asarray, params)


def port(policy=None, **overrides):
    cfg = dataclasses.replace(tseam.SMOKE, policy=policy, **overrides)
    return build(cfg), params_from_numpy(reference()[2], cfg, device="cpu")


def close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def np_batch(seed=0, s_enc=S_ENC, s_dec=S_DEC):
    rng = np.random.default_rng(seed)
    cfg = tseam.SMOKE
    return {"frames": rng.standard_normal(
                (B, s_enc, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, s_dec)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, s_dec)).astype(np.int32)}


def t_batch(batch):
    return {k: t(v).long() if v.dtype.kind == "i" else t(v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def ref_model():
    """The reference's memory, prefill (logits, cache) and three decode
    steps from its cache grown by three rows."""
    jb, params, _ = reference()
    cfg = jb.cfg
    batch = np_batch()
    steps = np.random.default_rng(1).integers(
        0, cfg.vocab, (3, B, 1)).astype(np.int32)
    memory = jax.jit(lambda p, f: jencdec.encode(p, cfg, f))(
        params, batch["frames"])
    logits, cache = jax.jit(jb.prefill)(params, batch)
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    cache = _pad_cache_seq(cache, len(steps))
    decoded = []
    decode = jax.jit(jb.decode)
    for tok in steps:
        lg, cache = decode(params, cache, {"tokens": tok})
        decoded.append(np.asarray(lg))
    return dict(batch=batch, steps=steps, memory=np.asarray(memory),
                prefill=prefill, decoded=decoded,
                final=jax.tree.map(np.asarray, cache))


def assert_cache_close(tc, jc):
    assert set(tc) == set(jc)
    for k, want in jc.items():
        if k == "pos":
            assert tc[k] == int(want)
        else:
            close(tc[k], want)


# ---------------------------------------------------------------------------
# the forward, its cache and decode


@pytest.mark.parametrize("path", PORT_PATHS)
def test_encode_matches_jax(path):
    bundle, params = port(path)
    ref = ref_model()
    close(tencdec.encode(params, bundle.cfg, t(ref["batch"]["frames"])),
          ref["memory"])


@pytest.mark.parametrize("path", PORT_PATHS)
def test_prefill_and_decode_match_jax(path):
    """The prefill's logits of every position and its four caches, then
    three decode steps from the self cache grown by three rows: each step's
    logits and the final caches."""
    bundle, params = port(path)
    ref = ref_model()
    logits, cache = tencdec.encdec_prefill(params, bundle.cfg,
                                           t_batch(ref["batch"]))
    close(logits, ref["prefill"][0])
    assert_cache_close(cache, ref["prefill"][1])
    cache = pad_cache_seq(cache, len(ref["steps"]))
    for tok, want in zip(ref["steps"], ref["decoded"]):
        lg, cache = bundle.decode(params, cache, {"tokens": t(tok).long()})
        close(lg, want)
    assert_cache_close(cache, ref["final"])


def test_decode_equals_teacher_forced_forward():
    """The logits of each decode step equal the decoder's forward over the
    prompt and the decoded tokens at that position; ``prefill_last`` gives
    the forward's last position."""
    bundle, params = port()
    cfg = bundle.cfg
    ref = ref_model()
    batch = t_batch(ref["batch"])
    steps = t(ref["steps"]).long()
    memory = tencdec.encode(params, cfg, batch["frames"])
    full = torch.cat([batch["tokens"], *steps], dim=1)
    want, _ = tencdec.decode_train(params, cfg, full, memory)
    last, cache = bundle.prefill_last(params, {"frames": batch["frames"],
                                               "tokens": batch["tokens"]})
    close(last, want[:, S_DEC - 1:S_DEC].numpy())
    cache = pad_cache_seq(cache, len(steps))
    for i, tok in enumerate(steps):
        lg, cache = bundle.decode(params, cache, {"tokens": tok})
        close(lg, want[:, S_DEC + i:S_DEC + i + 1].numpy())


def test_decode_on_a_full_self_cache_raises():
    """The prefill's self cache holds the prompt's positions only: a decode
    step needs it grown first. The port raises; the reference clamps the
    write onto the last row and its logits leave the forward's."""
    bundle, params = port()
    ref = ref_model()
    batch = t_batch(ref["batch"])
    _, cache = bundle.prefill_last(params, batch)
    with pytest.raises(ValueError, match="pad_cache_seq"):
        bundle.decode(params, cache, {"tokens": t(ref["steps"][0]).long()})
    jb, jp, _ = reference()
    _, jc = jb.prefill(jp, ref["batch"])
    got, _ = jb.decode(jp, jc, {"tokens": ref["steps"][0]})
    assert np.abs(np.asarray(got) - ref["decoded"][0]).max() > 1e-3


def test_cross_attention_sees_every_memory_row():
    """Cross-attention has no causal mask and no rope: the decoder's output
    at its first position moves with the last memory row, and the same
    memory rows in another order give the same logits."""
    bundle, params = port()
    cfg = bundle.cfg
    batch = t_batch(np_batch())
    memory = tencdec.encode(params, cfg, batch["frames"])
    base, _ = tencdec.decode_train(params, cfg, batch["tokens"], memory)
    moved = memory.clone()
    moved[:, -1] += 1.0
    got, _ = tencdec.decode_train(params, cfg, batch["tokens"], moved)
    assert (got[:, 0] - base[:, 0]).abs().max() > 1e-4
    perm = torch.randperm(S_ENC, generator=torch.Generator().manual_seed(0))
    got, _ = tencdec.decode_train(params, cfg, batch["tokens"],
                                  memory[:, perm])
    torch.testing.assert_close(got, base, rtol=1e-5, atol=1e-5)


def test_cache_pspec_matches_reference():
    def shapes(tr):
        def leaf(ps):
            dt = ps.dtype
            name = (None if dt is None else str(dt).split(".")[-1]
                    if isinstance(dt, torch.dtype) else np.dtype(dt).name)
            return tuple(ps.shape), name
        return jax.tree.map(leaf, tr, is_leaf=lambda x: hasattr(x, "shape"))

    want = shapes(jbuild(jseam.SMOKE).cache_pspec(3, 32))
    bundle = build(tseam.SMOKE)
    assert shapes(bundle.cache_pspec(3, 32)) == want
    with pytest.raises(ValueError, match="paged"):
        bundle.cache_pspec(3, 32, per_slot_pos=True, kind="paged")
    with pytest.raises(ValueError, match="continuous"):
        bundle.cache_pspec(3, 32, per_slot_pos=True)
    assert bundle.decode_block is None and bundle.decode_block_paged is None


def test_prefill_without_frames_raises_before_any_launch():
    bundle, params = port()
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frames"):
        bundle.prefill_last(params, {"tokens": tokens})


# ---------------------------------------------------------------------------
# the engine


def test_engine_falls_back_to_the_wave_and_raises_on_frames():
    """The reference's ``test_encdec_falls_back_to_wave``: asked for the
    continuous scheduler (and the paged cache), the engine warns and runs
    the wave; the wave's prefill has no frames to give, so the reference
    fails on the key and the port raises a ``ValueError`` naming them,
    before any prefill."""
    jb, jp, _ = reference()
    reqs = [(0, np.arange(5, 14, dtype=np.int32), 3)]
    for kind in ("ring", "paged"):
        with pytest.warns(UserWarning, match="falling back"):
            jeng = JServingEngine(jb, jp, JServeConfig(
                slots=2, max_new=3, scheduler="continuous", cache_kind=kind,
                policy="fused"))
        assert jeng.scheduler == "wave"
        tb, tp = port()
        with pytest.warns(UserWarning, match="falling back"):
            teng = ServingEngine(tb, tp, ServeConfig(
                slots=2, max_new=3, scheduler="continuous", cache_kind=kind))
        assert teng.scheduler == "wave"
        assert teng.cfg.cache_kind == "ring"
        with pytest.raises(KeyError, match="frames"):
            jeng.run([JRequest(uid=u, prompt=p, max_new=m)
                      for u, p, m in reqs])
        with pytest.raises(ValueError, match="frames"):
            teng.run([Request(uid=u, prompt=p, max_new=m)
                      for u, p, m in reqs])
        assert teng.prefills == 0


def test_serve_cli_raises_the_engines_error():
    with pytest.warns(UserWarning, match="falling back"):
        with pytest.raises(ValueError, match="frames"):
            tserve.main(["--arch", "seamless-m4t-medium", "--config",
                         "smoke", "--device", "cpu", "--requests", "2",
                         "--max-new", "2", "--prompt-len", "8"])


# ---------------------------------------------------------------------------
# training


@functools.lru_cache(maxsize=None)
def reference_grads(remat):
    jb, _, npp = reference(remat_policy=remat)
    params = jax.tree.map(jnp.asarray, npp)
    batch = np_batch(seed=2)
    loss, grads = jax.jit(jax.value_and_grad(jb.loss))(params, batch)
    return batch, float(loss), grads


@pytest.mark.parametrize("remat", ["off", "none", "dots"])
def test_loss_and_gradients_match_jax(remat):
    """``encdec_loss`` within rtol 1e-5 and every gradient leaf of the
    stacked ``enc`` and ``dec`` parameters within rtol 1e-4, atol 1e-6 of
    ``jax.grad`` of the reference's ``bundle.loss`` under the same remat
    policy."""
    batch, want_loss, want_grads = reference_grads(remat)
    bundle = build(dataclasses.replace(tseam.SMOKE, remat_policy=remat))
    params = tree_from_numpy(reference()[2], device="cpu")
    leaves = [v.requires_grad_() for v in tree.leaves(params)]
    got = bundle.loss(params, t_batch(batch))
    np.testing.assert_allclose(got.item(), want_loss, rtol=1e-5)
    grads = tree.unflatten(params, torch.autograd.grad(got, leaves))
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(want_grads)}
    got_g = dict(tree.items(grads))
    assert got_g.keys() == want.keys()
    assert any(k.startswith("['enc']") for k in got_g)
    assert any("['xattn']" in k for k in got_g)
    for k, v in got_g.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_remat_relaunches_each_layer_in_backward():
    """Under remat ``none`` the backward runs each encoder and decoder layer
    again: the attention and RMSNorm calls of the loss's backward are those
    of the forward's layers (the final norms are not recomputed)."""
    from repro_torch.core import dispatch

    counts = {"attention": 0, "rmsnorm": 0}
    real = {k: getattr(dispatch, k) for k in counts}

    def counted(name):
        def fn(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return fn

    cfg = dataclasses.replace(tseam.SMOKE, remat_policy="none")
    bundle = build(cfg)
    params = tree_from_numpy(reference()[2], device="cpu")
    leaves = [v.requires_grad_() for v in tree.leaves(params)]
    for k in counts:
        setattr(dispatch, k, counted(k))
    try:
        loss = bundle.loss(params, t_batch(np_batch(seed=2)))
        fwd = dict(counts)
        torch.autograd.grad(loss, leaves)
    finally:
        for k, fn in real.items():
            setattr(dispatch, k, fn)
    ne, nd = cfg.enc_layers, cfg.n_layers
    assert fwd == {"attention": ne + 2 * nd, "rmsnorm": 2 * ne + 3 * nd + 2}
    assert counts["attention"] == 2 * fwd["attention"]
    assert counts["rmsnorm"] == 2 * fwd["rmsnorm"] - 2


def test_train_step_matches_jax():
    """One AdamW step from the reference's train state: loss and grad norm
    rtol 1e-5, the step counter advanced."""
    opt_kw = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=100)
    jb = jbuild(jseam.SMOKE)
    jopt = JOptConfig(policy="fused", **opt_kw)
    jstate = jinit_train_state(jax.random.PRNGKey(0), jb, jopt)
    batch = np_batch(seed=3)
    _, jm = jax.jit(jmake_train_step(jb, jopt))(jstate, batch)
    np_state = jax.tree.map(np.asarray, jstate)
    rng = np_state.pop("rng")
    tstate = tree_from_numpy(np_state, device="cpu")
    tstate["rng"] = rng
    new, tm = make_train_step(build(tseam.SMOKE), OptConfig(**opt_kw))(
        tstate, t_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(new["opt"]["step"]) == 1


# ---------------------------------------------------------------------------
# parameters, checkpoints, configs and the train CLI


def test_params_carry_enc_and_dec_both_ways():
    npp = reference()[2]
    cfg = tseam.SMOKE
    params = params_from_numpy(npp, cfg, device="cpu")
    assert len(params["enc"]) == cfg.enc_layers
    assert len(params["dec"]) == cfg.n_layers
    assert set(params["dec"][0]) == {"ln1", "attn", "lnx", "xattn", "ln2",
                                     "mlp"}
    back = params_to_numpy(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(npp))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        assert np.array_equal(got[k], v), k


def test_checkpoint_round_trip_keeps_enc_and_dec(tmp_path):
    """The port's train state through the checkpointer: its leaf keys are
    the reference's train state's (``enc`` and ``dec`` stacked), restored
    bit for bit, and a step from the restored state equals a step from the
    state in memory."""
    bundle = build(tseam.SMOKE)
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    state = init_train_state(torch.Generator().manual_seed(0), bundle,
                             opt_cfg)
    assert state["params"]["enc"]["attn"]["wq"].shape[0] == \
        tseam.SMOKE.enc_layers
    ckpt.save(str(tmp_path), 1, state)
    with open(tmp_path / "step_1" / "manifest.json") as f:
        keys = set(json.load(f)["leaves"])
    jstate = jinit_train_state(jax.random.PRNGKey(0), jbuild(jseam.SMOKE),
                               JOptConfig())
    want = {jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_leaves_with_path(jstate) if k[0].key != "rng"}
    assert want <= keys
    assert any("['enc']" in k for k in keys)
    assert any("['dec']['xattn']" in k for k in keys)
    restored = ckpt.restore(str(tmp_path), 1, state)
    for (k, a), b in zip(tree.items(state), tree.leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    batch = t_batch(np_batch(seed=4))
    step = make_train_step(bundle, opt_cfg)
    s_a, m_a = step(state, batch)
    s_b, m_b = step(restored, batch)
    assert m_a["loss"].item() == m_b["loss"].item()
    for a, b in zip(tree.leaves(s_a["params"]), tree.leaves(s_b["params"])):
        assert torch.equal(a, b)


ENCDEC_FIELDS = ("name", "family", "n_layers", "enc_layers", "d_model",
                 "vocab", "n_heads", "n_kv_heads", "head_dim", "dh", "d_ff",
                 "rope_theta", "norm_eps", "swa_window", "tie_embeddings",
                 "remat_policy")


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
def test_config_and_count_match_the_reference(size):
    from repro import configs as jconfigs

    jc = getattr(jconfigs.get("seamless-m4t-medium"), size)
    tc = getattr(tconfigs.get("seamless-m4t-medium"), size)
    for field in ENCDEC_FIELDS:
        assert getattr(tc, field) == getattr(jc, field), field
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    assert build(tc).n_params == jbuild(jc).n_params
    if size == "FULL":          # the whole model: 1.96 GB in bf16
        assert build(tc).n_params == 977_758_208


def test_train_cli_on_cpu(tmp_path):
    """``launch/train.py`` feeds the encoder-decoder zero frames beside
    tokens and labels, as the reference's: finite losses, a checkpoint."""
    losses = ttrain.main(["--arch", "seamless-m4t-medium", "--config",
                          "smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "32", "--ckpt-dir",
                          str(tmp_path), "--resume", "none"])
    assert sorted(losses) == [0, 1]
    assert all(np.isfinite(v) for v in losses.values())
    assert ckpt.latest_step(str(tmp_path)) == 2

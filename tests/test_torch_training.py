"""Parity of the PyTorch port's training path with the JAX package.

llama3.2 and mamba2 SMOKE (f32): the reference's train state
(``init_train_state(PRNGKey(0))``) is carried into the port as numpy with
``tree_from_numpy``; both packages see the same numpy batch (the reference's
``smoke_batch``, whose labels equal its tokens). The reference runs jitted on
the CPU under ``policy="fused"``; the port on its default path, each
kernel's plain version on a CPU tensor, the SSD's backward through
``core/ssd.py::ssd_chunked``. Tolerances are stated at each test; the
reference's own training tests are mirrored at the end with theirs.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.common import smoke_batch
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.optim import OptConfig as JOptConfig
from repro.optim import global_norm as jglobal_norm
from repro.optim import lr_at as jlr_at
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as jinit_train_state
from repro.training import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_lm
from repro_torch.models import common as tcommon
from repro_torch.optim import (
    OptConfig,
    adamw_update,
    compress_grads,
    global_norm,
    init_opt_state,
    lr_at,
    stochastic_round_bf16,
)
from repro_torch.optim.adafactor import adafactor_update, init_adafactor_state
from repro_torch.training import TrainConfig, init_train_state, make_train_step

ARCHS = ("llama3.2-1b", "mamba2-1.3b")


def jax_cfg(arch):
    return dataclasses.replace(jconfigs.get(arch).SMOKE, policy="fused")


def port_cfg(arch, **kw):
    return dataclasses.replace(tconfigs.get(arch).SMOKE, **kw)


def np_batch(arch):
    return jax.tree.map(np.asarray, smoke_batch(jconfigs.get(arch).SMOKE))


def t_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def state_to_port(jstate):
    """The reference's train state -> the port's (rng stays numpy)."""
    np_state = jax.tree.map(np.asarray, jstate)
    rng = np_state.pop("rng")
    out = tcommon.tree_from_numpy(np_state, device="cpu")
    out["rng"] = rng
    return out


def assert_tree_close(got, want, rtol, atol):
    """Every leaf of the port's tree against the reference's, by keystr."""
    want = {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_leaves_with_path(want)}
    got = dict(tree.items(got))
    assert got.keys() == want.keys()
    for k, v in got.items():
        v = torch.as_tensor(v)
        np.testing.assert_allclose(v.float().numpy(), want[k], rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# loss and gradients


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tcommon.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def reference_grads(arch):
    """The reference's loss and gradient at its initial params."""
    jbundle = jbuild(jax_cfg(arch))
    params = jcommon.init_params(jax.random.PRNGKey(0), jbundle.params_pspec,
                                 jnp.float32)
    batch = np_batch(arch)
    loss, grads = jax.jit(jax.value_and_grad(jbundle.loss))(params, batch)
    return dict(arch=arch, params=jax.tree.map(np.asarray, params),
                batch=batch, loss=float(loss), grads=grads)


@pytest.fixture(params=ARCHS)
def ref_grads(request):
    return reference_grads(request.param)


def port_loss_grads(arch, np_params, batch, **cfg_kw):
    bundle = build_lm(port_cfg(arch, **cfg_kw))
    params = tcommon.tree_from_numpy(np_params, device="cpu")
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    loss = bundle.loss(params, t_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    return loss, tree.unflatten(params, grads)


def test_lm_loss_and_gradients_match_jax(ref_grads):
    """Loss within rtol 1e-5, every gradient leaf within rtol 1e-4, atol
    1e-6 of ``jax.grad(bundle.loss)`` (mamba: the SSD backward through the
    chunked form)."""
    loss, grads = port_loss_grads(ref_grads["arch"], ref_grads["params"],
                                  ref_grads["batch"])
    np.testing.assert_allclose(loss.item(), ref_grads["loss"], rtol=1e-5)
    assert_tree_close(grads, ref_grads["grads"], rtol=1e-4, atol=1e-6)


def test_remat_policies_give_the_same_gradients(ref_grads):
    """Remat ``off``, ``none`` and ``dots`` recompute the same f32 ops in
    the same order: rtol 1e-6."""
    base = None
    for policy in ("off", "none", "dots"):
        loss, grads = port_loss_grads(ref_grads["arch"], ref_grads["params"],
                                      ref_grads["batch"],
                                      remat_policy=policy)
        flat = [g.numpy() for g in tree.leaves(grads)]
        if base is None:
            base = (loss.item(), flat)
            continue
        np.testing.assert_allclose(loss.item(), base[0], rtol=1e-6)
        for a, b in zip(flat, base[1]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


def test_remat_relaunches_each_layer_in_backward():
    """Under ``none`` each layer's forward runs again in backward: the
    RMSNorm wrapper is called 2L + 1 times forward and 2L more in
    backward (under ``tile``, which runs the wrappers; on a CPU tensor
    their plain versions)."""
    calls = []
    orig = tkops._rmsnorm_fwd

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    cfg = port_cfg("llama3.2-1b", remat_policy="none", policy="tile")
    bundle = build_lm(cfg)
    params = tcommon.init_params(tcommon.stack_pspec(bundle.params_pspec),
                                 torch.Generator().manual_seed(0),
                                 torch.float32, device="cpu")
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    tkops._rmsnorm_fwd = counting
    try:
        loss = bundle.loss(params, t_batch(np_batch("llama3.2-1b")))
        fwd = len(calls)
        torch.autograd.grad(loss, leaves)
    finally:
        tkops._rmsnorm_fwd = orig
    assert fwd == 2 * cfg.n_layers + 1
    assert len(calls) == fwd + 2 * cfg.n_layers


@pytest.mark.parametrize("seqlen", [20, 128, 300])
def test_ssd_backward_through_chunked_form_matches_the_loop(seqlen):
    """The SSD wrapper's gradient (``ssd_chunked`` in f32, chunks of 128,
    a ragged last chunk at 20 and 300) against the gradient of the
    per-token loop ``ssd_scan_ref``: rtol 1e-4, and 1e-6 of the input's
    largest gradient where an element is near zero (f32 sums over the
    sequence in two orders)."""
    rng = np.random.default_rng(seqlen)
    b, h, p, g, n = 2, 4, 8, 2, 8
    x = rng.standard_normal((b, seqlen, h, p)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((b, seqlen, h))).astype(np.float32)
    a = -(0.5 + rng.random(h)).astype(np.float32)
    bm = rng.standard_normal((b, seqlen, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, seqlen, g, n)).astype(np.float32)
    wy = rng.standard_normal((b, seqlen, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def grads(fn):
        ins = [torch.from_numpy(t).requires_grad_()
               for t in (x, dt, a, bm, cm)]
        y, st = fn(*ins, return_state=True)
        obj = (y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(
            ws)).sum()
        return torch.autograd.grad(obj, ins)

    for got, want in zip(grads(tkops.ssd_scan), grads(tref.ssd_scan_ref)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# optimizer pieces against the reference


def test_lr_schedule_matches_jax():
    for kw in (dict(), dict(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                            min_lr_ratio=0.1),
               dict(warmup_steps=0, decay_steps=30)):
        jcfg, tcfg = JOptConfig(**kw), OptConfig(**kw)
        steps = np.arange(tcfg.decay_steps + 11, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jlr_at(jcfg, s))(steps))
        got = lr_at(tcfg, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("path", ["tile", "fused", "baseline"])
def test_global_norm_matches_jax(path):
    """Each path of the port (``tile``: the kernel's plain version on the
    CPU) against the reference's global norm: rtol 1e-6."""
    rng = np.random.default_rng(3)
    leaves = {"a": rng.standard_normal((7, 11)), "b": rng.standard_normal(5),
              "c": {"d": rng.standard_normal((3, 4, 300))},
              "e": np.float32(2.5)}
    leaves = jax.tree.map(lambda v: np.asarray(v, np.float32), leaves)
    want = float(jglobal_norm(jax.tree.map(jnp.asarray, leaves),
                              policy="baseline"))
    got = global_norm(tree.map_tree(torch.from_numpy, leaves), policy=path)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# one train step against the reference's


STEP_CASES = [
    ("llama3.2-1b", dict()),
    ("llama3.2-1b", dict(optimizer="adafactor")),
    ("llama3.2-1b", dict(microbatches=2)),
    ("mamba2-1.3b", dict()),
    ("mamba2-1.3b", dict(optimizer="adafactor")),
    ("mamba2-1.3b", dict(microbatches=2)),
]


def one_step(arch, train_kw, opt_kw=None, state_dtype=(jnp.float32,
                                                       torch.float32)):
    opt_kw = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=100,
                  **(opt_kw or {}))
    jbundle = jbuild(jax_cfg(arch))
    jopt = JOptConfig(state_dtype=state_dtype[0], policy="fused", **opt_kw)
    jtc = JTrainConfig(**train_kw)
    jstate = jinit_train_state(jax.random.PRNGKey(0), jbundle, jopt, jtc)
    tstate = state_to_port(jstate)
    batch = np_batch(arch)
    jnew, jm = jax.jit(jmake_train_step(jbundle, jopt, jtc))(jstate, batch)
    # init_train_state draws the params reference_grads holds
    jnew = dict(jnew, grads=reference_grads(arch)["grads"])

    tbundle = build_lm(port_cfg(arch))
    topt = OptConfig(state_dtype=state_dtype[1], **opt_kw)
    tnew, tm = make_train_step(tbundle, topt, TrainConfig(**train_kw))(
        tstate, t_batch(batch))
    return jnew, jm, tnew, tm, tstate


def assert_adamw_params_close(tnew, jnew, jm, opt_cfg):
    """The params after AdamW's first step: rtol 1e-5, atol 1e-6, plus what
    the update's conditioning adds. The first update is ``lr g / (|g| +
    eps)`` (g the clipped gradient, ``m / (1 - b1)``); where g moves by at
    most dg (the gradients' own tolerance, rtol 1e-4, atol 1e-6, as held
    above) it moves by at most ``lr eps dg / (max(|g| - dg, 0) + eps)^2``
    and ``2 lr``: nothing where |g| is far above dg and eps, up to two
    updates where the sign of g is not determined."""
    lr, eps = float(jm["lr"]), opt_cfg["eps"]
    want_m = {jax.tree_util.keystr(k): np.asarray(v, np.float64) for k, v in
              jax.tree_util.tree_leaves_with_path(jnew["opt"]["m"])}
    want_p = {jax.tree_util.keystr(k): np.asarray(v, np.float64) for k, v in
              jax.tree_util.tree_leaves_with_path(jnew["params"])}
    for k, got in tree.items(tnew["params"]):
        g = np.abs(want_m[k]) / (1 - 0.9)
        dg = 1e-4 * g + 1e-6
        slack = lr * np.minimum(
            2.0, eps * dg / (np.maximum(g - dg, 0.0) + eps) ** 2)
        err = np.abs(got.double().numpy() - want_p[k])
        bound = 1e-6 + 1e-5 * np.abs(want_p[k]) + slack
        assert np.all(err <= bound), (k, float(np.max(err - bound)))


def assert_adafactor_m_close(tnew, jnew, jm):
    """Adafactor's momentum after its first step, ``(1 - b1) u`` with ``u =
    g / denom`` RMS-clipped: rtol 1e-5, atol 1e-6, plus the gradient's
    difference, bounded by 1e-4 of the leaf's largest gradient, through
    ``(1 - b1) / denom``: a leaf whose gradients are near ``sqrt(eps)`` is
    normalised by about that much."""
    scale = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v, np.float64)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    grads, want_m = flat(jnew["grads"]), flat(jnew["opt"]["m"])
    v = flat(jnew["opt"]["v"])
    for k, got in tree.items(tnew["opt"]["m"]):
        if k + "['vr']" in v:
            vr, vc = v[k + "['vr']"], v[k + "['vc']"]
            denom = np.sqrt(vr[..., None] * vc[..., None, :]
                            / vr.mean(-1, keepdims=True)[..., None] + 1e-8)
        else:
            denom = np.sqrt(v[k + "['v']"]) + 1e-8
        slack = 0.1 * 1e-4 * scale * np.abs(grads[k]).max() / denom
        err = np.abs(got.double().numpy() - want_m[k])
        bound = 1e-6 + 1e-5 * np.abs(want_m[k]) + slack
        assert np.all(err <= bound), (k, float(np.max(err - bound)))


@pytest.mark.parametrize("arch,train_kw", STEP_CASES)
def test_train_step_matches_jax(arch, train_kw):
    """The metrics, v and step after one step (AdamW, Adafactor, two
    microbatches): rtol 1e-5, atol 1e-6; AdamW's m and Adafactor's params
    the same. AdamW's params and Adafactor's m normalise the gradient, so
    they are held to that plus what the gradients' own difference becomes
    (:func:`assert_adamw_params_close`, :func:`assert_adafactor_m_close`);
    :func:`test_optimizer_update_matches_jax` holds the updates at rtol
    1e-5, atol 1e-6 on equal gradients. The state passed in is left as it
    was."""
    jnew, jm, tnew, tm, tstate = one_step(arch, train_kw)
    before = [t.clone() for t in tree.leaves(tstate["params"])]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    if train_kw.get("optimizer") == "adafactor":
        assert_tree_close(tnew["params"], jnew["params"], rtol=1e-5,
                          atol=1e-6)
        assert_tree_close(tnew["opt"]["v"], jnew["opt"]["v"], rtol=1e-5,
                          atol=1e-6)
        assert_adafactor_m_close(tnew, jnew, jm)
    else:
        assert_adamw_params_close(tnew, jnew, jm, dict(eps=1e-8))
        assert_tree_close(tnew["opt"]["m"], jnew["opt"]["m"], rtol=1e-5,
                          atol=1e-6)
        assert_tree_close(tnew["opt"]["v"], jnew["opt"]["v"], rtol=1e-5,
                          atol=1e-6)
    assert tnew["opt"]["step"].dtype == torch.int32
    assert tnew["opt"]["step"].item() == 1
    for a, b in zip(before, tree.leaves(tstate["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(arch, optimizer):
    """One update of each optimizer from the same params, moments and
    gradients (the reference's at init, scaled so the clip acts) in both
    packages: params, m, v, step, grad_norm and lr at rtol 1e-5, atol
    1e-6."""
    from repro.optim.adafactor import adafactor_update as jadafactor
    from repro.optim.adafactor import init_adafactor_state as jinit_af
    from repro.optim.adamw import adamw_update as jadamw
    from repro.optim.adamw import init_opt_state as jinit_opt

    ref_grads = reference_grads(arch)
    kw = dict(peak_lr=1e-3, warmup_steps=3, decay_steps=100)
    jcfg, tcfg = JOptConfig(policy="baseline", **kw), OptConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, ref_grads["params"])
    jg = jax.tree.map(lambda g: 3.0 * g, ref_grads["grads"])
    jinit, jupd = ((jinit_af, jadafactor) if optimizer == "adafactor"
                   else (jinit_opt, jadamw))
    tinit, tupd = ((init_adafactor_state, adafactor_update)
                   if optimizer == "adafactor"
                   else (init_opt_state, adamw_update))
    jp, jopt, jm = jax.jit(lambda g, o, p: jupd(g, o, p, jcfg))(
        jg, jinit(jparams, jcfg), jparams)
    tparams = tcommon.tree_from_numpy(ref_grads["params"], device="cpu")
    tg = tcommon.tree_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    tp, topt, tm = tupd(tg, tinit(tparams, tcfg), tparams, tcfg)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5)
    assert_tree_close(tp, jp, rtol=1e-5, atol=1e-6)
    assert_tree_close(topt, jopt, rtol=1e-5, atol=1e-6)


def test_bf16_moments_stay_bf16_and_match_jax():
    """``state_dtype=torch.bfloat16``: m and v are bf16 after the step and
    equal the reference's bf16 moments within one bf16 rounding (rtol
    2^-7), or the gradients' own tolerance where a moment is tiny; the f32
    params as in :func:`test_train_step_matches_jax`."""
    jnew, jm, tnew, _, _ = one_step("llama3.2-1b", {},
                                    state_dtype=(jnp.bfloat16,
                                                 torch.bfloat16))
    for t in tree.leaves({"m": tnew["opt"]["m"], "v": tnew["opt"]["v"]}):
        assert t.dtype == torch.bfloat16
    # one bf16 rounding, or the gradients' atol (1e-6) through (1 - b1)
    # and (1 - b2) * 2 |g|
    assert_tree_close(tnew["opt"]["m"], jnew["opt"]["m"], rtol=2 ** -7,
                      atol=1e-7)
    assert_tree_close(tnew["opt"]["v"], jnew["opt"]["v"], rtol=2 ** -7,
                      atol=1e-10)
    assert_adamw_params_close(tnew, jnew, jm, dict(eps=1e-8))


def test_params_to_numpy_inverts_params_from_numpy():
    """The reference's stacked tree -> the port's per-layer list -> back:
    equal arrays, the reference's keys and shapes; a stacked (train state)
    tree comes back as it is."""
    for arch in ARCHS:
        np_params = reference_grads(arch)["params"]
        cfg = port_cfg(arch)
        port = tcommon.params_from_numpy(np_params, cfg, device="cpu")
        assert isinstance(port["blocks"], list)
        for back in (tcommon.params_to_numpy(port),
                     tcommon.params_to_numpy(tcommon.tree_from_numpy(
                         np_params, device="cpu"))):
            want = {jax.tree_util.keystr(k): v for k, v in
                    jax.tree_util.tree_leaves_with_path(np_params)}
            got = dict(tree.items(back))
            assert got.keys() == want.keys()
            for k, v in got.items():
                np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_train_state_layout_is_the_reference():
    """init_train_state: the reference's keys, stacked shapes and dtypes."""
    for arch in ARCHS:
        jbundle = jbuild(jax_cfg(arch))
        jstate = jax.eval_shape(lambda: jinit_train_state(
            jax.random.PRNGKey(0), jbundle, JOptConfig()))
        tstate = init_train_state(torch.Generator().manual_seed(0),
                                  build_lm(port_cfg(arch)), OptConfig())
        want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in jax.tree_util.tree_leaves_with_path(jstate)}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in tree.items(tstate)}
        assert got == want
        np.testing.assert_array_equal(tstate["rng"], np.asarray(
            jax.random.PRNGKey(17)))


# ---------------------------------------------------------------------------
# the reference's training tests (tests/test_training.py), on the port


def test_lr_schedule():
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                    min_lr_ratio=0.1)
    assert lr_at(cfg, 0).item() == 0.0
    assert np.isclose(lr_at(cfg, 10).item(), 1e-3)
    assert np.isclose(lr_at(cfg, 100).item(), 1e-4, rtol=1e-3)
    mid = lr_at(cfg, 55).item()
    assert 1e-4 < mid < 1e-3


def test_global_norm_matmul_form():
    t = {"a": torch.ones((7, 11)), "b": -2.0 * torch.ones((5,))}
    want = np.sqrt(7 * 11 * 1.0 + 5 * 4.0)
    np.testing.assert_allclose(global_norm(t).item(), want, rtol=1e-5)


def test_adamw_scalar_reference():
    """One AdamW step on a scalar against the textbook update."""
    cfg = OptConfig(peak_lr=1e-1, warmup_steps=0, decay_steps=10**9,
                    b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                    clip_norm=1e9)
    p = {"w": torch.tensor(2.0)}
    g = {"w": torch.tensor(0.5)}
    state = init_opt_state(p, cfg)
    new_p, state, _ = adamw_update(g, state, p, cfg)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    update = (m / 0.1) / (np.sqrt(v / 0.01) + 1e-8)
    np.testing.assert_allclose(new_p["w"].item(), 2.0 - 0.1 * update,
                               rtol=1e-5)


def test_adamw_weight_decay_decoupled():
    cfg = OptConfig(peak_lr=1e-1, warmup_steps=0, decay_steps=10**9,
                    weight_decay=0.1, clip_norm=1e9)
    p = {"w": torch.tensor(1.0)}
    g = {"w": torch.tensor(0.0)}
    state = init_opt_state(p, cfg)
    new_p, _, _ = adamw_update(g, state, p, cfg)
    # zero grad: only decay acts -> w - lr * wd * w
    np.testing.assert_allclose(new_p["w"].item(), 1.0 - 0.1 * 0.1 * 1.0,
                               rtol=1e-5)


def test_grad_clipping():
    cfg = OptConfig(peak_lr=0.0, clip_norm=1.0)
    p = {"w": torch.ones((100,))}
    g = {"w": 10.0 * torch.ones((100,))}
    state = init_opt_state(p, cfg)
    _, _, metrics = adamw_update(g, state, p, cfg)
    np.testing.assert_allclose(metrics["grad_norm"].item(), 100.0,
                               rtol=1e-4)


def test_adafactor_memory_factored():
    p = {"w": torch.ones((16, 32)), "b": torch.ones((8,))}
    cfg = OptConfig()
    st = init_adafactor_state(p, cfg)
    assert st["v"]["w"]["vr"].shape == (16,)
    assert st["v"]["w"]["vc"].shape == (32,)
    assert st["v"]["b"]["v"].shape == (8,)
    g = {"w": 0.1 * torch.ones((16, 32)), "b": 0.1 * torch.ones((8,))}
    new_p, st2, m = adafactor_update(g, st, p, cfg)
    assert np.isfinite(m["grad_norm"].item())
    assert bool(torch.all(new_p["w"] < p["w"]))   # positive grad -> decrease


def test_stochastic_round_unbiased():
    """x exactly a quarter of the way between two bf16 values: the mean of
    8 x 20000 draws is within 3 sigma of x (sigma: the bf16 spacing times
    sqrt(p (1 - p) / draws), p = 1/4)."""
    x = torch.full((20000,), 1.0 + 2.0 ** -9)
    gens = [torch.Generator().manual_seed(s) for s in range(8)]
    draws = torch.stack([stochastic_round_bf16(x, g).float() for g in gens])
    assert set(torch.unique(draws).tolist()) == {1.0, 1.0 + 2.0 ** -7}
    sigma = 2.0 ** -7 * np.sqrt(0.25 * 0.75 / draws.numel())
    assert abs(draws.double().mean().item() - (1.0 + 2.0 ** -9)) < 3 * sigma


def test_stochastic_round_keeps_sign_and_exact_values():
    """The int32 bit trick: negative values round between their own bf16
    neighbours, and bf16-exact values come back unchanged."""
    gen = torch.Generator().manual_seed(0)
    exact = torch.tensor([0.0, -0.0, 1.0, -2.5, 3.0e38, -1.0e-38]).bfloat16(
    ).float()
    assert torch.equal(stochastic_round_bf16(exact, gen).float(), exact)
    x = torch.full((4096,), -(1.0 + 2.0 ** -9))
    got = stochastic_round_bf16(x, gen).float()
    assert set(torch.unique(got).tolist()) == {-1.0, -(1.0 + 2.0 ** -7)}


def test_compress_error_feedback_closes():
    """grads + error_buffer must telescope: q_t + e_t == g_t + e_{t-1}."""
    g = {"w": 1.0 + torch.arange(100, dtype=torch.float32) * 1e-4}
    q, e = compress_grads(g, None, torch.Generator().manual_seed(0))
    recon = q["w"].float() + e["w"]
    np.testing.assert_allclose(recon.numpy(), g["w"].numpy(), rtol=1e-6)


def test_grad_accumulation_equivalence():
    """microbatches=2 must match microbatches=1 (mean-of-means)."""
    bundle = build_lm(port_cfg("llama3.2-1b"))
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=100)
    batch = t_batch(np_batch("llama3.2-1b"))
    outs = {}
    for nmb in (1, 2):
        tc = TrainConfig(microbatches=nmb)
        state = init_train_state(torch.Generator().manual_seed(0), bundle,
                                 opt_cfg, tc)
        new_state, metrics = make_train_step(bundle, opt_cfg, tc)(state,
                                                                  batch)
        outs[nmb] = (metrics["loss"].item(),
                     tree.leaves(new_state["params"]))
    np.testing.assert_allclose(outs[1][0], outs[2][0], rtol=1e-5)
    for a, b in zip(outs[1][1], outs[2][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


def train_losses(steps, train_cfg=TrainConfig()):
    bundle = build_lm(port_cfg("llama3.2-1b"))
    opt_cfg = OptConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=40)
    state = init_train_state(torch.Generator().manual_seed(0), bundle,
                             opt_cfg, train_cfg)
    step = make_train_step(bundle, opt_cfg, train_cfg)
    batch = t_batch(np_batch("llama3.2-1b"))
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    return state, losses


def test_loss_decreases_20_steps():
    _, losses = train_losses(20)
    assert losses[-1] < losses[0] - 0.5, losses


def test_compressed_training_still_learns():
    state, losses = train_losses(15, TrainConfig(compress_grads=True))
    assert "err" in state
    assert not np.array_equal(state["rng"], np.array([0, 17], np.uint32))
    assert losses[-1] < losses[0] - 0.3, losses

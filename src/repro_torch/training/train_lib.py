"""Training step construction: mixed precision, grad accumulation,
gradient compression.

Counterpart of ``repro.training.train_lib``. State layout (what the
checkpointer saves, the reference's)::

    {"params": f32 master weights, "opt": {"m", "v", "step"},
     "rng": (2,) uint32 seed words}

with the block leaves stacked ``(n_layers, ...)`` as in the reference, so
the optimizer, the global norm and the checkpoint see the reference's
leaves.

Mixed precision: master params are f32; the loss casts each leaf to the
model's compute dtype once per step (bf16 on the card) and splits the
stacked leaves into the per-layer views the forward takes; the casts and
views are differentiable, so the f32 masters get f32 gradients. The
gradients come from ``torch.autograd.grad`` over the master leaves, and the
optimizer runs under ``torch.no_grad()``.

Gradient accumulation: ``microbatches > 1`` splits the batch on the
leading axis and folds the grads in a loop: memory for one microbatch's
activations, the same numerics as the reference (mean of means).

Gradient compression: with ``compress_grads=True`` the f32 grads pass
through bf16 stochastic rounding with an error-feedback buffer carried in
the state (``optim/compress.py``) before the optimizer; the noise comes
from a ``torch.Generator`` seeded by the state's ``rng`` words, which the
step advances.

``state_shape_structs`` and ``train_state_pspecs`` (the dry run and the
sharded state over ``repro_torch.parallel``'s rules and mesh) are not
ported yet (ROADMAP queue 1, item 4b).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models.common import cast_tree, init_params, stack_pspec
from repro_torch.models.lm import Bundle
from repro_torch.obs import runtime as _obs
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.optim.adafactor import adafactor_update, init_adafactor_state
from repro_torch.optim.compress import compress_grads as _compress

# the reference's initial key, jax.random.PRNGKey(17)
RNG_WORDS = (0, 17)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    optimizer: str = "adamw"                 # adamw | adafactor
    param_dtype: torch.dtype = torch.float32  # master weight dtype
    compress_grads: bool = False             # bf16 + error feedback


# ---------------------------------------------------------------------------
# state


def init_train_state(gen: torch.Generator, bundle: Bundle,
                     opt_cfg: OptConfig,
                     train_cfg: TrainConfig = TrainConfig()):
    """Params drawn from ``gen`` on its device, zero moments, step 0."""
    params = init_params(stack_pspec(bundle.params_pspec), gen,
                         train_cfg.param_dtype)
    if train_cfg.optimizer == "adafactor":
        opt = init_adafactor_state(params, opt_cfg)
    else:
        opt = init_opt_state(params, opt_cfg)
    state = {"params": params, "opt": opt,
             "rng": np.array(RNG_WORDS, np.uint32)}
    if train_cfg.compress_grads:
        state["err"] = tree.map_tree(torch.zeros_like, params)
    return state


def _split_rng(words: np.ndarray, device) -> tuple[np.ndarray,
                                                  torch.Generator]:
    """The state's seed words -> (next words, a generator on ``device``),
    a pure function of the words, as ``jax.random.split`` is of a key."""
    host = torch.Generator().manual_seed(
        (int(words[0]) << 32) | int(words[1]))
    nxt = torch.randint(0, 1 << 32, (4,), generator=host,
                        dtype=torch.int64).numpy().astype(np.uint32)
    sub = torch.Generator(device=device).manual_seed(
        (int(nxt[2]) << 32) | int(nxt[3]))
    return nxt[:2], sub


# ---------------------------------------------------------------------------
# steps


def value_and_grad(bundle: Bundle, params, batch):
    """-> (loss, grads): ``bundle.loss`` at ``params`` (f32 masters, cast
    to the compute dtype once) and its gradient, a tree like ``params``
    (zeros for a leaf the loss does not use)."""
    leaves = [p.detach().requires_grad_(p.is_floating_point())
              for p in tree.leaves(params)]
    loss = bundle.loss(cast_tree(tree.unflatten(params, leaves),
                                 bundle.cfg.dtype), batch)
    wrt = [p for p in leaves if p.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in leaves:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), tree.unflatten(params, grads)


def make_train_step(bundle: Bundle, opt_cfg: OptConfig,
                    train_cfg: TrainConfig = TrainConfig()) -> Callable:
    """-> step(state, batch) -> (state, metrics), metrics ``loss``,
    ``grad_norm`` and ``lr`` as device scalars. Functional: the state passed
    in is left as it was.

    A batch shape the step has not seen is the counterpart of a jit
    retrace: with an observability session active it emits
    ``train_step_trace`` and counts ``repro_train_step_traces_total``."""
    nmb = train_cfg.microbatches
    seen: set = set()

    def grads_of(params, batch):
        if nmb == 1:
            return value_and_grad(bundle, params, batch)
        mbs = {k: v.reshape(nmb, v.shape[0] // nmb, *v.shape[1:])
               for k, v in batch.items()}
        flat = tree.leaves(params)
        loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flat]
        for i in range(nmb):
            mb_loss, g = value_and_grad(bundle, params,
                                        {k: v[i] for k, v in mbs.items()})
            loss = loss + mb_loss
            acc = [a + b for a, b in zip(acc, tree.leaves(g))]
        inv = 1.0 / nmb
        return loss * inv, tree.unflatten(params, [g * inv for g in acc])

    def trace(batch) -> None:
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        if key in seen:
            return
        seen.add(key)
        sess = _obs.ACTIVE
        if sess is not None:
            # one event per new batch shape, static fields only: the
            # reference's once-per-jit-trace counter
            sess.emit("train_step_trace", optimizer=train_cfg.optimizer,
                      microbatches=nmb,
                      compress=bool(train_cfg.compress_grads))
            sess.counter("repro_train_step_traces_total",
                         "train-step retraces (jit compiles)").inc()

    def step(state, batch):
        trace(batch)
        loss, grads = grads_of(state["params"], batch)
        new_state = dict(state)
        with torch.no_grad():
            if train_cfg.compress_grads:
                words, gen = _split_rng(state["rng"], loss.device)
                grads, err = _compress(grads, state.get("err"), gen)
                grads = tree.map_tree(lambda g: g.float(), grads)
                new_state["err"] = err
                new_state["rng"] = words
            if train_cfg.optimizer == "adafactor":
                p, opt, metrics = adafactor_update(
                    grads, state["opt"], state["params"], opt_cfg)
            else:
                p, opt, metrics = adamw_update(
                    grads, state["opt"], state["params"], opt_cfg)
        new_state["params"] = p
        new_state["opt"] = opt
        metrics["loss"] = loss
        return new_state, metrics

    return step

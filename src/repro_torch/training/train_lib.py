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

Sharding (ZeRO over a ``DeviceMesh``): :func:`train_state_pspecs` is the
reference's spec tree of the state (moments shard like their parameters,
FSDP over the stacked leaves; Adafactor's factors drop the reduced dim's
entry; ``step`` and ``rng`` replicated), :func:`state_shape_structs` its
shapes and dtypes as ``meta`` tensors. :func:`init_sharded_train_state`
places a state under those specs as ``DTensor`` leaves, each rank holding
its shard of the f32 masters and moments. ``make_train_step(...,
mesh_ctx=ctx)`` activates the context at every call (kernel resolution sees
shard shapes), and on a sharded state takes one of two routes, chosen by
the family and the mesh:

* **tensor parallelism** (every family, ``Bundle.tp_loss``, where the
  mesh's ``model`` dim has more than one rank; :func:`tp_value_and_grad`):
  each rank computes its share of the query and KV heads (the
  encoder-decoder's self and cross attention too), the SwiGLU ``ff``
  columns, the MoE's experts (or every expert's ``e_ff`` columns where
  ``model`` does not divide the experts), the SSM heads and the vocab
  (where it divides), one all-reduce over ``model`` completing each
  row-parallel product, as GSPMD splits the reference's step from its
  ``logical_constraint`` annotations (``parallel.tensor_parallel``). Each
  layer gathers its own weights over ``data`` (FSDP) inside the layer, so
  the remat policy gathers them again in backward rather than keep every
  layer's, and a leaf's ``model`` shard stays on its rank where it is the
  rank's part of the compute;
* **gather whole** (a mesh without a split ``model`` dim;
  :func:`sharded_value_and_grad`): each parameter's bf16 cast is
  all-gathered whole before the forward, and every rank of a ``data``
  coordinate computes its rows whole.

On both, an MoE layer routes the groups of the whole batch, as the
reference's one program over it does (``models.layers._moe_split``).

On both, each rank runs on its ``data`` coordinate's rows, and each
gradient is reduce-scattered, averaged over ``data``, onto the rank's f32
shard (``repro_torch.parallel.sharded_state``); the global norm and the
update run on the shards. The step records the seconds of its parts
(``step.split``: gather, forward and backward, reduce-scatter, the
activations' all-reduces over ``model`` (``tp_all_reduce``, tensor
parallelism only), update), each also a ``train/sharded/<part>`` span.

Spans (``obs.profiling``; recorded while a session is active or a profiler
records): ``train/step`` holds ``train/forward`` (``bundle.loss``, the
casts included) and ``train/backward`` (``autograd.grad``, the layers'
recompute included), one pair a microbatch, then the optimizer's
``train/clip`` and ``train/update`` (``optim.adamw``). While a profiler
records, the four wait for the device at their start and end, so each
holds its own kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.distributed import all_reduce_sum
from repro_torch.models.common import (
    _init_leaf,
    cast_tree,
    init_params,
    partition_specs,
    stack_pspec,
)
from repro_torch.models.lm import Bundle, kv_leaf, pad_cache_seq, \
    serves_split
from repro_torch.obs import profiling as _prof
from repro_torch.obs import runtime as _obs
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.optim.adafactor import adafactor_update, init_adafactor_state
from repro_torch.optim.compress import compress_grads as _compress
from repro_torch.parallel import sharded_state as shst
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.parallel.mesh_context import activate
from repro_torch.parallel.sharding import is_dtensor, spec_for, spec_of

# the reference's initial key, jax.random.PRNGKey(17)
RNG_WORDS = (0, 17)
# the parts of a sharded step's clock timed inside its forward_backward
NESTED_PARTS = ("gather", "reduce_scatter", "tp_all_reduce", "tp_all_gather")


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


def state_shape_structs(bundle: Bundle, opt_cfg: OptConfig,
                        train_cfg: TrainConfig = TrainConfig()):
    """The train state's tree as ``meta`` tensors (shapes and dtypes, no
    storage): the reference's ``ShapeDtypeStruct`` tree, for a dry run."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    params = tree.map_tree(
        lambda ps: meta(ps.shape, ps.dtype or train_cfg.param_dtype),
        stack_pspec(bundle.params_pspec))
    if train_cfg.optimizer == "adafactor":
        def factor(p):
            if p.dim() >= 2:
                return {"vr": meta(p.shape[:-1], torch.float32),
                        "vc": meta(p.shape[:-2] + p.shape[-1:],
                                   torch.float32)}
            return {"v": meta(p.shape, torch.float32)}

        v = tree.map_tree(factor, params)
    else:
        v = tree.map_tree(lambda p: meta(p.shape, opt_cfg.state_dtype),
                          params)
    opt = {"m": tree.map_tree(lambda p: meta(p.shape, opt_cfg.state_dtype),
                              params),
           "v": v, "step": meta((), torch.int32)}
    state = {"params": params, "opt": opt,
             "rng": meta((2,), torch.uint32)}
    if train_cfg.compress_grads:
        state["err"] = tree.map_tree(lambda p: meta(p.shape, p.dtype),
                                     params)
    return state


def train_state_pspecs(bundle: Bundle, rules,
                       train_cfg: TrainConfig = TrainConfig()):
    """The spec tree of ``init_train_state``'s output under ``rules`` (a
    tuple a leaf, one entry a dim, ``parallel.sharding``'s).

    Moments shard exactly like their parameters (ZeRO, FSDP allowed over
    the stacked leaves); Adafactor's factored second moments drop the spec
    entry of the reduced dim; ``step`` and ``rng`` are replicated; ``err``
    (``compress_grads``) shards like the parameters."""
    pspec = stack_pspec(bundle.params_pspec)
    p_specs = partition_specs(pspec, rules=rules, fsdp_ok=True)
    if train_cfg.optimizer == "adafactor":
        def factor_spec(ps):
            full = spec_for(ps.shape, ps.logical, rules=rules, fsdp_ok=True)
            if len(ps.shape) >= 2:
                return {"vr": full[:-1], "vc": full[:-2] + full[-1:]}
            return {"v": full}

        v_specs = tree.map_tree(factor_spec, pspec)
    else:
        v_specs = p_specs
    specs = {"params": p_specs,
             "opt": {"m": p_specs, "v": v_specs, "step": ()},
             "rng": ()}
    if train_cfg.compress_grads:
        specs["err"] = p_specs
    return specs


def state_shardings(state, specs, mesh_ctx):
    """The tree of ``NamedSharding``s of ``state``'s ``DTensor`` leaves:
    ``specs`` (:func:`train_state_pspecs`) on the context's mesh; None for
    the replicated plain leaves (``step``, ``rng``), restored whole."""
    return tree.map_tree(
        lambda leaf, spec: mesh_ctx.named_sharding(spec)
        if is_dtensor(leaf) else None, state, specs)


def shard_train_state(state, bundle: Bundle, mesh_ctx,
                      train_cfg: TrainConfig = TrainConfig()):
    """A whole train state (the same on every rank) placed on the
    context's mesh under :func:`train_state_pspecs`: the parameters,
    moments and ``err`` as ``DTensor``s of this rank's shards, ``step`` and
    ``rng`` as they are (replicated)."""
    specs = train_state_pspecs(bundle, mesh_ctx.rules, train_cfg)

    def put(sub, sub_specs):
        return tree.map_tree(
            lambda t, spec: shst.place(t, mesh_ctx.named_sharding(spec)),
            sub, sub_specs)

    out = dict(state)
    out["params"] = put(state["params"], specs["params"])
    out["opt"] = dict(state["opt"], m=put(state["opt"]["m"],
                                          specs["opt"]["m"]),
                      v=put(state["opt"]["v"], specs["opt"]["v"]))
    if "err" in state:
        out["err"] = put(state["err"], specs["err"])
    return out


def init_sharded_train_state(gen: torch.Generator, bundle: Bundle,
                             opt_cfg: OptConfig, mesh_ctx,
                             train_cfg: TrainConfig = TrainConfig()):
    """``init_train_state``'s state, its tensors placed on the context's
    mesh under :func:`train_state_pspecs`: each parameter is drawn whole
    from ``gen`` in ``init_train_state``'s order (the same values on every
    rank and as unsharded) and cut to the rank's shard at once, so a rank
    holds one whole leaf at most; the moments are zeros of the shards."""
    specs = train_state_pspecs(bundle, mesh_ctx.rules, train_cfg)
    pspec = stack_pspec(bundle.params_pspec)
    params = tree.map_tree(
        lambda ps, spec: shst.place(
            _init_leaf(ps, gen, train_cfg.param_dtype, gen.device),
            mesh_ctx.named_sharding(spec)),
        pspec, specs["params"])
    if train_cfg.optimizer == "adafactor":
        opt = init_adafactor_state(
            tree.map_tree(shst.local, params), opt_cfg)
    else:
        opt = init_opt_state(tree.map_tree(shst.local, params), opt_cfg)

    def wrap(t, spec, like):
        return shst.dtensor(t, mesh_ctx.named_sharding(spec), like)

    shapes = state_shape_structs(bundle, opt_cfg, train_cfg)
    opt = {"m": tree.map_tree(
               lambda t, spec, m: wrap(t, spec, m.shape), opt["m"],
               specs["opt"]["m"], shapes["opt"]["m"]),
           "v": tree.map_tree(
               lambda t, spec, m: wrap(t, spec, m.shape), opt["v"],
               specs["opt"]["v"], shapes["opt"]["v"]),
           "step": opt["step"]}
    state = {"params": params, "opt": opt,
             "rng": np.array(RNG_WORDS, np.uint32)}
    if train_cfg.compress_grads:
        state["err"] = tree.map_tree(
            lambda p: shst.like(torch.zeros_like(shst.local(p)), p), params)
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
    with _prof.span("train/forward", wait=leaves[0].device):
        loss = bundle.loss(cast_tree(tree.unflatten(params, leaves),
                                     bundle.cfg.dtype), batch)
    return loss.detach(), tree.unflatten(params, _grads(loss, leaves))


def sharded_value_and_grad(bundle: Bundle, params, batch, *,
                           batch_axes: tuple, clock: shst.StepClock):
    """:func:`value_and_grad` on a sharded ``params`` (``DTensor`` leaves)
    and this rank's rows: -> (the loss averaged over ``batch_axes``, the
    gradients of the rank's local shards, plain tensors).

    Each leaf's compute-dtype cast is gathered whole (the whole view of
    ``tensor_parallel.TensorParallel.view``, no context active); its
    backward takes the whole gradient back onto the rank's shard, averaged
    over the batch's mesh dims. The batch's layout is active
    (``tensor_parallel.rows_active``): an MoE layer routes the groups of
    the whole batch. ``clock`` records ``forward_backward`` and, inside
    it, ``gather`` and ``reduce_scatter`` (and ``tp_all_gather`` and
    ``tp_all_reduce`` where an MoE layer gathers the rows)."""
    flat = tree.leaves(params)
    mesh = flat[0].device_mesh
    shards = [p.to_local().detach().requires_grad_(p.is_floating_point())
              for p in flat]
    whole = tpar.TensorParallel(mesh=mesh, dtype=bundle.cfg.dtype,
                                batch_axes=batch_axes, clock=clock)
    # the batch's layout, which the MoE lays its routing groups out over
    with clock("forward_backward"), tpar.rows_active(whole):
        views = []
        for s, p in zip(shards, flat):
            if s.requires_grad:
                views.append(whole.view(tpar.Shard(s, spec_of(p))))
            else:
                with clock("gather"):
                    views.append(shst.gather_full(s, spec_of(p), mesh))
        with _prof.span("train/forward", wait=shards[0].device):
            loss = bundle.loss(tree.unflatten(params, views), batch)
        grads = _grads(loss, shards)
    return _batch_mean(loss, mesh, batch_axes), tree.unflatten(params, grads)


def tp_value_and_grad(bundle: Bundle, params, batch, *, batch_axes: tuple,
                      clock: shst.StepClock):
    """:func:`sharded_value_and_grad` split over the mesh's ``model`` dim
    (tensor parallelism, ``bundle.tp_loss``): no leaf is gathered whole up
    front; each layer gathers its weights over the other mesh dims and
    keeps a leaf's ``model`` shard where it is the rank's part of the
    compute (``parallel.tensor_parallel``). ``clock`` records ``gather``
    (summed over the layers), ``forward_backward``, ``reduce_scatter`` and
    ``tp_all_reduce`` (the activations' sums over ``model``)."""
    flat = tree.leaves(params)
    mesh = flat[0].device_mesh
    shards = [p.to_local().detach().requires_grad_(p.is_floating_point())
              for p in flat]
    tp = tpar.TensorParallel(
        mesh=mesh, dtype=bundle.cfg.dtype,
        vocab_split=bundle.cfg.vocab % tpar.model_size(mesh) == 0,
        batch_axes=batch_axes, clock=clock)
    with clock("forward_backward"), tpar.active(tp):
        with _prof.span("train/forward", wait=shards[0].device):
            loss = bundle.tp_loss(tree.unflatten(params, [
                tpar.Shard(s, spec_of(p)) for s, p in zip(shards, flat)]),
                batch)
        grads = _grads(loss, shards)
    return _batch_mean(loss, mesh, batch_axes), tree.unflatten(params, grads)


def _grads(loss, shards: list) -> list:
    """The gradient of ``loss`` for each shard (zeros where unused), in a
    ``train/backward`` span."""
    wrt = [s for s in shards if s.requires_grad]
    with _prof.span("train/backward", wait=shards[0].device):
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for s in shards:
            g = next(got) if s.requires_grad else None
            grads.append(torch.zeros_like(s) if g is None else g)
    return grads


def _batch_mean(loss, mesh, batch_axes: tuple):
    """A rank's loss averaged over the batch's mesh dims."""
    loss = loss.detach().float()
    n = 1
    for a in batch_axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        if size > 1:
            loss = all_reduce_sum(loss, (mesh, a))
            n *= size
    return loss / n


def batch_mesh_axes(mesh_ctx) -> tuple:
    """The mesh dims the batch is split over (the rules' ``batch`` entry
    that the mesh has): ranks that differ there compute different rows."""
    if mesh_ctx is None or mesh_ctx.mesh is None:
        return ()
    entry = mesh_ctx.rules.axes_for("batch") or ()
    entry = (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in entry if a in mesh_ctx.mesh.mesh_dim_names)


def make_train_step(bundle: Bundle, opt_cfg: OptConfig,
                    train_cfg: TrainConfig = TrainConfig(), *,
                    mesh_ctx=None) -> Callable:
    """-> step(state, batch) -> (state, metrics), metrics ``loss``,
    ``grad_norm`` and ``lr`` as device scalars. Functional: the state passed
    in is left as it was.

    ``mesh_ctx`` (a :class:`~repro_torch.parallel.MeshContext`) activates
    at every call, so kernel resolution sees the shard shapes. A state whose
    parameters are ``DTensor``s (:func:`init_sharded_train_state`) takes the
    sharded step: ``batch`` holds this rank's rows (the pipeline's
    ``sharding=``), and the new state is sharded alike. ``step.split`` holds
    the seconds of the last call's parts on a sharded state.

    A batch shape the step has not seen is the counterpart of a jit
    retrace: with an observability session active it emits
    ``train_step_trace`` and counts ``repro_train_step_traces_total``."""
    nmb = train_cfg.microbatches
    seen: set = set()
    axes = batch_mesh_axes(mesh_ctx)
    split = bundle.tp_loss is not None and tpar.model_size(
        None if mesh_ctx is None else mesh_ctx.mesh) > 1
    sharded_vg = tp_value_and_grad if split else sharded_value_and_grad

    def grads_of(params, batch, clock=None):
        if clock is not None:
            def vg(p, b):
                return sharded_vg(bundle, p, b, batch_axes=axes, clock=clock)
        else:
            def vg(p, b):
                return value_and_grad(bundle, p, b)
        if nmb == 1:
            return vg(params, batch)
        mbs = {k: v.reshape(nmb, v.shape[0] // nmb, *v.shape[1:])
               for k, v in batch.items()}
        flat = [shst.local(p) for p in tree.leaves(params)]
        loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flat]
        for i in range(nmb):
            mb_loss, g = vg(params, {k: v[i] for k, v in mbs.items()})
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
        with activate(mesh_ctx), _prof.span("train/step"):
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        sharded = is_dtensor(tree.leaves(params)[0])
        clock = (shst.StepClock(shst.local(tree.leaves(params)[0]).device,
                                "train/sharded") if sharded else None)
        loss, grads = grads_of(params, batch, clock)
        new_state = dict(state)
        with torch.no_grad():
            if train_cfg.compress_grads:
                words, gen = _split_rng(state["rng"], loss.device)
                err = tree.map_tree(shst.local, state.get("err"))
                grads, err = _compress(grads, err, gen)
                grads = tree.map_tree(lambda g: g.float(), grads)
                new_state["err"] = tree.map_tree(shst.like, err,
                                                 state["err"])
                new_state["rng"] = words
            if sharded:
                grads = tree.map_tree(shst.like, grads, params)
            with (clock("update") if sharded
                  else contextlib.nullcontext()):
                if train_cfg.optimizer == "adafactor":
                    p, opt, metrics = adafactor_update(
                        grads, state["opt"], params, opt_cfg)
                else:
                    p, opt, metrics = adamw_update(
                        grads, state["opt"], params, opt_cfg)
        if sharded:
            parts = dict(clock.seconds)
            # the parts that run inside the forward and backward
            parts["forward_backward"] = parts.get("forward_backward", 0.0) \
                - sum(parts.get(k, 0.0) for k in NESTED_PARTS)
            step.split = parts
        new_state["params"] = p
        new_state["opt"] = opt
        metrics["loss"] = loss
        return new_state, metrics

    step.split = {}
    return step


def make_serve_step(bundle: Bundle, mesh_ctx=None) -> tuple[Callable,
                                                             Callable]:
    """-> (prefill_step, decode_step), the reference's: the parameters (the
    forward's layout, ``init_params(bundle.params_pspec)``'s) cast to the
    compute dtype inside (serving params are stored in it, so the cast
    makes no copy). The prefill is ``bundle.prefill_last``: serving takes
    only the last position's logits, so no (B, S, vocab) buffer is made.
    ``prefill_step(params, batch, cache_len=None)`` lays its cache out for
    ``cache_len`` rows (None: the prompt's, as the reference's).

    ``mesh_ctx`` (a :class:`~repro_torch.parallel.MeshContext` whose mesh
    splits a dim) runs both steps under it, as ``make_train_step(...,
    mesh_ctx=)`` does, for every family (``models.lm.serves_split``): the
    parameters are :func:`~repro_torch.serving.engine.serving_params`'
    part of this rank; ``batch`` is the whole batch, the same on every
    rank, of which each takes its rows by the batch rule (split over
    ``data`` where the rows divide it; an encoder-decoder's ``frames``
    too) and returns their logits, the whole vocab; the cache is this
    rank's part in the rules' layout (``models.lm.local_cache_pspec``), the
    KV cache's rows split over the ``kv_seq`` rule's mesh dims (the
    production rules' ``seq_shard=True``), written straight into
    ``cache_len`` rows by the prefill, and its global rows kept as
    ``cache["rows"]`` for the decode steps (an encoder-decoder's cross
    cache holds the frames' rows, split alike). Each sharded step's
    ``split`` holds the seconds of its last call: ``step`` whole and,
    inside it, ``tp_all_reduce``, ``tp_all_gather`` and ``tp_all_to_all``
    (each waits for the device at its ends). ``cache_len`` of an
    encoder-decoder is its self cache's rows."""
    dtype = bundle.cfg.dtype
    if serves_split(bundle.cfg, mesh_ctx):
        return _sharded_serve_steps(bundle, mesh_ctx)

    def prefill_step(params, batch, cache_len=None):
        logits, cache = bundle.prefill_last(cast_tree(params, dtype), batch)
        kv = kv_leaf(cache)
        if cache_len is not None and kv is not None:
            pad_cache_seq(cache, cache_len - kv.shape[2])
        return logits, cache

    def decode_step(params, cache, batch):
        return bundle.decode(cast_tree(params, dtype), cache, batch)

    return prefill_step, decode_step


def _sharded_serve_steps(bundle: Bundle, mesh_ctx):
    """:func:`make_serve_step`'s steps on a mesh that splits a dim."""
    cfg = bundle.cfg

    def context(batch: int, rows: int | None, device, cross=None):
        # an encoder-decoder's cache: ``rows`` self rows, ``cross`` rows
        kind = {} if cross is None else {"cross_rows": cross}
        kv = None if rows is None else \
            kv_leaf(bundle.cache_pspec(batch, rows, **kind))
        return tpar.for_serving(mesh_ctx, cfg.dtype, vocab=cfg.vocab,
                                batch=batch, kv=kv,
                                clock=shst.StepClock(device,
                                                     "serving/sharded"))

    def mine(batch: dict, tp) -> dict:
        rows = next(iter(batch.values())).shape[0] // tp.row_parts()
        r0 = tp.row_start(rows)
        return {k: v.narrow(0, r0, rows) for k, v in batch.items()}

    def prefill_step(params, batch, cache_len=None):
        b, s = batch["tokens"].shape
        s += batch["stub"].shape[1] if "stub" in batch else 0
        cross = batch["frames"].shape[1] if "frames" in batch else None
        tp = context(b, cache_len or s, batch["tokens"].device, cross)
        with tp.clock("step"), activate(mesh_ctx), tpar.active(tp):
            logits, cache = bundle.prefill_last(
                cast_tree(params, cfg.dtype), mine(batch, tp))
        if tp.kv_rows is not None:
            cache["rows"] = tp.kv_rows
        if cross is not None:
            cache["cross_rows"] = cross
        prefill_step.split = dict(tp.clock.seconds)
        return logits, cache

    def decode_step(params, cache, batch):
        tp = context(batch["tokens"].shape[0], cache.get("rows"),
                     batch["tokens"].device, cache.get("cross_rows"))
        with tp.clock("step"), activate(mesh_ctx), tpar.active(tp):
            out = bundle.decode(cast_tree(params, cfg.dtype), cache,
                                mine(batch, tp))
        decode_step.split = dict(tp.clock.seconds)
        return out

    prefill_step.split = decode_step.split = {}
    return prefill_step, decode_step

"""Shared model machinery: parameter declaration and init, norms, rope,
SwiGLU, embeddings, the loss.

Parameters are declared as trees (dicts and lists) of :class:`PSpec` and
materialised by :func:`init_params` from an explicit ``torch.Generator``
with the reference's init rules. The reference stacks layers on a leading
axis for ``lax.scan``; the port's forward takes a list with one entry per
layer. The train state keeps the reference's stacked leaves
(:func:`stack_pspec`), and :func:`unstack_blocks` views them as that list
(``blocks``, or the encoder-decoder's ``enc`` and ``dec``).
:func:`params_from_numpy` takes the JAX package's parameter tree, as numpy
arrays, into the port's layout, and :func:`params_to_numpy` back.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as devmod
from repro_torch.core import dispatch
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.parallel.sharding import spec_for
from repro_torch.tree import map_tree as _map_tree


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple
    init: str = "fan_in"     # fan_in | zeros | ones | normal | const:<v> |
    #                          dt_bias | a_log
    dtype: torch.dtype | None = None   # None = model default
    # one logical axis name per dim (``repro_torch.parallel.sharding``'s
    # rules map them to mesh dims), the reference's
    logical: tuple = ()


def _init_leaf(ps: PSpec, gen: torch.Generator, default_dtype, device):
    dt = ps.dtype or default_dtype

    def randn():
        return torch.randn(ps.shape, generator=gen, device=device,
                           dtype=torch.float32)

    def uniform(lo, hi):
        u = torch.rand(ps.shape, generator=gen, device=device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dt, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dt, device=device)
    if ps.init.startswith("const:"):
        return torch.full(ps.shape, float(ps.init[6:]), dtype=dt,
                          device=device)
    if ps.init == "normal":
        return (0.02 * randn()).to(dt)
    if ps.init == "fan_in":
        fan = ps.shape[-2] if len(ps.shape) >= 2 else ps.shape[-1]
        return (randn() / math.sqrt(max(fan, 1))).to(dt)
    if ps.init == "dt_bias":   # softplus^-1 of U(1e-3, 1e-1)
        return torch.log(torch.expm1(uniform(1e-3, 1e-1))).to(dt)
    if ps.init == "a_log":     # log U(1, 16)
        return torch.log(uniform(1.0, 16.0)).to(dt)
    raise ValueError(ps.init)


def init_params(tree, gen: torch.Generator, default_dtype=torch.bfloat16,
                device=None):
    """Materialise a PSpec tree on ``device`` (the generator's device when
    None), drawing from ``gen`` in tree order."""
    device = gen.device if device is None else torch.device(device)
    return _map_tree(lambda ps: _init_leaf(ps, gen, default_dtype, device),
                     tree)


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return math.prod(tree.shape)


# the layer stacks of a parameter tree: the decoder-only models' ``blocks``,
# the encoder-decoder's ``enc`` and ``dec``
STACKS = ("blocks", "enc", "dec")


def stack_lens(cfg) -> dict:
    return {"blocks": cfg.n_layers, "enc": cfg.enc_layers,
            "dec": cfg.n_layers}


def stack_pspec(tree):
    """A parameter declaration with each per-layer list of ``STACKS``
    stacked into ``(layers, ...)`` leaves, the reference's layout (the
    train state's), the new dim named ``"layers"``. Each layer's leaf keeps
    its init rule; ``fan_in`` reads ``shape[-2]``, so a stacked leaf draws
    from the same distribution."""
    out = dict(tree)
    for key in STACKS:
        if key in tree:
            layers = tree[key]
            out[key] = _map_tree(
                lambda ps, n=len(layers): dataclasses.replace(
                    ps, shape=(n, *ps.shape),
                    logical=("layers", *ps.logical)), layers[0])
    return out


def partition_specs(tree, *, rules=None, fsdp_ok: bool = True):
    """PSpec tree -> the tree of each leaf's spec (a tuple with one entry
    per dim) under the active (or given) rules, the reference's
    ``partition_specs``; stack a per-layer declaration with
    :func:`stack_pspec` first for the reference's layout."""
    return _map_tree(
        lambda ps: spec_for(ps.shape, ps.logical, rules=rules,
                            fsdp_ok=fsdp_ok), tree)


def _leaf_from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16 (ml_dtypes supplies it) and torch refuses
        # it; the trip through f32 and back is exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def tree_from_numpy(tree, *, device=None):
    """The reference's tree of numpy arrays -> tensors on ``device`` with
    their dtype, in the same (stacked) layout."""
    dev = devmod.resolve(device)
    return _map_tree(lambda a: _leaf_from_numpy(a, dev), tree)


def unstack_blocks(params, cfg):
    """Stacked parameters (the leaves of ``blocks``, or of ``enc`` and
    ``dec``, ``(layers, ...)``) -> the forward's layout: each stack a list
    of per-layer trees of views.

    The views are ``torch.unbind``'s, whose backward stacks the layers'
    gradients in one tensor, so gradients reach the stacked leaf."""
    out = dict(params)
    for key, n in stack_lens(cfg).items():
        if key not in params:
            continue
        views = []

        def split(t, key=key, n=n):
            if t.shape[0] != n:
                raise ValueError(f"stacked leaf {tuple(t.shape)} of {key!r} "
                                 f"does not lead with its {n} layers")
            views.append(torch.unbind(t, 0))
            return len(views) - 1

        index = _map_tree(split, params[key])
        out[key] = [_map_tree(lambda j, i=i, views=views: views[j][i], index)
                    for i in range(n)]
    return out


def params_from_numpy(tree, cfg, *, device=None):
    """The reference's parameter tree (``jax.tree.map(np.asarray, params)``)
    -> the port's: leaves become tensors on ``device`` with their dtype, and
    the stacked ``(layers, ...)`` leaves of each of ``STACKS`` are split
    into a list of per-layer trees."""
    return unstack_blocks(tree_from_numpy(tree, device=device), cfg)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:      # numpy has no bf16: exact in f32
        t = t.float()
    return t.numpy()


def params_to_numpy(params):
    """The inverse of :func:`params_from_numpy`: tensors -> numpy arrays in
    the reference's layout, each per-layer list of ``STACKS`` stacked back
    into ``(layers, ...)`` leaves (stacked leaves stay as they are). bf16
    leaves come back as float32 arrays, which hold them exactly."""
    out = dict(params)
    for key in STACKS:
        layers = params.get(key)
        if isinstance(layers, list):
            out[key] = _map_tree(lambda *ls: torch.stack(ls), layers[0],
                                 *layers[1:])
    return _map_tree(_leaf_to_numpy, out)


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating leaf to ``dtype`` (the serving cast of the
    reference's ``make_serve_step``)."""
    return _map_tree(
        lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


# ---------------------------------------------------------------------------
# building blocks


def rmsnorm(x, w, eps: float = 1e-6, policy=None):
    return dispatch.rmsnorm(x, w, eps=eps, policy=policy)


def _vocab_split():
    """The active tensor-parallel context where it splits the vocab (the
    table, head and logits are this rank's part of it), else None."""
    tp = tpar.current()
    return tp if tp is not None and tp.vocab_split else None


def cross_entropy(logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logsumexp in f32. Logits split over the
    vocab (tensor parallelism) complete it across ranks."""
    tp = _vocab_split()
    if tp is not None:
        return tpar.vocab_parallel_cross_entropy(logits, labels, tp)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``emb`` at ``tokens``; from this rank's rows of a table
    split over the vocab (tensor parallelism), completed across ranks."""
    tp = _vocab_split()
    if tp is not None:
        return tpar.vocab_parallel_embed(emb, tokens, tp)
    return F.embedding(tokens, emb)


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``x (..., d)`` against ``head (vocab, d)`` -> ``(..., vocab)``; a head
    split over the vocab (tensor parallelism) gives this rank's columns."""
    tp = _vocab_split()
    if tp is not None:
        x = tp.copy_in(x)
    return x @ head.T


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on halves (not interleaved pairs), as the
    reference. x: (..., S, H, Dh); positions: (..., S). Angles in f32, the
    result in x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, w_in, w_gate, w_out):
    """SwiGLU MLP: (..., d) -> (..., d). ``silu`` runs in the native
    compute dtype, as in the reference (f32 only where the operands are).
    Under tensor parallelism the weights are this rank's ``ff`` columns
    (rows of ``w_out``) and the partial outputs are summed across ranks."""
    tp = tpar.current()
    if tp is not None:
        x = tp.copy_in(x)
    h = x @ w_in
    g = x @ w_gate
    out = (F.silu(g) * h) @ w_out
    return out if tp is None else tp.reduce_out(out)

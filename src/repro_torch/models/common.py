"""Shared model machinery: parameter declaration and init, norms, rope,
SwiGLU, embeddings.

Parameters are declared as trees (dicts and lists) of :class:`PSpec` and
materialised by :func:`init_params` from an explicit ``torch.Generator``
with the reference's init rules. :func:`params_from_numpy` takes the JAX
package's parameter tree, as numpy arrays, into the port's layout: the
reference stacks layers on a leading axis for ``lax.scan``; the port keeps a
list with one entry per layer.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as devmod
from repro_torch.core import dispatch


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple
    init: str = "fan_in"     # fan_in | zeros | ones | normal | const:<v> |
    #                          dt_bias | a_log
    dtype: torch.dtype | None = None   # None = model default


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


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


def _leaf_from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16 (ml_dtypes supplies it) and torch refuses
        # it; the trip through f32 and back is exact
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def params_from_numpy(tree, cfg, *, device=None):
    """The reference's parameter tree (``jax.tree.map(np.asarray, params)``)
    -> the port's: leaves become tensors on ``device`` with their dtype, and
    the stacked ``(n_layers, ...)`` leaves of ``tree["blocks"]`` are split
    into a list of per-layer trees."""
    dev = devmod.resolve(device)
    out = {k: _map_tree(lambda a: _leaf_from_numpy(a, dev), v)
           for k, v in tree.items() if k != "blocks"}
    stacked = _map_tree(lambda a: _leaf_from_numpy(a, dev), tree["blocks"])
    blocks = []
    for i in range(cfg.n_layers):
        blocks.append(_map_tree(lambda t, i=i: _layer_slice(t, i, cfg),
                                stacked))
    out["blocks"] = blocks
    return out


def _layer_slice(t: torch.Tensor, i: int, cfg) -> torch.Tensor:
    if t.shape[0] != cfg.n_layers:
        raise ValueError(f"stacked leaf {tuple(t.shape)} does not lead with "
                         f"n_layers={cfg.n_layers}")
    return t[i]


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating leaf to ``dtype`` (the serving cast of the
    reference's ``make_serve_step``)."""
    return _map_tree(
        lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


# ---------------------------------------------------------------------------
# building blocks


def rmsnorm(x, w, eps: float = 1e-6, policy: str | None = None):
    return dispatch.rmsnorm(x, w, eps=eps, policy=policy)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, emb)


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``x (..., d)`` against ``head (vocab, d)`` -> ``(..., vocab)``."""
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
    compute dtype, as in the reference (f32 only where the operands are)."""
    h = x @ w_in
    g = x @ w_gate
    return (F.silu(g) * h) @ w_out

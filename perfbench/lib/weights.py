"""Weights made from the seed, on the device, in a few large calls.

The benchmark makes the weights itself, in its reference's layout
(``configs/reference_*.py::param_specs``, stacked over the layers), and
hands the same tensors to the program; the reference makes them again from
the seed after the window. One ``randn`` fills every matrix and one
``rand`` every uniform draw; each leaf is a view of those buffers, scaled
in place by its rule: ``normal`` 0.02, ``fan_in`` 1/sqrt(rows), ``dt_bias``
softplus^-1 of U(1e-3, 0.1), ``a_log`` log U(1, 16), ``ones``, ``zeros``.
"""
from __future__ import annotations

import math

import torch


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(specs: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """The tree of ``specs`` (``Leaf`` entries) as tensors drawn from
    ``seed``: the model's leaves in ``dtype``, those marked ``f32`` in
    float32."""
    device = torch.device(device)
    leaves = list(_leaves(specs))
    n_normal = sum(math.prod(s.shape) for _, s in leaves
                   if s.init in ("normal", "fan_in"))
    n_unif = sum(math.prod(s.shape) for _, s in leaves
                 if s.init in ("dt_bias", "a_log"))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device, dtype=dtype)
    unif = torch.rand(n_unif, generator=gen, device=device,
                      dtype=torch.float32)
    out: dict = {}
    on = ou = 0
    for path, s in leaves:
        n = math.prod(s.shape)
        dt = torch.float32 if s.f32 else dtype
        if s.init in ("normal", "fan_in"):
            t = normal[on:on + n].view(s.shape)
            on += n
            t.mul_(0.02 if s.init == "normal" else
                   1.0 / math.sqrt(s.shape[-2] if len(s.shape) >= 2
                                   else s.shape[-1]))
            t = t.to(dt)
        elif s.init in ("dt_bias", "a_log"):
            u = unif[ou:ou + n].view(s.shape)
            ou += n
            t = (torch.log(torch.expm1(1e-3 + (0.1 - 1e-3) * u))
                 if s.init == "dt_bias" else torch.log(1.0 + 15.0 * u))
            t = t.to(dt)
        elif s.init == "ones":
            t = torch.ones(s.shape, dtype=dt, device=device)
        elif s.init == "zeros":
            t = torch.zeros(s.shape, dtype=dt, device=device)
        else:
            raise ValueError(f"unknown init {s.init!r} at {path}")
        _set(out, path, t)
    return out


def per_layer(params: dict, n_layers: int) -> dict:
    """The stacked ``blocks`` as a list of per-layer trees of views (the
    program's serving layout)."""
    out = dict(params)

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    out["blocks"] = [layer(params["blocks"], i) for i in range(n_layers)]
    return out


def check_layout(ours, pspec, where: str = "") -> None:
    """Raise where the program declares another tree or other shapes than
    the benchmark makes: the weights would not mean the same to both."""
    if isinstance(pspec, dict):
        if not isinstance(ours, dict) or set(ours) != set(pspec):
            raise ValueError(f"parameter tree differs at {where or 'root'}: "
                             f"{sorted(ours) if isinstance(ours, dict) else ours}"
                             f" vs {sorted(pspec)}")
        for k in pspec:
            check_layout(ours[k], pspec[k], f"{where}.{k}")
    elif isinstance(pspec, list):
        if not isinstance(ours, list) or len(ours) != len(pspec):
            raise ValueError(f"layer count differs at {where}")
        for i, (a, b) in enumerate(zip(ours, pspec)):
            check_layout(a, b, f"{where}[{i}]")
    elif tuple(ours.shape) != tuple(pspec.shape):
        raise ValueError(f"{where}: the benchmark makes {tuple(ours.shape)}, "
                         f"the program declares {tuple(pspec.shape)}")

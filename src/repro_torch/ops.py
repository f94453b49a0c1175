"""``repro_torch.ops`` — the public API for the paper's ops on PyTorch.

Counterpart of ``repro.ops``. Every op takes ``policy=``:

* ``None`` (default) — the active policy (:func:`get_policy`; its process
  default is built from ``REPRO_KERNEL_PATH``/``REPRO_AUTOTUNE*``: ``auto``,
  which on a CUDA tensor of an H100 runs the Hopper kernels unless a
  measured table says otherwise, and on a CPU tensor the reference's CPU
  choice),
* a :class:`KernelPolicy`,
* a string shorthand — a bare path label (``"tile"``, ``"fused"``,
  ``"baseline"``, ``"tile_logdepth"`` for the scan family, ...), an
  ``op=path,...`` list, dotted tuning knobs (``"tile,ssd.q=32"``) or a JSON
  object of policy fields.

Scoped overrides compose through :func:`using_policy` /
:func:`set_policy`::

    import repro_torch.ops as ops
    from repro_torch.ops import KernelPolicy, using_policy

    ops.reduce(x)                        # tcu_reduce.cu on a CUDA tensor
    ops.scan(x, exclusive=True)          # tcu_scan.cu, then a shift
    ops.ssd(x, dt, a, b, c, policy="tile,ssd.q=32")   # ssd_scan.cu, q 32
    ops.scan(x, policy="tile_logdepth")  # matmul_scan.cu + a log-depth tree
    with using_policy(KernelPolicy(op_paths={"attention": "fused"})):
        ops.attention(q, k, v)           # per-op override beats global

Under an active :class:`~repro_torch.parallel.MeshContext`,
``reduce``, ``scan``, ``weighted_scan`` and ``ssd`` take a ``DTensor``
whose bucket axis is sharded over the context's ``DeviceMesh``: each rank
runs the kernel on its local shard and the ranks combine their partials
with collectives (``repro_torch.parallel.shard_ops``); everything else
falls back to plain dispatch::

    ctx = make_context("data=4")         # repro_torch.parallel
    with ctx:
        ops.scan(DTensor.from_local(x_shard, ctx.mesh, [Shard(1)]))

:func:`dist_weighted_scan` is the multi-device composition of
``weighted_scan`` (the paper's grid-level scan-then-propagate) on a rank's
local piece; it takes a process group instead of a policy.

The ``path=`` kwarg is a deprecated alias for a bare-label policy and warns
once per process.
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch as _dispatch
from repro_torch.core import policy as _policy
from repro_torch.core.distributed import \
    dist_weighted_scan  # noqa: F401  (re-exported API)
from repro_torch.core.policy import (  # noqa: F401  (re-exported API)
    KernelPolicy,
    TuneSpec,
    get_policy,
    set_policy,
    using_policy,
)
from repro_torch.parallel import shard_ops as _shard

__all__ = [
    "KernelPolicy",
    "TuneSpec",
    "attention",
    "dist_weighted_scan",
    "get_policy",
    "ragged_reduce",
    "ragged_scan",
    "reduce",
    "rmsnorm",
    "scan",
    "set_policy",
    "ssd",
    "using_policy",
    "weighted_scan",
]


def _policy_arg(policy, path):
    """Fold the deprecated ``path=`` alias into ``policy`` (warns once)."""
    if path is not None:
        _policy.warn_once(
            "deprecated:repro_torch.ops.path",
            "the path= kwarg on repro_torch.ops is deprecated; pass policy= "
            "(a KernelPolicy or a string shorthand like policy='fused')",
            stacklevel=4)
        if policy is None:
            policy = path
    return policy


def reduce(x: torch.Tensor, *, policy=None,
           path: str | None = None) -> torch.Tensor:
    """Segmented sum over the last axis of ``x (..., n)`` -> f32
    ``(...,)``."""
    policy = _policy_arg(policy, path)
    out = _shard.sharded_reduce(x, policy=policy)
    if out is not None:
        return out
    return _dispatch.reduce(x, policy=policy)


def scan(x: torch.Tensor, *, policy=None, exclusive: bool = False,
         path: str | None = None) -> torch.Tensor:
    """Prefix sum over the last axis -> f32, same shape
    (``exclusive=True`` shifts in a leading zero)."""
    policy = _policy_arg(policy, path)
    out = _shard.sharded_scan(x, policy=policy, exclusive=exclusive)
    if out is not None:
        return out
    return _dispatch.scan(_shard.gather_bucket(x, -1), policy=policy,
                          exclusive=exclusive)


def weighted_scan(x: torch.Tensor, log_a: torch.Tensor, *, policy=None,
                  path: str | None = None) -> torch.Tensor:
    """Decayed scan ``y_i = exp(log_a_i) * y_{i-1} + x_i`` -> f32."""
    policy = _policy_arg(policy, path)
    out = _shard.sharded_weighted_scan(x, log_a, policy=policy)
    if out is not None:
        return out
    return _dispatch.weighted_scan(_shard.gather_bucket(x, -1),
                                   _shard.gather_bucket(log_a, -1),
                                   policy=policy)


def ragged_reduce(x: torch.Tensor, seg_ids: torch.Tensor, n_segments: int,
                  *, policy=None, path: str | None = None) -> torch.Tensor:
    """Bucketed segmented sum: ``x (..., n)`` + ``seg_ids`` -> f32
    ``(..., n_segments)``."""
    return _dispatch.ragged_reduce(x, seg_ids, n_segments,
                                   policy=_policy_arg(policy, path))


def ragged_scan(x: torch.Tensor, seg_ids: torch.Tensor, n_segments: int, *,
                policy=None, debug: bool = False,
                path: str | None = None) -> torch.Tensor:
    """Within-segment inclusive prefix sum -> f32, same shape as ``x``
    (``seg_ids`` must be non-decreasing; ``debug=True`` validates)."""
    return _dispatch.ragged_scan(x, seg_ids, n_segments,
                                 policy=_policy_arg(policy, path),
                                 debug=debug)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            policy=None, path: str | None = None) -> torch.Tensor:
    """RMSNorm over the last axis, in x's dtype (differentiable)."""
    return _dispatch.rmsnorm(x, w, eps=eps, policy=_policy_arg(policy, path))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None, policy=None,
              path: str | None = None) -> torch.Tensor:
    """Attention in the model layout: ``q (B, Sq, Hq, D)``, ``k``/``v``
    ``(B, Sk, Hkv, D)`` -> ``(B, Sq, Hq, D)``."""
    return _dispatch.attention(q, k, v, causal=causal, window=window,
                               scale=scale,
                               policy=_policy_arg(policy, path))


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, *, policy=None,
        chunk: int | None = None, matmul_dtype=None,
        return_state: bool = False, path: str | None = None):
    """Mamba-2 SSD scan -> ``y (B, L, H, P)``; with ``return_state=True``
    also the final state ``(B, H, P, N)`` f32."""
    policy = _policy_arg(policy, path)
    out = _shard.sharded_ssd(x, dt, a, b, c, policy=policy, chunk=chunk,
                             matmul_dtype=matmul_dtype,
                             return_state=return_state)
    if out is not None:
        return out
    x, dt, b, c = (_shard.gather_bucket(t, 1) for t in (x, dt, b, c))
    return _dispatch.ssd(x, dt, a, b, c, policy=policy, chunk=chunk,
                         matmul_dtype=matmul_dtype,
                         return_state=return_state)

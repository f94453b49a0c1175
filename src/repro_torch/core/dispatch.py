"""One switch for every reduce/scan/attention/SSD formulation of the port.

Every op takes ``policy=`` (see :mod:`repro_torch.core.policy`) and runs:

  ``tile``      the Hopper kernel through ``repro_torch.kernels.ops``
  ``fused``     the matmul forms of ``repro_torch.core`` (torch matmuls);
                for attention the blocked ``chunked_attention``
  ``baseline``  ``torch.sum`` / ``torch.cumsum`` / the plain oracles
  ``tile_logdepth``  scan, weighted_scan and ssd only: the carry-free local
                kernels of ``csrc/matmul_scan.cu`` and the log-depth tree of
                ``kernels/matmul_scan.py`` (the other ops raise)

The ragged ops have no kernel in the reference either: ``tile`` and
``fused`` run their one-hot matmul forms (``repro_torch.core.ragged``).

Each op resolves its path with the bucket-axis size the reference's
``dispatch._resolve`` passes (reduce, scan, weighted_scan: the last axis;
attention and ssd: the sequence axis), so an observability session records
the reference's ``resolution`` events.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import _emit_resolution, resolve
from repro_torch.core.ragged import (
    guard_contiguous,
    tcu_ragged_segment_reduce,
    tcu_ragged_segment_scan,
)
from repro_torch.core.reduce import tcu_segmented_reduce
from repro_torch.core.scan import tcu_scan, tcu_weighted_scan
from repro_torch.core.ssd import CHUNK, ssd_chunked
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.obs import runtime

KERNEL_PATHS = ("tile", "tile_logdepth")


def _resolve(policy, op: str, x: torch.Tensor, n: int,
             level: str = "dispatch") -> str:
    return resolve(policy, op, n=n, dtype=x.dtype, level=level,
                   device=x.device)


def _kernel_level(op: str, x: torch.Tensor, n: int, path: str) -> None:
    """The reference resolves a kernel path once more in its kernel
    registry (``repro.kernels.backend.pallas_op``: level ``"kernel"``, the
    registry's name of the op, the dispatch's choice as the per-call
    label). The port's wrappers take the path as given, so that
    resolution is recorded here (only called with a session active)."""
    if path in KERNEL_PATHS:
        _emit_resolution(op, n, x.dtype, "kernel", path, path, x.device)


def reduce(x: torch.Tensor, *, policy: str | None = None) -> torch.Tensor:
    """Segmented sum over the last axis -> f32 ``(...,)``."""
    p = _resolve(policy, "reduce", x, x.shape[-1])
    if p == "fused":
        return tcu_segmented_reduce(x, formulation="fused")
    if p == "baseline":
        return torch.sum(x.float(), dim=-1)
    if runtime.ACTIVE is not None:
        _kernel_level("segmented_reduce", x, x.shape[-1], p)
    return kops.segmented_reduce(x)


def scan(x: torch.Tensor, *, policy: str | None = None,
         exclusive: bool = False) -> torch.Tensor:
    """Prefix sum over the last axis -> f32, same shape."""
    p = _resolve(policy, "scan", x, x.shape[-1])
    if p == "fused":                   # core's scan is the tile algebra
        return tcu_scan(x, exclusive=exclusive)
    if runtime.ACTIVE is not None:
        _kernel_level("segmented_scan", x, x.shape[-1], p)
    if p == "baseline":
        out = torch.cumsum(x.float(), dim=-1)
    elif p == "tile_logdepth":
        out = kops.segmented_scan_logdepth(x)
    else:
        out = kops.segmented_scan(x)
    if exclusive:
        # shift, never subtract: ``inclusive - x`` cancels catastrophically
        # when |x_i| dwarfs the running prefix
        out = torch.cat([torch.zeros_like(out[..., :1]), out[..., :-1]],
                        dim=-1)
    return out


def weighted_scan(x: torch.Tensor, log_a: torch.Tensor, *,
                  policy: str | None = None) -> torch.Tensor:
    """Decayed scan ``y_i = exp(log_a_i) * y_{i-1} + x_i`` -> f32."""
    p = _resolve(policy, "weighted_scan", x, x.shape[-1])
    if p == "fused":
        return tcu_weighted_scan(x, log_a)
    if p == "baseline":
        return ref.weighted_scan_ref(x, log_a)
    if runtime.ACTIVE is not None:
        _kernel_level("weighted_scan", x, x.shape[-1], p)
    if p == "tile_logdepth":
        return kops.weighted_scan_logdepth(x, log_a)
    return kops.weighted_scan(x, log_a)


# ---------------------------------------------------------------------------
# ragged (irregular) segments, the paper's footnote-4 case


def ragged_reduce(x: torch.Tensor, seg_ids: torch.Tensor, n_segments: int,
                  *, policy: str | None = None) -> torch.Tensor:
    """Bucketed segmented sum: ``x (..., n)`` + ``seg_ids`` -> f32
    ``(..., n_segments)``. ``tile``/``fused``: the one-hot matmul form;
    ``baseline``: torch's segment sum (``scatter_add``). ``seg_ids`` may
    carry leading batch dims; any id order is valid, and ids outside
    ``[0, n_segments)`` contribute nowhere."""
    p = _resolve(policy, "ragged_reduce", x, x.shape[-1])
    if p == "baseline":
        return _segment_sum_baseline(x, seg_ids, n_segments)
    return tcu_ragged_segment_reduce(x, seg_ids, n_segments)


def ragged_scan(x: torch.Tensor, seg_ids: torch.Tensor, n_segments: int, *,
                policy: str | None = None,
                debug: bool = False) -> torch.Tensor:
    """Within-segment inclusive prefix sum -> f32, the shape of ``x``.
    ``seg_ids`` must be non-decreasing on every path (``debug=True``
    validates, :func:`~repro_torch.core.ragged.guard_contiguous`).
    ``tile``/``fused``: the matmul form; ``baseline``: ``cumsum``, the
    segment sum and a gather."""
    p = _resolve(policy, "ragged_scan", x, x.shape[-1])
    if p == "baseline":
        out = _ragged_scan_baseline(x, seg_ids, n_segments)
        return guard_contiguous(seg_ids, out) if debug else out
    return tcu_ragged_segment_scan(x, seg_ids, n_segments, debug=debug)


def _segment_sum_baseline(x: torch.Tensor, seg_ids: torch.Tensor,
                          n_segments: int) -> torch.Tensor:
    """The reference's ``jax.ops.segment_sum`` over the trailing axis:
    ``scatter_add`` into one more bucket that takes the ids out of range
    and is dropped."""
    xf = x.float()
    ids = torch.broadcast_to(seg_ids, xf.shape).long()
    ids = torch.where((ids >= 0) & (ids < n_segments), ids, n_segments)
    out = xf.new_zeros(*xf.shape[:-1], n_segments + 1)
    return out.scatter_add_(-1, ids, xf)[..., :n_segments]


def _ragged_scan_baseline(x: torch.Tensor, seg_ids: torch.Tensor,
                          n_segments: int) -> torch.Tensor:
    """Global ``cumsum`` minus the gathered totals of the preceding
    segments. The gather follows the reference's ``take_along_axis``: a
    negative id counts from the end, an id out of range reads NaN."""
    xf = x.float()
    gs = torch.cumsum(xf, dim=-1)
    totals = _segment_sum_baseline(x, seg_ids, n_segments)     # (..., S)
    prior = torch.cat([torch.zeros_like(totals[..., :1]),
                       torch.cumsum(totals, dim=-1)[..., :-1]], dim=-1)
    ids = torch.broadcast_to(seg_ids, xf.shape).long()
    ids = torch.where(ids < 0, ids + n_segments, ids)
    inside = (ids >= 0) & (ids < n_segments)
    got = prior.gather(-1, ids.clamp(0, n_segments - 1))
    return gs - torch.where(inside, got, torch.nan)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            policy: str | None = None) -> torch.Tensor:
    """RMSNorm over the last axis, in x's dtype. The reference has RMSNorm
    in its kernel registry only (``repro.kernels.ops.rmsnorm``), so it
    resolves once, at level ``"kernel"``."""
    if _resolve(policy, "rmsnorm", x, x.shape[-1], level="kernel") == "tile":
        return kops.rmsnorm(x, w, eps=eps)
    return ref.rmsnorm_ref(x, w, eps=eps)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None,
              policy: str | None = None) -> torch.Tensor:
    """Attention in the model layout: ``q (B, Sq, Hq, D)``, ``k``/``v``
    ``(B, Sk, Hkv, D)`` -> ``(B, Sq, Hq, D)``. ``tile`` reads the model
    layout through strides, so no transposed copy is made; ``fused`` takes
    only the lengths the reference's ``chunked_attention`` takes."""
    p = _resolve(policy, "attention", q, q.shape[1])
    if p == "fused":
        # lazy: repro_torch.models imports this module
        from repro_torch.models.xla_attention import chunked_attention

        return chunked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if p == "baseline":
        return kops.attention_plain(q, k, v, causal=causal, window=window,
                                    scale=scale)
    if runtime.ACTIVE is not None:
        _kernel_level("attention", q, q.shape[1], p)
    return kops.attention(q, k, v, causal=causal, window=window, scale=scale)


def ssd(x, dt, a, b, c, *, policy: str | None = None, chunk: int | None = None,
        matmul_dtype: torch.dtype | None = None, return_state: bool = False):
    """Mamba-2 SSD scan -> ``y (B, L, H, P)``; with ``return_state=True``
    also the final state ``(B, H, P, N)`` f32.

    ``chunk``/``matmul_dtype`` tune the ``fused`` form only; the kernels'
    chunks are ``kernels/layout.HOPPER["ssd"]["q"]`` and
    ``HOPPER["ssd_logdepth"]["q"]``.
    """
    p = _resolve(policy, "ssd", x, x.shape[1])
    if p == "fused":
        y, h = ssd_chunked(x, dt, a, b, c, chunk=chunk or CHUNK,
                           matmul_dtype=matmul_dtype)
        return (y, h) if return_state else y
    if p == "baseline":
        return ref.ssd_scan_ref(x, dt, a, b, c, return_state=return_state)
    if runtime.ACTIVE is not None:
        _kernel_level("ssd_scan", x, x.shape[1], p)
    if p == "tile_logdepth":
        return kops.ssd_scan_logdepth(x, dt, a, b, c,
                                      return_state=return_state)
    return kops.ssd_scan(x, dt, a, b, c, return_state=return_state)

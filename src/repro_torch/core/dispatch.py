"""One switch for every reduce/scan/attention/SSD formulation of the port.

Every op takes ``policy=`` (see :mod:`repro_torch.core.policy`) and runs:

  ``tile``      the Hopper kernel through ``repro_torch.kernels.ops``
  ``fused``     the matmul forms of ``repro_torch.core`` (torch matmuls);
                for attention the blocked ``chunked_attention``
  ``baseline``  ``torch.sum`` / ``torch.cumsum`` / the plain oracles
  ``tile_logdepth``  scan, weighted_scan and ssd only: the carry-free local
                kernels of ``csrc/matmul_scan.cu`` and the log-depth tree of
                ``kernels/matmul_scan.py`` (the other ops raise)
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import resolve
from repro_torch.core.reduce import tcu_segmented_reduce
from repro_torch.core.scan import tcu_scan, tcu_weighted_scan
from repro_torch.core.ssd import CHUNK, ssd_chunked
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


def reduce(x: torch.Tensor, *, policy: str | None = None) -> torch.Tensor:
    """Segmented sum over the last axis -> f32 ``(...,)``."""
    p = resolve(policy, "reduce")
    if p == "fused":
        return tcu_segmented_reduce(x, formulation="fused")
    if p == "baseline":
        return torch.sum(x.float(), dim=-1)
    return kops.segmented_reduce(x)


def scan(x: torch.Tensor, *, policy: str | None = None,
         exclusive: bool = False) -> torch.Tensor:
    """Prefix sum over the last axis -> f32, same shape."""
    p = resolve(policy, "scan")
    if p == "fused":                   # core's scan is the tile algebra
        return tcu_scan(x, exclusive=exclusive)
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
    p = resolve(policy, "weighted_scan")
    if p == "fused":
        return tcu_weighted_scan(x, log_a)
    if p == "baseline":
        return ref.weighted_scan_ref(x, log_a)
    if p == "tile_logdepth":
        return kops.weighted_scan_logdepth(x, log_a)
    return kops.weighted_scan(x, log_a)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            policy: str | None = None) -> torch.Tensor:
    """RMSNorm over the last axis, in x's dtype."""
    if resolve(policy, "rmsnorm") == "tile":
        return kops.rmsnorm(x, w, eps=eps)
    return ref.rmsnorm_ref(x, w, eps=eps)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None,
              policy: str | None = None) -> torch.Tensor:
    """Attention in the model layout: ``q (B, Sq, Hq, D)``, ``k``/``v``
    ``(B, Sk, Hkv, D)`` -> ``(B, Sq, Hq, D)``. ``tile`` reads the model
    layout through strides, so no transposed copy is made; ``fused`` takes
    only the lengths the reference's ``chunked_attention`` takes."""
    p = resolve(policy, "attention")
    if p == "fused":
        # lazy: repro_torch.models imports this module
        from repro_torch.models.xla_attention import chunked_attention

        return chunked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if p == "baseline":
        return kops.attention_plain(q, k, v, causal=causal, window=window,
                                    scale=scale)
    return kops.attention(q, k, v, causal=causal, window=window, scale=scale)


def ssd(x, dt, a, b, c, *, policy: str | None = None, chunk: int | None = None,
        matmul_dtype: torch.dtype | None = None, return_state: bool = False):
    """Mamba-2 SSD scan -> ``y (B, L, H, P)``; with ``return_state=True``
    also the final state ``(B, H, P, N)`` f32.

    ``chunk``/``matmul_dtype`` tune the ``fused`` form only; the kernels'
    chunks are ``kernels/layout.HOPPER["ssd"]["q"]`` and
    ``HOPPER["ssd_logdepth"]["q"]``.
    """
    p = resolve(policy, "ssd")
    if p == "fused":
        y, h = ssd_chunked(x, dt, a, b, c, chunk=chunk or CHUNK,
                           matmul_dtype=matmul_dtype)
        return (y, h) if return_state else y
    if p == "baseline":
        return ref.ssd_scan_ref(x, dt, a, b, c, return_state=return_state)
    if p == "tile_logdepth":
        return kops.ssd_scan_logdepth(x, dt, a, b, c,
                                      return_state=return_state)
    return kops.ssd_scan(x, dt, a, b, c, return_state=return_state)

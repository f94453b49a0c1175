"""One switch for every reduce/scan/attention/SSD formulation of the port.

Counterpart of ``repro.core.dispatch``. Every op takes ``policy=`` (a
:class:`~repro_torch.core.policy.KernelPolicy`, a string shorthand or a
mapping; None: the active policy) and the per-call ``path=`` label, which
beats the policy, and resolves through ``KernelPolicy.resolve`` with the
bucket-axis size the reference passes (reduce, scan, weighted_scan and the
ragged ops: the last axis; attention and ssd: the sequence axis) and the
tensor's device:

  ``tile_gpu``  the Hopper kernel through ``repro_torch.kernels.ops``
                (``tile`` on a CUDA tensor of an H100)
  ``interpret`` the kernel's plain version (``tile`` on a CPU tensor)
  ``tile_logdepth``  scan, weighted_scan and ssd only: the carry-free local
                kernels of ``csrc/matmul_scan.cu`` and the log-depth tree of
                ``kernels/matmul_scan.py`` (the other ops raise)
  ``fused``     the matmul forms of ``repro_torch.core`` (torch matmuls);
                for attention the blocked ``chunked_attention``
  ``xla_tile``  the paper's tile algebra for the reduce
                (``formulation="tile"``), the fused forms for the others
  ``baseline``  ``torch.sum`` / ``torch.cumsum`` / the plain oracles

A kernel path resolves once more at level ``"kernel"`` under the
reference registry's name of the op with the dispatch's label as the
per-call label (``repro.kernels.backend.pallas_op``); its
:class:`~repro_torch.core.policy.TuneSpec` is the geometry the wrapper
runs. The ragged ops have no kernel in the reference either: every path
but ``baseline`` runs their one-hot matmul forms
(``repro_torch.core.ragged``).
"""
from __future__ import annotations

import torch

from repro_torch.core import costs
from repro_torch.core import policy as kpolicy
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

PATHS = kpolicy.DISPATCH_PATHS


def _resolve(pol: kpolicy.KernelPolicy, op: str, x: torch.Tensor, n: int,
             path: str | None, level: str = "dispatch"
             ) -> kpolicy.ResolvedPath:
    return pol.resolve(op=op, n=n, dtype=x.dtype, level=level, explicit=path,
                       device=x.device)


def _kernel(pol: kpolicy.KernelPolicy, name: str, x: torch.Tensor, n: int,
            label: str) -> kpolicy.ResolvedPath:
    """The registry's resolution of a kernel path: level ``"kernel"``, the
    registry's name of the op, the dispatch's label as the per-call one."""
    return _resolve(pol, name, x, n, label, level="kernel")


def _no_logdepth(op: str) -> RuntimeError:
    return RuntimeError(
        f"{op}: no log-depth MatMulScan kernel for this op (tile_logdepth "
        f"covers the scan family: {', '.join(kpolicy.LOGDEPTH_OPS)}); use "
        "tile, fused or baseline, e.g. 'ssd=tile_logdepth'")


def reduce(x: torch.Tensor, *, policy=None,
           path: str | None = None) -> torch.Tensor:
    """Segmented sum over the last axis -> f32 ``(...,)``."""
    if costs.ACTIVE is not None:     # an op analyser charges the call
        return costs.ACTIVE.charge("reduce", reduce, (x,),
                                   dict(policy=policy, path=path))
    pol = kpolicy.as_policy(policy)
    p = _resolve(pol, "reduce", x, x.shape[-1], path)
    if p == "fused":
        return tcu_segmented_reduce(x, formulation="fused")
    if p == "xla_tile":
        return tcu_segmented_reduce(x, formulation="tile")
    if p == "baseline":
        return torch.sum(x.float(), dim=-1)
    kp = _kernel(pol, "segmented_reduce", x, x.shape[-1], p)
    if kp == "tile_logdepth":
        raise _no_logdepth("reduce")
    return kops.segmented_reduce(x, path=kp, tuning=kp.tuning)


def scan(x: torch.Tensor, *, policy=None, path: str | None = None,
         exclusive: bool = False) -> torch.Tensor:
    """Prefix sum over the last axis -> f32, same shape."""
    if costs.ACTIVE is not None:     # an op analyser charges the call
        return costs.ACTIVE.charge(
            "scan", scan, (x,),
            dict(policy=policy, path=path, exclusive=exclusive))
    pol = kpolicy.as_policy(policy)
    p = _resolve(pol, "scan", x, x.shape[-1], path)
    if p in ("fused", "xla_tile"):     # core's scan is the tile algebra
        return tcu_scan(x, exclusive=exclusive)
    if p == "baseline":
        out = torch.cumsum(x.float(), dim=-1)
    else:
        kp = _kernel(pol, "segmented_scan", x, x.shape[-1], p)
        if kp == "tile_logdepth":
            out = kops.segmented_scan_logdepth(x, tuning=kp.tuning)
        else:
            out = kops.segmented_scan(x, path=kp, tuning=kp.tuning)
    if exclusive:
        # shift, never subtract: ``inclusive - x`` cancels catastrophically
        # when |x_i| dwarfs the running prefix
        out = torch.cat([torch.zeros_like(out[..., :1]), out[..., :-1]],
                        dim=-1)
    return out


def weighted_scan(x: torch.Tensor, log_a: torch.Tensor, *, policy=None,
                  path: str | None = None) -> torch.Tensor:
    """Decayed scan ``y_i = exp(log_a_i) * y_{i-1} + x_i`` -> f32."""
    if costs.ACTIVE is not None:     # an op analyser charges the call
        return costs.ACTIVE.charge("weighted_scan", weighted_scan,
                                   (x, log_a), dict(policy=policy, path=path))
    pol = kpolicy.as_policy(policy)
    p = _resolve(pol, "weighted_scan", x, x.shape[-1], path)
    if p in ("fused", "xla_tile"):
        return tcu_weighted_scan(x, log_a)
    if p == "baseline":
        return ref.weighted_scan_ref(x, log_a)
    kp = _kernel(pol, "weighted_scan", x, x.shape[-1], p)
    if kp == "tile_logdepth":
        return kops.weighted_scan_logdepth(x, log_a, tuning=kp.tuning)
    return kops.weighted_scan(x, log_a, path=kp, tuning=kp.tuning)


# ---------------------------------------------------------------------------
# ragged (irregular) segments, the paper's footnote-4 case


def ragged_reduce(x: torch.Tensor, seg_ids: torch.Tensor, n_segments: int,
                  *, policy=None, path: str | None = None) -> torch.Tensor:
    """Bucketed segmented sum: ``x (..., n)`` + ``seg_ids`` -> f32
    ``(..., n_segments)``. ``baseline``: torch's segment sum
    (``scatter_add``); every other path: the one-hot matmul form.
    ``seg_ids`` may carry leading batch dims; any id order is valid, and ids
    outside ``[0, n_segments)`` contribute nowhere."""
    if costs.ACTIVE is not None:     # an op analyser charges the call
        return costs.ACTIVE.charge(
            "ragged_reduce", ragged_reduce, (x, seg_ids, n_segments),
            dict(policy=policy, path=path))
    pol = kpolicy.as_policy(policy)
    p = _resolve(pol, "ragged_reduce", x, x.shape[-1], path)
    if p == "baseline":
        return _segment_sum_baseline(x, seg_ids, n_segments)
    if p == "tile_logdepth":
        raise _no_logdepth("ragged_reduce")
    return tcu_ragged_segment_reduce(x, seg_ids, n_segments)


def ragged_scan(x: torch.Tensor, seg_ids: torch.Tensor, n_segments: int, *,
                policy=None, path: str | None = None,
                debug: bool = False) -> torch.Tensor:
    """Within-segment inclusive prefix sum -> f32, the shape of ``x``.
    ``seg_ids`` must be non-decreasing on every path (``debug=True``
    validates, :func:`~repro_torch.core.ragged.guard_contiguous`).
    ``baseline``: ``cumsum``, the segment sum and a gather; every other
    path: the matmul form."""
    if costs.ACTIVE is not None:     # an op analyser charges the call
        return costs.ACTIVE.charge(
            "ragged_scan", ragged_scan, (x, seg_ids, n_segments),
            dict(policy=policy, path=path, debug=debug))
    pol = kpolicy.as_policy(policy)
    p = _resolve(pol, "ragged_scan", x, x.shape[-1], path)
    if p == "baseline":
        out = _ragged_scan_baseline(x, seg_ids, n_segments)
        return guard_contiguous(seg_ids, out) if debug else out
    if p == "tile_logdepth":
        raise _no_logdepth("ragged_scan")
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
            policy=None, path: str | None = None) -> torch.Tensor:
    """RMSNorm over the last axis, in x's dtype. The reference has RMSNorm
    in its kernel registry only (``repro.kernels.ops.rmsnorm``), so it
    resolves once, at level ``"kernel"``, where ``fused`` is the plain
    version; its registry records that run as a ``kernel_invoke`` on
    ``fused`` too, and so does the port."""
    if costs.ACTIVE is not None:     # an op analyser charges the call
        return costs.ACTIVE.charge("rmsnorm", rmsnorm, (x, w),
                                   dict(eps=eps, policy=policy, path=path))
    pol = kpolicy.as_policy(policy)
    kp = _resolve(pol, "rmsnorm", x, x.shape[-1], path, level="kernel")
    if kp == "fused":
        if runtime.ACTIVE is not None:
            kops._invoked("rmsnorm", x.shape[-1], x, "fused", {})
        return ref.rmsnorm_ref(x, w, eps=eps)
    if kp == "tile_logdepth":
        raise _no_logdepth("rmsnorm")
    return kops.rmsnorm(x, w, eps=eps, path=kp, tuning=kp.tuning)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None, policy=None,
              path: str | None = None) -> torch.Tensor:
    """Attention in the model layout: ``q (B, Sq, Hq, D)``, ``k``/``v``
    ``(B, Sk, Hkv, D)`` -> ``(B, Sq, Hq, D)``. The kernel reads the model
    layout through strides, so no transposed copy is made; ``fused`` takes
    only the lengths the reference's ``chunked_attention`` takes."""
    if costs.ACTIVE is not None:     # an op analyser charges the call
        return costs.ACTIVE.charge(
            "attention", attention, (q, k, v),
            dict(causal=causal, window=window, scale=scale, policy=policy,
                 path=path))
    pol = kpolicy.as_policy(policy)
    p = _resolve(pol, "attention", q, q.shape[1], path)
    if p in ("fused", "xla_tile"):
        # lazy: repro_torch.models imports this module
        from repro_torch.models.xla_attention import chunked_attention

        return chunked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if p == "baseline":
        return kops.attention_plain(q, k, v, causal=causal, window=window,
                                    scale=scale)
    kp = _kernel(pol, "attention", q, q.shape[1], p)
    if kp == "tile_logdepth":
        raise _no_logdepth("attention")
    return kops.attention(q, k, v, causal=causal, window=window, scale=scale,
                          path=kp, tuning=kp.tuning)


def ssd(x, dt, a, b, c, *, policy=None, path: str | None = None,
        chunk: int | None = None, matmul_dtype: torch.dtype | None = None,
        return_state: bool = False):
    """Mamba-2 SSD scan -> ``y (B, L, H, P)``; with ``return_state=True``
    also the final state ``(B, H, P, N)`` f32.

    ``chunk``/``matmul_dtype`` tune the ``fused`` form only; the kernels'
    chunk is the ``ssd.q`` knob (``KernelPolicy.op_tuning``, ``"tile,
    ssd.q=32"``, ``--tune "ssd.q=32"``; default
    ``layout.DEFAULT_TUNING["gpu"]["ssd"]``).
    """
    if costs.ACTIVE is not None:     # an op analyser charges the call
        return costs.ACTIVE.charge(
            "ssd", ssd, (x, dt, a, b, c),
            dict(policy=policy, path=path, chunk=chunk,
                 matmul_dtype=matmul_dtype, return_state=return_state))
    pol = kpolicy.as_policy(policy)
    p = _resolve(pol, "ssd", x, x.shape[1], path)
    if p in ("fused", "xla_tile"):
        y, h = ssd_chunked(x, dt, a, b, c, chunk=chunk or CHUNK,
                           matmul_dtype=matmul_dtype)
        return (y, h) if return_state else y
    if p == "baseline":
        return ref.ssd_scan_ref(x, dt, a, b, c, return_state=return_state)
    kp = _kernel(pol, "ssd_scan", x, x.shape[1], p)
    if kp == "tile_logdepth":
        return kops.ssd_scan_logdepth(x, dt, a, b, c, tuning=kp.tuning,
                                      return_state=return_state)
    return kops.ssd_scan(x, dt, a, b, c, path=kp, tuning=kp.tuning,
                         return_state=return_state)

"""MatMulScan's log-depth tree combine, in batched torch matmuls.

Counterpart of ``repro.kernels.matmul_scan``'s tree (Zouzias & McColl's
radix-``s`` Brent-Kung scan on tensor cores): the carry-free local block
passes run as the hand-written kernels of ``csrc/matmul_scan.cu``; the
per-block totals are then combined here in ``O(log_radix nblocks)`` rounds,
each a batched matmul against a constant matrix:

  ``U_s``  upper-triangular ones: ``t @ U_s`` scans every group of ``s``
           neighbours (the upsweep), one matmul per tree level;
  ``B_s``  a ``1 x s`` ones row: ``carry[..., None] @ B_s`` hands each
           group's exclusive carry to its ``s`` children (the downsweep).

The weighted variant swaps ``U_s`` for the 1-semiseparable mask
``exp(segsum(logp))`` and scales the downsweep carry by the within-group
cumulative decay. Zero padding of a ragged tail is the identity of both
combines (``logp = 0`` is decay 1 and ``t = 0`` adds nothing), so the tail
never leaks back. Everything here runs in f32 on whatever device ``t``
lies on; ``radix`` and ``fan_in`` come from ``kernels/layout.HOPPER``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tiles import segsum, u_matrix


def upper_tri_ones(t: int, device=None) -> torch.Tensor:
    """``U_t``: ``a @ U_t`` is a row-wise inclusive scan of ``a``."""
    return u_matrix(t, torch.float32, device)


def broadcast_row(t: int, device=None) -> torch.Tensor:
    """``B_t`` as a ``1 x t`` ones row: the downsweep broadcast."""
    return torch.ones((1, t), dtype=torch.float32, device=device)


def shift_right(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive -> exclusive along ``dim``: drop the last slot and prepend
    the combine identity (0 for both the sum and the weighted combine);
    a shift, never ``inclusive - x``."""
    dim = dim % x.ndim
    pad = [0, 0] * (x.ndim - 1 - dim) + [1, 0]
    return F.pad(x, pad).narrow(dim, 0, x.shape[dim])


def tree_scan(t: torch.Tensor, *, radix: int, fan_in: int) -> torch.Tensor:
    """Inclusive prefix sum of ``t (..., m)`` in f32, in
    ``O(log_radix m)`` rounds of batched matmuls.

    Each level groups ``radix`` neighbours, scans every group with one
    batched ``@ U`` (upsweep), recurses on the group totals, and adds the
    recursion's exclusive carries back through ``carry @ B`` (downsweep).
    A sequence of at most ``fan_in`` is finished with one triangular
    matmul, the base of the recursion.
    """
    radix, fan_in = max(2, int(radix)), max(1, int(fan_in))
    t = t.float()
    m = t.shape[-1]
    if m <= fan_in:
        return t @ upper_tri_ones(m, t.device)
    groups = -(-m // radix)
    tg = F.pad(t, (0, groups * radix - m)).unflatten(-1, (groups, radix))
    local = tg @ upper_tri_ones(radix, t.device)           # upsweep
    carry = tree_scan(local[..., -1], radix=radix, fan_in=fan_in)
    exc = shift_right(carry, -1)
    local = local + exc[..., None] @ broadcast_row(radix, t.device)
    return local.flatten(-2)[..., :m]


def tree_weighted(logp: torch.Tensor, t: torch.Tensor, *, radix: int,
                  fan_in: int) -> torch.Tensor:
    """Weighted inclusive scan ``h_k = exp(logp_k) h_{k-1} + t_k`` in
    ``O(log_radix m)`` rounds, for ``logp (..., m)`` and ``t (..., m, F)``
    (``F`` flat trailing features: 1 for the scalar scans, ``N * P`` for
    SSD chunk states). Returns f32 ``h`` of ``t``'s shape.

    The tree of :func:`tree_scan` with the triangular ones replaced by the
    mask ``exp(segsum(logp))`` in the upsweep (``segsum`` is ``-inf`` above
    the diagonal, so the mask is exactly 0 there), and the downsweep carry
    scaled by the within-group cumulative decay ``exp(logp @ U)``.
    """
    radix, fan_in = max(2, int(radix)), max(1, int(fan_in))
    logp, t = logp.float(), t.float()
    m = logp.shape[-1]
    if m <= fan_in:
        return torch.exp(segsum(logp)) @ t
    groups = -(-m // radix)
    pad = groups * radix - m
    lg = F.pad(logp, (0, pad)).unflatten(-1, (groups, radix))
    tg = F.pad(t, (0, 0, 0, pad)).unflatten(-2, (groups, radix))
    local = torch.exp(segsum(lg)) @ tg                      # (..., g, r, F)
    carry = tree_weighted(lg.sum(-1), local[..., -1, :], radix=radix,
                          fan_in=fan_in)
    exc = shift_right(carry, -2)                            # (..., g, F)
    cum = lg @ upper_tri_ones(radix, t.device)              # within-group
    local = local + torch.exp(cum)[..., None] * exc[..., None, :]
    return local.flatten(-3, -2)[..., :m, :]

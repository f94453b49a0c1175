"""Matmul-form scan / prefix-sum (the paper's Section 5) as torch matmuls.

For a TxT tile A: ``Scan(A) = A @ U + (L @ A) @ 1``. Arbitrary lengths use a
recursive two-level composition (scan tiles, scan the tile totals, add the
exclusive carries), the paper's scan-then-propagate strategy. The weighted
scan ``y_i = a_i * y_{i-1} + x_i`` replaces the triangular ones masks with
``exp(segsum(log a))``: the bridge to Mamba-2's SSD.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tiles import (
    DEFAULT_TILE,
    segsum,
    strict_u_matrix,
    u_matrix,
)


def _accum_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else dtype


def _pad_last(x: torch.Tensor, rem: int) -> torch.Tensor:
    return F.pad(x, (0, rem)) if rem else x


def _row_scan(x: torch.Tensor, tile: int, *,
              exclusive: bool = False) -> torch.Tensor:
    """Scan the last axis (must equal ``tile``) via a triangular matmul."""
    acc = _accum_dtype(x.dtype)
    u = (strict_u_matrix if exclusive else u_matrix)(tile, acc, x.device)
    return x.to(acc) @ u


def tcu_scan(x: torch.Tensor, *, tile: int = DEFAULT_TILE,
             exclusive: bool = False) -> torch.Tensor:
    """Inclusive (or exclusive) prefix sum along the last axis, matmul-form.

    Depth is ceil(log_T n): pad to a tile multiple, row-scan every tile with
    one triangular matmul, recursively scan the tile totals, and add the
    exclusive totals back as per-tile carries.
    """
    acc = _accum_dtype(x.dtype)
    n = x.shape[-1]
    if n == 0:
        return x.to(acc)
    if n <= tile:
        t_eff = tile if n > 8 else n  # tiny inputs: exact-size triangle
        xp = _pad_last(x, (-n) % t_eff)
        return _row_scan(xp, t_eff, exclusive=exclusive)[..., :n]

    lead = x.shape[:-1]
    xp = _pad_last(x, (-n) % tile)
    k = xp.shape[-1] // tile
    tiles = xp.reshape(*lead, k, tile)
    scanned = _row_scan(tiles, tile)                  # (..., k, T) inclusive
    carries = tcu_scan(scanned[..., -1], tile=tile, exclusive=True)
    if exclusive:
        scanned = _row_scan(tiles, tile, exclusive=True)
    out = scanned + carries[..., None].to(acc)
    return out.reshape(*lead, k * tile)[..., :n]


def tcu_segmented_scan(x: torch.Tensor, *, tile: int = DEFAULT_TILE,
                       exclusive: bool = False) -> torch.Tensor:
    """Regular segmented scan (the paper's Scan_K): the last axis scanned
    independently per segment; leading axes index segments."""
    return tcu_scan(x, tile=tile, exclusive=exclusive)


def tcu_weighted_scan(x: torch.Tensor, log_a: torch.Tensor, *,
                      tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Decayed scan ``y_i = a_i * y_{i-1} + x_i`` with ``a = exp(log_a)``.

    Within a tile ``y = M @ x`` with ``M = exp(segsum(log_a))``; across tiles
    the carry ``carry_k = A_k * carry_{k-1} + total_k`` is itself a weighted
    scan over the tile totals, computed with the same tile algebra.
    """
    acc = _accum_dtype(x.dtype)
    n = x.shape[-1]
    if n <= tile:
        m = torch.exp(segsum(log_a.to(acc)))
        return torch.einsum("...ij,...j->...i", m, x.to(acc))

    rem = (-n) % tile
    x = _pad_last(x, rem)
    log_a = _pad_last(log_a, rem)     # log a = 0 -> decay 1, harmless tail
    k = x.shape[-1] // tile
    xt = x.reshape(*x.shape[:-1], k, tile).to(acc)
    lat = log_a.reshape(*log_a.shape[:-1], k, tile).to(acc)
    m = torch.exp(segsum(lat))                              # (..., k, T, T)
    intra = torch.einsum("...ij,...j->...i", m, xt)         # per-tile scan
    totals = intra[..., -1]                                 # (..., k)
    tile_decay = torch.sum(lat, dim=-1)                     # log total decay
    carry_in = _weighted_exclusive(totals, tile_decay)      # (..., k)
    out = intra + carry_in[..., None] * torch.exp(torch.cumsum(lat, dim=-1))
    return out.reshape(*out.shape[:-2], k * tile)[..., :n]


def _weighted_exclusive(totals: torch.Tensor,
                        log_decay: torch.Tensor) -> torch.Tensor:
    """Exclusive weighted scan over the last axis: the carry entering block i
    is the inclusive weighted-scan state after block i-1 (carry_0 = 0),
    shifted right from ``exp(segsum(log_decay)) @ totals``."""
    s = torch.einsum("...ij,...j->...i", torch.exp(segsum(log_decay)), totals)
    return torch.cat([torch.zeros_like(s[..., :1]), s[..., :-1]], dim=-1)

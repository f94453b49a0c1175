"""Matmul-form reduction (the paper's Section 4) as torch matmuls.

* ``formulation="tile"`` — the paper-faithful tile algebra: TxT tiles, each
  hit with ``P @ A``; partial rows accumulate across tiles (the
  work-efficient Reduction_{256N}, Fig. 7) and a final ``V @ P^T`` collapses
  the surviving row.
* ``formulation="fused"`` — one ``blocks @ ones`` product, T times fewer
  operations than the tile form.

Floating inputs accumulate in float32: operands are cast to f32 before the
product (a product with 1 is exact), matching the tensor cores'
low-precision-in / f32-accumulate mode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tiles import DEFAULT_TILE, p_matrix


def _accum_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else dtype


def _pad_last_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    rem = (-x.shape[-1]) % multiple
    return F.pad(x, (0, rem)) if rem else x


def tcu_segmented_reduce(x: torch.Tensor, *, tile: int = DEFAULT_TILE,
                         formulation: str = "fused") -> torch.Tensor:
    """Reduce the last axis of ``x``; leading axes index segments.

    Padding to the tile multiple is zero-fill, the paper's approach to
    arbitrary segment sizes.
    """
    acc = _accum_dtype(x.dtype)
    n = x.shape[-1]
    lead = x.shape[:-1]
    xa = x.to(acc)
    if formulation == "fused":
        blocks = _pad_last_to(xa, tile).reshape(*lead, -1, tile)
        ones = torch.ones((tile,), dtype=acc, device=x.device)
        partial = torch.matmul(blocks, ones)                  # (..., n_tiles)
        return torch.sum(partial, dim=-1)
    if formulation != "tile":
        raise ValueError(f"unknown formulation {formulation!r}")

    p = p_matrix(tile, acc, x.device)
    if n <= tile:
        # one row per segment, reduced by A @ P^T; column 0 holds the sums
        flat = _pad_last_to(xa, tile).reshape(-1, tile)
        return (flat @ p.T)[:, 0].reshape(lead)

    xp = _pad_last_to(xa, tile * tile)
    k = xp.shape[-1] // (tile * tile)
    tiles = xp.reshape(*lead, k, tile, tile)
    v = torch.zeros((*lead, tile, tile), dtype=acc, device=x.device)
    for i in range(k):
        v = v + p @ tiles[..., i, :, :]                     # V <- P @ A + V
    # epilogue: R = V @ P^T reduces the first row to a scalar at [0, 0]
    return (v @ p.T)[..., 0, 0]


def tcu_reduce(x: torch.Tensor, *, tile: int = DEFAULT_TILE,
               formulation: str = "fused") -> torch.Tensor:
    """Full reduction of ``x`` (flattened), matmul-form."""
    return tcu_segmented_reduce(x.reshape(1, -1), tile=tile,
                                formulation=formulation)[0]

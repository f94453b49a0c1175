"""Constructor matrices for the matmul-form reduction/scan algebra.

The paper (Dakkak et al., ICS'19) expresses reduction and scan in terms of
three constant matrices over a TxT tile:

  P  : ones in row 0, zeros elsewhere.         P @ A   reduces each column of A.
  U  : upper-triangular ones (incl. diagonal). A @ U   row-wise inclusive scan.
  L  : strictly-lower-triangular ones.         L @ A   column-wise exclusive scan.

The tile edge is the paper's 16, which is also the edge of a Hopper
tensor-core fragment (``wmma`` 16x16x16).
"""
from __future__ import annotations

import torch

# Tensor-core fragment edge (the paper's "16").
DEFAULT_TILE = 16


def _iota(t: int, device):
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    return rows, cols


def p_matrix(t: int = DEFAULT_TILE, dtype=torch.float32, device=None):
    """P: ones in the first row. ``P @ A`` sums each column of A."""
    rows, cols = _iota(t, device)
    return (rows == 0).expand(t, t).to(dtype)


def u_matrix(t: int = DEFAULT_TILE, dtype=torch.float32, device=None):
    """U: upper-triangular ones including the diagonal.

    ``A @ U`` is a row-wise inclusive scan of A.
    """
    rows, cols = _iota(t, device)
    return (rows <= cols).to(dtype)


def strict_u_matrix(t: int = DEFAULT_TILE, dtype=torch.float32, device=None):
    """Strictly-upper-triangular ones. ``A @ sU`` is a row-wise exclusive
    scan."""
    rows, cols = _iota(t, device)
    return (rows < cols).to(dtype)


def l_matrix(t: int = DEFAULT_TILE, dtype=torch.float32, device=None):
    """L: strictly-lower-triangular ones. ``L @ A`` column-wise exclusive
    scan."""
    rows, cols = _iota(t, device)
    return (rows > cols).to(dtype)


def ones_matrix(t: int = DEFAULT_TILE, dtype=torch.float32, device=None):
    """The paper's all-ones broadcast matrix (their bold-1)."""
    return torch.ones((t, t), dtype=dtype, device=device)


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: ``out[..., i, j] = sum(log_a[..., j+1:i+1])``
    (tril), ``-inf`` above the diagonal so that ``exp`` gives exact zeros.

    ``exp(segsum(log a))`` is the Mamba-2 / SSD 1-semiseparable decay matrix
    ``M[i, j] = prod_{k=j+1..i} a_k``; with ``log_a == 0`` it is the paper's
    (L + I) mask.
    """
    t = log_a.shape[-1]
    csum = torch.cumsum(log_a, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    rows, cols = _iota(t + 1, log_a.device)
    out = diff.masked_fill(~(rows >= cols), float("-inf"))
    return out[..., 1:, 1:]

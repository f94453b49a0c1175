"""Irregular (ragged) segmented reduction and scan, matmul-form.

Counterpart of ``repro.core.ragged``. A ragged segmented reduction is a
matrix product against the segment one-hot matrix::

    out[s] = sum_i 1[seg_id[i] == s] * x[i]     =     x @ O

with ``O[i, s] = 1[seg_id[i] == s]`` built from an iota compare (no gather
or scatter). The ragged scan composes the regular matmul-form scan
(:func:`repro_torch.core.scan.tcu_scan`) with a segment-restart
correction: within-segment prefix = global prefix minus the totals of the
preceding segments, one more one-hot product.

``seg_ids`` may carry leading batch dims (broadcast against ``x``): the MoE
router's per-group expert assignments use them. The reference computes
these forms outside any Pallas kernel, so here they are torch matmuls.
"""
from __future__ import annotations

import torch

from repro_torch.core.scan import tcu_scan


def _onehot(seg_ids: torch.Tensor, n_segments: int,
            dtype: torch.dtype) -> torch.Tensor:
    """``O[..., i, s] = 1[seg_ids[..., i] == s]``."""
    cols = torch.arange(n_segments, device=seg_ids.device)
    return (seg_ids[..., None] == cols).to(dtype)


def _capturing(seg_ids: torch.Tensor) -> bool:
    """Whether ``seg_ids`` cannot be read on the host: a CUDA graph is being
    captured on the current stream (the counterpart of a traced value)."""
    return seg_ids.is_cuda and torch.cuda.is_current_stream_capturing()


def guard_contiguous(seg_ids: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """Validity gate for contiguous-segment algorithms (debug path).

    Checks that ``seg_ids`` is non-decreasing along the last axis, the
    precondition of the prefix-minus-preceding-totals scan. With ids that
    can be read this raises ``ValueError`` eagerly; while a CUDA graph is
    being captured no device value may be read, so the output is poisoned
    with NaN instead (the reference's traced branch), and bad ids are loud
    in either mode.
    """
    ok = torch.all(seg_ids[..., 1:] >= seg_ids[..., :-1])
    if _capturing(seg_ids):
        return torch.where(ok, out, torch.nan)
    if not bool(ok):
        raise ValueError(
            "tcu_ragged_segment_scan: seg_ids must be non-decreasing "
            "(contiguous segments); sort inputs by segment first or use "
            "tcu_ragged_segment_reduce, which accepts any order")
    return out


def tcu_ragged_segment_reduce(x: torch.Tensor, seg_ids: torch.Tensor,
                              n_segments: int) -> torch.Tensor:
    """Sum ``x (..., n)`` into f32 ``(..., n_segments)`` buckets by
    ``seg_ids`` (``(n,)`` or batched ``(..., n)``): ``out = x @ O``. Any id
    order is valid; ids outside ``[0, n_segments)`` contribute nowhere
    (their one-hot row is all zero)."""
    o = _onehot(seg_ids, n_segments, torch.float32)
    return torch.einsum("...i,...is->...s", x.float(), o)


def tcu_ragged_segment_scan(x: torch.Tensor, seg_ids: torch.Tensor,
                            n_segments: int, *,
                            debug: bool = False) -> torch.Tensor:
    """Within-segment inclusive prefix sum for contiguous ragged segments,
    f32, the shape of ``x``.

    ``y_i = sum_{j <= i, seg[j] == seg[i]} x_j``: the global matmul-form
    scan minus each segment's preceding total, the preceding totals an
    exclusive scan of the ragged reduce re-broadcast through the one-hot.
    ``seg_ids`` MUST be non-decreasing along the last axis; other ids give
    wrong values silently unless ``debug=True`` (:func:`guard_contiguous`).
    """
    xf = x.float()
    global_scan = tcu_scan(xf)                                  # (..., n)
    o = _onehot(seg_ids, n_segments, torch.float32)             # (..., n, S)
    totals = torch.einsum("...i,...is->...s", xf, o)            # (..., S)
    prior = tcu_scan(totals, exclusive=True)                    # (..., S)
    offset = torch.einsum("...s,...is->...i", prior, o)         # (..., n)
    out = global_scan - offset
    if debug:
        out = guard_contiguous(seg_ids, out)
    return out

"""Gradient compression for the cross-pod all-reduce.

Counterpart of ``repro.optim.compress``: bf16 with stochastic rounding and
per-leaf error feedback, so the all-reduce moves half the bytes and the
quantisation error is carried to the next step (the expected update is
unbiased). The noise comes from an explicit ``torch.Generator``; the
reference draws it with ``jax.random``, so the two agree in distribution,
not bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import tree

# 0xFFFF0000 as an int32: torch has little uint32 arithmetic, so the bits
# are handled as int32, where two's-complement wrap-around stands in for
# uint32 overflow
_HIGH_HALF = -65536


def stochastic_round_bf16(x: torch.Tensor,
                          gen: torch.Generator) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding (unbiased): add 16 random low
    bits to the f32 pattern, then drop the low half."""
    xi = x.float().contiguous().view(torch.int32)
    noise = torch.randint(0, 1 << 16, x.shape, generator=gen,
                          dtype=torch.int32, device=x.device)
    rounded = (xi + noise) & _HIGH_HALF
    return rounded.view(torch.float32).to(torch.bfloat16)


def compress_grads(grads, error_buf, gen: torch.Generator):
    """-> (bf16 grads to all-reduce, new error buffer), drawing each leaf's
    noise from ``gen`` in the reference's leaf order."""
    flat = tree.leaves(grads)
    ebuf = (tree.leaves(error_buf) if error_buf is not None
            else [torch.zeros_like(g) for g in flat])
    comp, errs = [], []
    for g, e in zip(flat, ebuf):
        corrected = g.float() + e.float()
        q = stochastic_round_bf16(corrected, gen)
        comp.append(q)
        errs.append((corrected - q.float()).to(g.dtype))
    return tree.unflatten(grads, comp), tree.unflatten(grads, errs)

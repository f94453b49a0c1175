"""What each dispatch op computes, counted: FLOPs and bytes by formula.

The count charges an op of :mod:`repro_torch.core.dispatch` by the function
it computes, not by how a path computes it, so the plain version, the
Hopper kernel and a library call give one count. The kernel table of
``chip_smoke.py`` takes its bounds from these formulas, and
``repro_torch.launch.op_analysis`` charges every dispatch call with them.

``ACTIVE`` is the op analyser watching this process, or None. Each
dispatch op checks it once; with no analyser that check is all it costs.
"""
from __future__ import annotations

import numpy as np

ACTIVE = None          # launch.op_analysis.OpAnalyser while one runs

SSD_CHUNK = 64         # the chunk the SSD count assumes (the kernels' q)


def nbytes(*tensors) -> int:
    """Bytes of the tensors' elements (each counted once as given)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def ssd_flops(bsz, seqlen, nheads, hdim, nstate, q=SSD_CHUNK) -> int:
    """Mamba-2 SSD over chunks of ``q``: the intra-chunk products ``C B^T``
    and ``G X`` on the kept triangle, the state read ``(C exp Λ) H`` and the
    state update ``(B w)^T X``; two operations a multiply-add."""
    tri = q * (q + 1) // 2
    per_chunk = 2 * (tri * nstate + tri * hdim + 2 * q * nstate * hdim)
    return bsz * nheads * (-(-seqlen // q)) * per_chunk


def local_ssd_flops(bsz, seqlen, nheads, hdim, nstate, q=SSD_CHUNK) -> int:
    """The chunk products without the carried state: C B^T and G X on the
    kept triangle, and the chunk state (B w)^T X."""
    tri = q * (q + 1) // 2
    per_chunk = 2 * (tri * nstate + tri * hdim + q * nstate * hdim)
    return bsz * nheads * (-(-seqlen // q)) * per_chunk


def attention_pairs(lq, lk, causal, window) -> int:
    """(query, key) pairs the mask leaves visible, ends aligned by lk - lq:
    the work this input needs, not the full lq x lk."""
    qpos = np.arange(lq, dtype=np.int64) + (lk - lq)
    hi = np.minimum(lk, qpos + 1) if causal else np.full(lq, lk, np.int64)
    lo = (np.maximum(0, qpos - window + 1) if window is not None
          else np.zeros(lq, np.int64))
    return int(np.maximum(0, hi - lo).sum())


def attention_flops(bsz, lq, lk, hq, dh, causal=True, window=None) -> int:
    """``Q K^T`` and ``P V`` over the visible pairs: 4 D a pair a head."""
    return 4 * dh * attention_pairs(lq, lk, causal, window) * bsz * hq


def rmsnorm_flops(numel: int) -> int:
    """Square, sum, scale and weight: 4 an element."""
    return 4 * numel


def op_flops(op: str, args: tuple, kwargs: dict) -> int:
    """FLOPs of one call of dispatch op ``op`` on ``args``/``kwargs``, the
    function it computes: a sum or prefix sum one an element, the decayed
    scan two (a multiply-add), RMSNorm four, attention and the SSD their
    products (:func:`attention_flops`, :func:`ssd_flops`)."""
    x = args[0]
    if op in ("reduce", "scan", "ragged_reduce", "ragged_scan"):
        return x.numel()
    if op == "weighted_scan":
        return 2 * x.numel()
    if op == "rmsnorm":
        return rmsnorm_flops(x.numel())
    if op == "attention":
        q, k = args[0], args[1]
        return attention_flops(q.shape[0], q.shape[1], k.shape[1],
                               q.shape[2], q.shape[3],
                               kwargs.get("causal", True),
                               kwargs.get("window"))
    if op == "ssd":
        b = args[3]
        bsz, seqlen, nheads, hdim = x.shape
        return ssd_flops(bsz, seqlen, nheads, hdim, b.shape[-1])
    raise KeyError(f"no cost formula for dispatch op {op!r}")

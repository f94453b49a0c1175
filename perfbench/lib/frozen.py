"""Frozen copies of the program's sound measuring pieces.

Each piece is copied from the repository at commit d261ad5 and names its
source file. The benchmark keeps its own copy so that a change to the
program cannot move the yardstick; the originals stay in the program.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# The card's constants: src/repro_torch/launch/mesh.py @ d261ad5 (NVIDIA's
# H100 SXM5 80GB data sheet, dense tensor-core rates, 700 W).

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 and f16 tensor cores
HBM_BW = 3.35e12                  # bytes/s of HBM3

# ---------------------------------------------------------------------------
# Kernels by name: chip_smoke.py::KINDS, REDUCE_KERNELS, SCAN_KERNELS,
# kind_of @ d261ad5.

KINDS = ("flash_attention", "ssd_scan", "local_ssd", "rmsnorm", "gemm")
REDUCE_KERNELS = ("piece_totals", "tcu_reduce_combine")
SCAN_KERNELS = ("piece_scan", "tcu_scan_carry")
# every __global__ kernel of src/repro_torch/csrc @ d261ad5: the port's own
PORT_KERNELS = ("flash_attention", "local_ssd", "piece_scan", "piece_totals",
                "rmsnorm_kernel", "ssd_scan", "tcu_reduce_combine",
                "tcu_scan_carry", "wscan_carry", "wscan_fold", "wscan_pass")


def kind_of(name: str) -> str:
    """This repository's kernels by name (``tcu_reduce.cu``'s as
    ``reduce``, ``tcu_scan.cu``'s as ``scan``), matrix products
    (cuBLAS/CUTLASS kernels) as ``gemm``, the rest as ``other``."""
    name = name.lower()
    if any(k in name for k in REDUCE_KERNELS):
        return "reduce"
    if any(k in name for k in SCAN_KERNELS):
        return "scan"
    kind = next((k for k in KINDS if k in name), None)
    if kind is None and any(t in name for t in ("gemm", "xmma", "cutlass",
                                                 "nvjet")):
        kind = "gemm"
    return kind or "other"


def is_port_kernel(name: str) -> bool:
    """One of ``csrc``'s kernels (not cuBLAS's, not torch's own)."""
    name = name.lower()
    return any(k in name for k in PORT_KERNELS)


# ---------------------------------------------------------------------------
# Operation counts: src/repro_torch/core/costs.py @ d261ad5.

SSD_CHUNK = 64         # the chunk the SSD count assumes (the kernels' q)


def ssd_flops(bsz, seqlen, nheads, hdim, nstate, q=SSD_CHUNK) -> int:
    """Mamba-2 SSD over chunks of ``q``: the intra-chunk products ``C B^T``
    and ``G X`` on the kept triangle, the state read ``(C exp L) H`` and the
    state update ``(B w)^T X``; two operations a multiply-add."""
    tri = q * (q + 1) // 2
    per_chunk = 2 * (tri * nstate + tri * hdim + 2 * q * nstate * hdim)
    return bsz * nheads * (-(-seqlen // q)) * per_chunk


def rmsnorm_flops(numel: int) -> int:
    """Square, sum, scale and weight: 4 an element."""
    return 4 * numel


def attention_pairs(lq, lk, causal, window) -> int:
    """(query, key) pairs the mask leaves visible, ends aligned by lk - lq."""
    qpos = np.arange(lq, dtype=np.int64) + (lk - lq)
    hi = np.minimum(lk, qpos + 1) if causal else np.full(lq, lk, np.int64)
    lo = (np.maximum(0, qpos - window + 1) if window is not None
          else np.zeros(lq, np.int64))
    return int(np.maximum(0, hi - lo).sum())


# ---------------------------------------------------------------------------
# Traffic: src/repro_torch/data/pipeline.py::_philox_tokens and
# src/repro_torch/launch/serve.py::make_requests @ d261ad5.


def philox_tokens(seed: int, step: int, global_batch: int, seq_len: int,
                  vocab: int) -> np.ndarray:
    """``(global_batch, seq_len + 1)`` int32 tokens of one training step, a
    pure function of (seed, step), numpy's Philox as the program draws
    them."""
    rng = np.random.Generator(np.random.Philox(key=seed,
                                               counter=[0, 0, step, 0]))
    return rng.integers(1, vocab, size=(global_batch, seq_len + 1),
                        dtype=np.int32)


def prompt_tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """A prompt of ``n`` ids drawn as the serve launcher draws them: ids in
    [3, vocab), which leaves the special ids 0-2 out."""
    return rng.integers(3, vocab, size=n, dtype=np.int32)

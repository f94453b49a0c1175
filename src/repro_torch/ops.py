"""``repro_torch.ops`` — the public API for the paper's ops on PyTorch.

Counterpart of ``repro.ops``. Every op takes ``policy=``: None (the Hopper
kernel, ``tile``), a bare path label (``"tile"``, ``"fused"``,
``"baseline"``, and for scan, weighted_scan and ssd ``"tile_logdepth"``),
or a comma list of ``op=path`` overrides; see
:mod:`repro_torch.core.policy`. On a CPU tensor the ``tile`` path runs each
kernel's plain version::

    import repro_torch.ops as ops

    ops.reduce(x)                       # tcu_reduce.cu on a CUDA tensor
    ops.scan(x, exclusive=True)         # tcu_scan.cu, then a shift
    ops.ssd(x, dt, a, b, c, policy="fused")
    ops.attention(q, k, v, window=128)  # flash_attention.cu
    ops.scan(x, policy="tile_logdepth") # matmul_scan.cu + a log-depth tree
"""
from repro_torch.core.dispatch import (  # noqa: F401  (the public API)
    attention,
    reduce,
    rmsnorm,
    scan,
    ssd,
    weighted_scan,
)

__all__ = ["attention", "reduce", "rmsnorm", "scan", "ssd", "weighted_scan"]

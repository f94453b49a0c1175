"""Which implementation runs an op: a minimal kernel policy.

Path labels:

  ``tile``      the hand-written Hopper kernel (its plain version for a CPU
                tensor); the default
  ``fused``     the matmul forms of ``repro_torch.core`` in plain torch
  ``baseline``  torch's own op (``sum``, ``cumsum``) or the sequential oracle
  ``tile_logdepth``  the log-depth MatMulScan family, for the scan family
                only (scan, weighted_scan, ssd): carry-free local kernels
                and a tree of batched matmuls over the block totals; any
                other op raises under it, as in the reference

A policy is None (every op on the default), a bare label (every op on that
path), or a comma list that may end in per-op overrides, e.g.
``"fused,ssd=tile"`` or ``"reduce=baseline,scan=baseline"``; serving a model
on the log-depth SSD is ``"ssd=tile_logdepth"``. The reference's
full ``KernelPolicy`` (autotune, tuning specs) is not ported yet.
"""
from __future__ import annotations

import functools

PATHS = ("tile", "fused", "baseline", "tile_logdepth")
OPS = ("reduce", "scan", "weighted_scan", "rmsnorm", "attention", "ssd")
LOGDEPTH_OPS = ("scan", "weighted_scan", "ssd")
DEFAULT_PATH = "tile"


@functools.lru_cache(maxsize=64)
def parse(spec: str) -> dict[str, str]:
    """``"fused,ssd=tile"`` -> ``{"*": "fused", "ssd": "tile"}``."""
    out: dict[str, str] = {}
    for item in (s.strip() for s in spec.split(",")):
        if not item:
            continue
        op, _, path = item.rpartition("=")
        op = op.strip() or "*"
        path = path.strip()
        if path not in PATHS:
            raise ValueError(f"unknown path {path!r} in policy {spec!r}; "
                             f"paths are {PATHS}")
        if op != "*" and op not in OPS:
            raise ValueError(f"unknown op {op!r} in policy {spec!r}; "
                             f"ops are {OPS}")
        out[op] = path
    return out


def resolve(policy: str | None, op: str) -> str:
    """The path ``op`` runs on under ``policy``."""
    if policy is None:
        return DEFAULT_PATH
    table = parse(policy)
    path = table.get(op, table.get("*", DEFAULT_PATH))
    if path == "tile_logdepth" and op not in LOGDEPTH_OPS:
        raise RuntimeError(
            f"{op}: no log-depth MatMulScan kernel for this op under policy "
            f"{policy!r} (tile_logdepth covers the scan family: "
            f"{', '.join(LOGDEPTH_OPS)}); use tile, fused or baseline, e.g. "
            "'ssd=tile_logdepth'")
    return path

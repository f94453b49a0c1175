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

With an observability session active (``repro_torch.obs``) every
:func:`resolve` call emits a ``resolution`` event with the reference's
schema (``RESOLUTION_FIELDS``) and counts ``repro_resolutions_total``. No
table, tuning or shard context takes part in a choice here, so ``tuning``
is None, ``table_src`` is ``"none"`` and ``shard_n`` is ``n``.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.obs import runtime

PATHS = ("tile", "fused", "baseline", "tile_logdepth")
OPS = ("reduce", "scan", "weighted_scan", "ragged_reduce", "ragged_scan",
       "rmsnorm", "attention", "ssd")
LOGDEPTH_OPS = ("scan", "weighted_scan", "ssd")
DEFAULT_PATH = "tile"
MAX_BAND = 20                       # the reference autotune's largest band


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


def resolve(policy: str | None, op: str, *, n: int | None = None,
            dtype=None, level: str = "dispatch", device=None) -> str:
    """The path ``op`` runs on under ``policy``.

    ``n`` (the bucket-axis size), ``dtype`` and ``device`` describe the call
    for its ``resolution`` event; ``level`` is ``"dispatch"`` or
    ``"kernel"``, as in the reference."""
    if policy is None:
        path = DEFAULT_PATH
    else:
        table = parse(policy)
        path = table.get(op, table.get("*", DEFAULT_PATH))
        if path == "tile_logdepth" and op not in LOGDEPTH_OPS:
            raise RuntimeError(
                f"{op}: no log-depth MatMulScan kernel for this op under "
                f"policy {policy!r} (tile_logdepth covers the scan family: "
                f"{', '.join(LOGDEPTH_OPS)}); use tile, fused or baseline, "
                "e.g. 'ssd=tile_logdepth'")
    if runtime.ACTIVE is not None:   # observability off by default: the
        # disabled path costs one module-global load and this branch
        _emit_resolution(op, n, dtype, level, None, path, device)
    return path


def _emit_resolution(op, n, dtype, level, explicit, path, device) -> None:
    """One ``resolution`` event and ``repro_resolutions_total`` count (the
    reference's ``KernelPolicy._emit_resolution``). A model's calls under
    a CUDA graph run at its warm-up and capture only, so the event fires
    then and not per replay, as the reference's fires once per jit
    trace."""
    sess = runtime.ACTIVE
    if sess is None:   # raced a disable(); nothing to record into
        return
    shaped = op is not None and n is not None
    sess.emit(
        "resolution",
        op=op, n=n, shard_n=n, shard_divisor=1,
        dtype=dtype_tag(dtype) if shaped else None,
        backend=current_backend(device),
        band=band(n) if shaped else None,
        level=level, explicit=explicit, chosen_path=path,
        tuning=None, table_src="none")
    sess.counter(
        "repro_resolutions_total",
        "KernelPolicy.resolve() calls by op/path/level").inc(
        op=str(op), path=str(path), level=str(level))


# ---------------------------------------------------------------------------
# the reference autotune's call-shape tags (repro.core.autotune)


def current_backend(device=None) -> str:
    """``gpu`` for a CUDA device, ``cpu`` otherwise, the reference's
    backend names; without a device, the process's default device."""
    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def dtype_tag(dtype) -> str:
    """Canonical short tag for a dtype (``f32``, ``bf16``, ...)."""
    if dtype is None:
        return "f32"
    name = str(dtype).rpartition(".")[2]
    return {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
            "float64": "f64"}.get(name, name)


def band(n: int) -> int:
    """log2 segment-size band, clamped to [0, MAX_BAND]."""
    return max(0, min(int(math.log2(max(int(n), 1))), MAX_BAND))

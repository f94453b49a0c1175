"""GPipe-style pipeline parallelism over a ``stage`` mesh dim.

Counterpart of ``repro.parallel.pipeline``. Any homogeneous block stack
can be wrapped in :func:`pipeline_apply`:

* the layers are split into S contiguous stages; stage s holds layers
  [s*L/S, (s+1)*L/S), its parameters the s-th row of each leaf's leading
  stage dim;
* the batch is split into M microbatches; the GPipe schedule runs
  S + M - 1 ticks, each tick a step where every stage runs its block on one
  microbatch and hands the activation to the next stage down the ring
  (``core.distributed.ring_shift``, one ``batch_isend_irecv``: the
  counterpart of ``jax.lax.ppermute``, the collective the paper's grid
  level maps to on a ring);
* the bubble fraction is (S-1)/(S+M-1), reported by
  :func:`pipeline_stats`.

Every rank of the stage dim calls :func:`pipeline_apply` with the same
``x``; each returns the whole output, the last stage's outputs spread by a
masked all-reduce. Forward only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree as _tree
from repro_torch.core.distributed import all_reduce_sum, ring_shift
from repro_torch.parallel.sharding import is_dtensor


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int
    axis: str = "stage"


def pipeline_stats(cfg: PipelineConfig) -> dict:
    s, m = cfg.n_stages, cfg.n_microbatches
    return {"ticks": s + m - 1, "bubble_fraction": (s - 1) / (s + m - 1)}


def _stage_leaf(t: torch.Tensor, idx: int) -> torch.Tensor:
    """This stage's row of a leaf: of a ``DTensor`` sharded on its leading
    stage dim, the local row; of a plain tensor holding every stage, row
    ``idx``."""
    if is_dtensor(t):
        return t.to_local()[0]
    return t[idx]


def pipeline_apply(
    block_fn: Callable,      # (stage_params, x) -> y   one stage's layers
    stage_params,            # tree, leading dim = n_stages
    x: torch.Tensor,         # (B, ...) global batch, the same on every rank
    cfg: PipelineConfig,
    mesh,                    # DeviceMesh with a ``cfg.axis`` dim
) -> torch.Tensor:
    """Run the GPipe schedule. ``block_fn`` must be shape-preserving
    (residual-block semantics), as every layer stack here is."""
    s, m = cfg.n_stages, cfg.n_microbatches
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if sizes.get(cfg.axis) != s:
        raise ValueError(f"mesh dim {cfg.axis!r} must have {s} ranks, the "
                         f"stages; the mesh has {sizes}")
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    xq = x.reshape(m, b // m, *x.shape[1:])           # microbatch queue
    group = mesh.get_group(cfg.axis)
    idx = mesh.get_local_rank(cfg.axis)
    p_loc = _tree.map_tree(lambda t: _stage_leaf(t, idx), stage_params)
    buf = xq[0] if idx == 0 else torch.zeros_like(xq[0])
    outq = torch.zeros_like(xq)
    for tick in range(s + m - 1):
        y = block_fn(p_loc, buf)
        # the last stage finishes microbatch (tick - (S-1)) at this tick
        done = tick - (s - 1)
        if idx == s - 1 and done >= 0:
            outq[done] = y
        # hand activations down the ring: stage i -> i+1
        y_next = ring_shift(y, group)
        # stage 0 pulls the next microbatch from the queue
        nxt = tick + 1
        if idx == 0:
            buf = xq[nxt] if nxt < m else torch.zeros_like(xq[0])
        else:
            buf = y_next
    # only the last stage holds real outputs: spread them by a masked sum
    mask = 1.0 if idx == s - 1 else 0.0
    return all_reduce_sum(outq * mask, group).reshape(b, *x.shape[1:])

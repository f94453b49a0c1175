"""Sharded kernel dispatch -- a ``DTensor``'s shards stay on the tile
kernels.

Counterpart of ``repro.parallel.shard_ops``. The paper's grid level
(§4.3/§5.3) combines per-processor partials that the tile and block levels
produced. ``core.distributed`` expresses that combine as collectives; this
module is the outer half: given a ``DTensor`` whose bucket axis is sharded
over a mesh dim of the active
:class:`~repro_torch.parallel.mesh_context.MeshContext`'s mesh,

* each rank runs the policy-resolved kernel on its **local shard**
  (``core.dispatch`` under
  :func:`~repro_torch.parallel.mesh_context.shard_local_scope`, so the
  policy's shard-shape division is not applied again to the local shape):
  ``tcu_reduce.cu``, ``tcu_scan.cu``, ``weighted_scan.cu`` or
  ``ssd_scan.cu`` on a CUDA shard, and
* the cross-rank carry is the matmul-form combine of ``core.distributed``
  (an all-reduce for the reduce, the strictly lower-triangular ones matmul
  for the scan, the 1-semiseparable decay matmul for the weighted scan and
  the SSD),

and the result is a ``DTensor`` in the reference's out specs.

Routing is conservative: these return ``None`` (the caller falls back to
plain dispatch) unless there is an active context with a mesh, the input is
a ``DTensor`` on that mesh with ``Shard``/``Replicate`` placements, its
bucket axis is sharded, and the shard is even. ``repro_torch.ops`` consults
them; ``core.dispatch`` itself stays mesh-free.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import dispatch
from repro_torch.core.distributed import (
    all_reduce_sum,
    dist_exclusive_carry,
    process_group,
    weighted_exclusive_carry,
)
from repro_torch.obs import runtime as _obs
from repro_torch.parallel.mesh_context import (
    current_mesh_context,
    shard_local_scope,
)
from repro_torch.parallel.sharding import is_dtensor, placements, spec_of

__all__ = ["sharded_reduce", "sharded_scan", "sharded_weighted_scan",
           "sharded_ssd"]


def _nshards(ctx, axes) -> int:
    sizes = ctx.axis_sizes
    return math.prod(sizes.get(a, 1) for a in axes)


def _emit_route(op: str, x, dim: int, ctx, axes) -> None:
    """One ``sharded_dispatch`` event when a sharded route is taken (only
    called when an obs session is active): the record that a call left
    plain dispatch for the mesh path, and over which mesh dims."""
    sess = _obs.ACTIVE
    if sess is None:
        return
    sess.emit("sharded_dispatch", op=op, n=int(x.shape[dim]),
              dim=int(dim), mesh_axes=list(axes),
              nshards=int(_nshards(ctx, axes)))
    sess.counter(
        "repro_sharded_dispatch_total",
        "calls routed through shard_map by op").inc(op=op)


def _on_mesh(t, ctx):
    """``t``'s spec when it is a ``DTensor`` on ``ctx``'s mesh with
    ``Shard``/``Replicate`` placements, else None."""
    if not is_dtensor(t) or t.device_mesh != ctx.mesh:
        return None
    return spec_of(t)


def _routing_ctx(x, dim: int):
    """The (ctx, full-rank spec, bucket-axis names) triple when ``x``'s
    ``dim`` is evenly sharded under the active MeshContext, else None."""
    ctx = current_mesh_context()
    if ctx is None or ctx.mesh is None:
        return None
    spec = _on_mesh(x, ctx)
    if spec is None:
        return None
    axes = spec[dim]
    if axes is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    nshards = _nshards(ctx, axes)
    if nshards <= 1 or x.shape[dim] % nshards != 0:
        return None
    return ctx, spec, axes


def gather_bucket(t, dim: int):
    """Plain dispatch's input for a call that did not route: a ``DTensor``
    whose ``dim`` is sharded comes back with that dim replicated, anything
    else unchanged. Plain dispatch then sees the whole bucket axis, as the
    reference's does under GSPMD; DTensor's own rule for ``cumsum`` along a
    sharded dim scans each shard alone (torch 2.13), which would drop the
    carry."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    dim %= t.ndim
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim % t.ndim == dim
               else p for p in t.placements)
    if pl == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def _wrap(local: torch.Tensor, ctx, spec, shape):
    """A rank's result as a ``DTensor`` of global ``shape`` in ``spec``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, ctx.mesh, placements(spec, ctx.mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for s in reversed(tuple(shape)):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def sharded_reduce(x, *, policy=None):
    """Last-axis reduce of a sharded ``DTensor``: the kernel on each shard,
    then an all-reduce. None when the call falls back to plain dispatch."""
    route = _routing_ctx(x, x.ndim - 1)
    if route is None:
        return None
    ctx, spec, axes = route
    if _obs.ACTIVE is not None:
        _emit_route("reduce", x, x.ndim - 1, ctx, axes)
    with shard_local_scope():
        part = dispatch.reduce(x.to_local(), policy=policy)
    for a in axes:
        part = all_reduce_sum(part, process_group((ctx.mesh, a)))
    return _wrap(part, ctx, spec[:-1], x.shape[:-1])


def sharded_scan(x, *, policy=None, exclusive: bool = False):
    """Last-axis inclusive scan of a sharded ``DTensor``: the kernel on each
    shard, then the exclusive carry of the shard totals
    (scan-then-propagate). The exclusive variant needs a cross-shard element
    shift, so it falls back."""
    if exclusive:
        return None
    route = _routing_ctx(x, x.ndim - 1)
    if route is None:
        return None
    ctx, spec, axes = route
    if len(axes) != 1:
        return None       # bucket axis over several mesh dims: fall back
    if _obs.ACTIVE is not None:
        _emit_route("scan", x, x.ndim - 1, ctx, axes)
    with shard_local_scope():
        local = dispatch.scan(x.to_local(), policy=policy)
    carry = dist_exclusive_carry(local[..., -1], (ctx.mesh, axes[0]))
    return _wrap(local + carry[..., None], ctx, spec, x.shape)


def weighted_inject(local: torch.Tensor, log_a: torch.Tensor,
                    carry: torch.Tensor) -> torch.Tensor:
    """A shard's weighted scan with its incoming carry propagated through
    each position's prefix decay."""
    prefix = torch.cumsum(log_a.float(), dim=-1)
    return local + carry[..., None] * torch.exp(prefix)


def sharded_weighted_scan(x, log_a, *, policy=None):
    """Last-axis decayed scan of a sharded ``DTensor``: the kernel on each
    shard, then the 1-semiseparable carry combine, propagated through the
    prefix decays. ``log_a`` must be sharded as ``x`` is."""
    route = _routing_ctx(x, x.ndim - 1)
    if route is None:
        return None
    ctx, spec, axes = route
    if len(axes) != 1:
        return None
    if _on_mesh(log_a, ctx) != spec:
        return None
    if _obs.ACTIVE is not None:
        _emit_route("weighted_scan", x, x.ndim - 1, ctx, axes)
    xs, las = x.to_local(), log_a.to_local()
    with shard_local_scope():
        local = dispatch.weighted_scan(xs, las, policy=policy)
    log_decay = torch.sum(las.float(), dim=-1)
    carry = weighted_exclusive_carry(local[..., -1], log_decay,
                                     (ctx.mesh, axes[0]))
    return _wrap(weighted_inject(local, las, carry), ctx, spec, x.shape)


def ssd_inject(y: torch.Tensor, c: torch.Tensor, lam: torch.Tensor,
               h_in: torch.Tensor) -> torch.Tensor:
    """A shard's SSD output with the incoming state injected at every
    position: ``y_l += C_l . (prod_{k<=l} exp(lam_k)) h_in``, added in f32
    and rounded once to y's dtype. ``c (B, Ll, G, N)``, ``lam (B, Ll, H)``,
    ``h_in (B, H, P, N)``."""
    heads, groups = lam.shape[2], c.shape[2]
    cdec = (torch.repeat_interleave(c.float(), heads // groups, dim=2)
            * torch.exp(torch.cumsum(lam, dim=1))[..., None])   # (B,Ll,H,N)
    inj = torch.einsum("blhn,bhpn->blhp", cdec, h_in)
    return (y.float() + inj).to(y.dtype)


def sharded_ssd(x, dt, a, b, c, *, policy=None, chunk=None,
                matmul_dtype=None, return_state: bool = False):
    """Sequence-sharded SSD: the chunked scan on each shard, then the
    cross-rank state carry (the same recurrence one level up: shard finals
    are chunk finals).

    ``x (B, L, H, P)`` sharded on L (dim 1); ``dt (B, L, H)`` and
    ``b``/``c`` ``(B, L, G, N)`` ``DTensor``s sharded identically on B and
    L; ``a (H,)`` replicated (a plain tensor or a replicated ``DTensor``).
    The returned final state is replicated."""
    route = _routing_ctx(x, 1)
    if route is None:
        return None
    ctx, spec, axes = route
    if len(axes) != 1:
        return None
    for arr in (dt, b, c):
        s = _on_mesh(arr, ctx)
        if s is None or s[1] != spec[1] or s[0] != spec[0]:
            return None
    if is_dtensor(a):
        a_spec = _on_mesh(a, ctx)
        if a_spec is None or any(e is not None for e in a_spec):
            return None
        a = a.to_local()
    if _obs.ACTIVE is not None:
        _emit_route("ssd", x, 1, ctx, axes)
    group = process_group((ctx.mesh, axes[0]))
    xs, dts, bs, cs = x.to_local(), dt.to_local(), b.to_local(), c.to_local()
    with shard_local_scope():
        y, h_last = dispatch.ssd(
            xs, dts, a, bs, cs, policy=policy, chunk=chunk,
            matmul_dtype=matmul_dtype, return_state=True)
    # shard-level recurrence: H_i = exp(L_i) H_{i-1} + h_last_i
    lam = dts.float() * a.float()                               # (B, Ll, H)
    log_decay = torch.sum(lam, dim=1)                           # (B, H)
    h_in = weighted_exclusive_carry(h_last, log_decay, group)
    y = _wrap(ssd_inject(y, cs, lam, h_in), ctx, spec, x.shape)
    if not return_state:
        return y
    h_fin = torch.exp(log_decay)[..., None, None] * h_in + h_last
    last = torch.distributed.get_rank(group) == ctx.axis_sizes[axes[0]] - 1
    h_glob = all_reduce_sum(h_fin if last else torch.zeros_like(h_fin),
                            group)
    return y, _wrap(h_glob, ctx, (None,) * h_glob.ndim, h_glob.shape)

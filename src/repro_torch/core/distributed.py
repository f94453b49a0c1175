"""Device-level ("grid-level", paper §4.3/§5.3) reduction and scan.

Counterpart of ``repro.core.distributed``. The paper's grid level uses
several kernel launches with partials in global memory. Here the partials
of each rank come from the tile and block levels (``repro_torch.core``'s
matmul forms), and the cross-rank combine is a ``torch.distributed``
collective over a process group. The scan follows the paper's
*scan-then-propagate* strategy:

  kernel 1: per-rank segmented scan            -> local scan + local total
  kernel 2: scan of the per-rank totals        -> matmul form over the group
  kernel 3: uniform add of the exclusive carry -> one add

Kernel 2 is itself in matmul form: the gathered totals are hit with a
strictly lower-triangular ones matrix, the same L as the tile level with
the group's ranks in the role of the tile's rows. These products are a few
ranks wide, as the reference's are XLA products outside any Pallas kernel.

Where the reference takes a mesh axis name (inside ``shard_map``), these
take ``group``: a ``ProcessGroup``, a ``(DeviceMesh, dim name)`` pair, or
None for the default group. Every collective goes through
:func:`host_staged`, the one place a tensor leaves the card: a CUDA tensor
is staged through host memory when the group's backend is gloo (several
ranks sharing one card, where NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.reduce import tcu_reduce
from repro_torch.core.scan import tcu_scan, tcu_weighted_scan
from repro_torch.core.tiles import segsum


def process_group(group):
    """``group`` as a ``ProcessGroup``: a ``(DeviceMesh, dim)`` pair names
    the mesh dim's group, None the default group."""
    if group is None:
        return dist.group.WORLD
    if isinstance(group, tuple):
        mesh, name = group
        return mesh.get_group(name)
    return group


def _staging(t: torch.Tensor, shape=None) -> torch.Tensor:
    """An uninitialised host buffer for ``t``'s data (``shape``, else
    ``t``'s): page-locked for a CUDA tensor (torch's host allocator caches
    its blocks), so the copies to and from the card run at the link's
    rate."""
    return torch.empty(t.shape if shape is None else shape, dtype=t.dtype,
                       pin_memory=t.is_cuda)


def host_staged(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of ``group`` runs on: a host copy of a CUDA
    tensor when the group's backend is gloo (page-locked), else ``t``
    itself. The caller moves the result back to ``t.device``."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return _staging(t).copy_(t)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked in group-rank order: ``(ranks, *t.shape)``
    on ``t.device``."""
    g = process_group(group)
    src = host_staged(t.contiguous(), g)
    n = dist.get_world_size(g)
    out = (_staging(t, (n, *t.shape)) if src is not t
           else torch.empty((n, *t.shape), dtype=t.dtype, device=t.device))
    dist.all_gather(list(out.unbind(0)), src, group=g)
    return out.to(t.device)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, as a new tensor on ``t.device``."""
    g = process_group(group)
    buf = host_staged(t, g)
    buf = buf.clone() if buf is t else buf
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g)
    return buf.to(t.device)


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` split into the group's ranks' equal
    pieces along ``dim``: this rank's piece (group-rank order), on
    ``t.device``. ``t.shape[dim]`` must divide by the group's size."""
    g = process_group(group)
    size = dist.get_world_size(g)
    if t.shape[dim] % size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide over {size} ranks")
    moved = torch.movedim(t, dim, 0).contiguous()
    src = host_staged(moved, g)
    shape = (src.shape[0] // size, *src.shape[1:])
    out = (_staging(moved, shape) if src is not moved
           else torch.empty(shape, dtype=t.dtype, device=t.device))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=g)
    return torch.movedim(out, 0, dim).to(t.device)


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` ``(ranks, ...)``: piece i goes to rank i of ``group``, and the
    result's piece j is what rank j sent this rank (group-rank order), on
    ``t.device``: one ``all_to_all_single``."""
    g = process_group(group)
    if t.shape[0] != dist.get_world_size(g):
        raise ValueError(f"all_to_all: {t.shape[0]} pieces for a group of "
                         f"{dist.get_world_size(g)} ranks")
    t = t.contiguous()
    src = host_staged(t, g)
    out = _staging(t) if src is not t else torch.empty_like(t)
    dist.all_to_all_single(out, src, group=g)
    return out.to(t.device)


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to the next rank of ``group`` and receive the previous
    rank's (rank i -> i + 1 mod ranks), by one ``batch_isend_irecv``: the
    ring hand-off of ``jax.lax.ppermute``."""
    g = process_group(group)
    size, me = dist.get_world_size(g), dist.get_rank(g)
    src = host_staged(t.contiguous(), g)
    got = torch.empty_like(src)
    nxt = dist.get_global_rank(g, (me + 1) % size)
    prev = dist.get_global_rank(g, (me - 1) % size)
    ops = [dist.P2POp(dist.isend, src, nxt, g),
           dist.P2POp(dist.irecv, got, prev, g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got.to(t.device)


def dist_reduce(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """Grid-level full reduction: the local matmul-form partial, summed over
    the group."""
    return all_reduce_sum(tcu_reduce(x_local), group)


def dist_exclusive_carry(local_total: torch.Tensor,
                         group=None) -> torch.Tensor:
    """Exclusive scan of the per-rank totals over ``group``, matmul form.

    Gather the totals (one small leaf a rank), multiply with the strictly
    lower-triangular ones matrix and take this rank's row: the paper's
    grid-level "scan of partials", the product run redundantly on every
    rank (cheaper than a second collective round at these group sizes)."""
    g = process_group(group)
    gathered = all_gather(local_total, g)                    # (ranks, ...)
    ndev = gathered.shape[0]
    idx = torch.arange(ndev, device=gathered.device)
    l_mask = (idx[:, None] > idx[None, :]).to(gathered.dtype)
    carries = l_mask @ gathered.reshape(ndev, -1)            # (ranks, -1)
    return carries[dist.get_rank(g)].reshape(gathered.shape[1:])


def dist_scan(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """Grid-level inclusive scan: the last axis of the *global* tensor is
    split over ``group`` in rank order; returns this rank's carried shard."""
    local = tcu_scan(x_local)
    carry = dist_exclusive_carry(local[..., -1], group)
    return local + carry[..., None]


def weighted_exclusive_carry(total: torch.Tensor, log_decay: torch.Tensor,
                             group=None) -> torch.Tensor:
    """Weighted exclusive scan of the per-rank (total, log-decay) pairs.

    Solves the cross-rank recurrence ``H_i = exp(L_i) * H_{i-1} + T_i``
    over ``group`` and returns this rank's *incoming* carry ``H_{i-1}``
    (zeros on rank 0). ``total`` may carry trailing state dims beyond
    ``log_decay``'s shape, over which ``log_decay`` broadcasts (the SSD:
    ``(B, H, P, N)`` states decayed by a ``(B, H)`` scalar; the weighted
    scan has none).

    Matmul form: gather both, hit the totals with the decay matrix
    ``exp(segsum(L))`` -- the tile level's 1-semiseparable mask with the
    ranks as its rows -- and take this rank's row of the shifted result."""
    if tuple(total.shape[:log_decay.ndim]) != tuple(log_decay.shape):
        raise ValueError(
            f"log_decay shape {tuple(log_decay.shape)} must prefix total "
            f"shape {tuple(total.shape)}")
    g = process_group(group)
    gathered_t = all_gather(total, g)                        # (ranks, ...)
    gathered_d = all_gather(log_decay, g)
    ndev = gathered_t.shape[0]
    d = torch.movedim(gathered_d, 0, -1)                     # (*D, ranks)
    m = torch.exp(segsum(d))                                 # (*D, r, r)
    t = torch.movedim(
        gathered_t.reshape((ndev, *log_decay.shape, -1)), 0, -2)
    s = m @ t                                                # inclusive H_i
    excl = torch.cat([torch.zeros_like(s[..., :1, :]), s[..., :-1, :]],
                     dim=-2)
    return excl[..., dist.get_rank(g), :].reshape(total.shape)


def dist_weighted_scan(x_local: torch.Tensor, log_a_local: torch.Tensor,
                       group=None) -> torch.Tensor:
    """Grid-level decayed scan (sequence-parallel SSD carry propagation).

    Each rank scans its piece and its total decay; the cross-rank carry is
    the weighted exclusive scan of (totals, decays) over the group, then
    propagated through each position's prefix decay."""
    la = log_a_local.float()
    local = tcu_weighted_scan(x_local, log_a_local)
    carry = weighted_exclusive_carry(local[..., -1], la.sum(-1), group)
    return local + carry[..., None] * torch.exp(torch.cumsum(la, dim=-1))

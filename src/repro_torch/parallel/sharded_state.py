"""A tree of tensors on a ``DeviceMesh``: the sharded train state and the
full views its compute takes.

Counterpart of what GSPMD does for the reference's sharded train step from
its in/out shardings. Each leaf of the state is a ``DTensor`` whose
placements come from a spec (``train_state_pspecs``,
``parallel.sharding.placements``); a rank holds only its shard of it, as a
contiguous local tensor.

* :func:`place` / :func:`place_tree` cut a full tensor (the same on every
  rank) into the rank's shard, with no collective.
* :func:`gather_full` and :func:`scatter_grad` are the two halves of the
  compute's view of a parameter (the autograd function
  ``tensor_parallel.TensorParallel.view``): the forward casts the rank's
  shard to the compute dtype and all-gathers it, and the backward takes the
  gradient back onto the rank's shard: sliced where the ranks computed the
  same thing (every mesh dim but the batch's), reduce-scattered and
  averaged where they computed different rows (the batch's, ``data``).
  The reference's "bf16 cast copy all-gathered per layer, the gradient
  reduce-scattered" (``repro.training.train_lib``), done eagerly here.
* :func:`sharded_sums` completes per-leaf partial sums over the mesh dims
  a leaf is sharded on (the global norm); :func:`dim_mean` and
  :func:`total_mean` do means (Adafactor's factored moments and RMS).

Every collective goes through ``repro_torch.core.distributed`` (a CUDA
tensor through host memory on gloo). The kernels see plain local tensors
(``to_local()`` or a gathered view), never a ``DTensor``.
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict

import torch

from repro_torch import tree
from repro_torch.core.distributed import all_gather, all_reduce_sum, \
    reduce_scatter
from repro_torch.obs import profiling as _prof
from repro_torch.parallel.sharding import NamedSharding, is_dtensor, spec_of


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _topology(mesh) -> tuple[dict, dict]:
    """(axis -> this rank's coordinate, axis -> size) of ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    return (dict(zip(names, mesh.get_coordinate())),
            dict(zip(names, mesh.mesh.shape)))


def _narrow(t: torch.Tensor, dim: int, parts: int, idx: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, idx * n, n)


def local_index(shape, spec, mesh) -> tuple[slice, ...]:
    """This rank's slice of a tensor of ``shape`` under ``spec`` on
    ``mesh``: a dim split over several mesh dims takes them major first, as
    DTensor nests its ``Shard`` placements in mesh-dim order."""
    coord, sizes = _topology(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        idx, parts = 0, 1
        for a in _axes(entry):
            idx, parts = idx * sizes[a] + coord[a], parts * sizes[a]
        chunk = dim // parts
        out.append(slice(idx * chunk, (idx + 1) * chunk))
    return tuple(out)


def dtensor(local: torch.Tensor, sharding: NamedSharding, shape):
    """``local``, this rank's shard of a leaf of ``shape``, as a
    ``DTensor`` (no collective)."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=shape, stride=stride)


def place(full: torch.Tensor, sharding: NamedSharding):
    """A full tensor, the same on every rank -> this rank's shard of it as a
    ``DTensor`` (a contiguous copy: the full tensor can be freed)."""
    shard = full[local_index(full.shape, sharding.spec, sharding.mesh)]
    if shard.shape != full.shape:
        shard = shard.clone(memory_format=torch.contiguous_format)
    return dtensor(shard.contiguous(), sharding, full.shape)


def place_tree(state, shardings):
    """:func:`place` over ``state``'s tensor leaves, ``shardings`` a tree of
    :class:`~repro_torch.parallel.sharding.NamedSharding` on its structure;
    numpy leaves (the rng words) stay as they are, replicated."""
    return tree.map_tree(
        lambda t, s: place(t, s) if isinstance(t, torch.Tensor) else t,
        state, shardings)


def local(t):
    """A ``DTensor``'s local shard; anything else as it is."""
    return t.to_local() if is_dtensor(t) else t


def like(t: torch.Tensor, ref):
    """``t``, a local shard shaped as ``ref``'s, with ``ref``'s placements
    when ``ref`` is a ``DTensor``; else ``t`` itself."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def gather_full(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard ``t`` under ``spec`` -> the whole tensor, the same
    on every rank: one all-gather a sharded mesh dim, minor first."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            parts = all_gather(t, (mesh, a))
            t = torch.cat(parts.unbind(0), dim=d)
    return t


def full_tensor(t) -> torch.Tensor:
    """A ``DTensor``'s whole value as a plain tensor (gathered through
    ``core.distributed``); anything else as it is."""
    if not is_dtensor(t):
        return t
    return gather_full(t.to_local(), spec_of(t), t.device_mesh)


def scatter_grad(g: torch.Tensor, spec, mesh, batch_axes: tuple,
                 dtype=torch.float32, *, sum_axes: tuple = ()) -> torch.Tensor:
    """The whole leaf's gradient ``g`` of this rank's rows -> the gradient
    of the rank's shard of the mean over the batch's mesh dims.

    A mesh dim outside ``batch_axes`` and ``sum_axes`` holds ranks that
    computed the same rows, hence the same gradient: its split is a slice,
    taken first (no collective, and the f32 copy is made of the slice
    alone). A batch dim's ranks computed different rows, and a dim of
    ``sum_axes`` different parts of the leaf's use (tensor parallelism):
    a reduce-scatter where the spec shards over it, an all-reduce where it
    does not. Then the mean's division, over the batch dims only."""
    coord, sizes = _topology(mesh)
    batch_axes = tuple(a for a in batch_axes if sizes.get(a, 1) > 1)
    summed = batch_axes + tuple(a for a in sum_axes
                                if sizes.get(a, 1) > 1 and a not in batch_axes)
    rest = []
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        k = 0
        while k < len(axes) and axes[k] not in summed:
            g = _narrow(g, d, sizes[axes[k]], coord[axes[k]])
            k += 1
        rest.append((d, axes[k:]))
    g = g.to(dtype)
    done = set()
    for d, axes in rest:
        for a in axes:
            if a in summed:
                g = reduce_scatter(g, d, (mesh, a))
                done.add(a)
            else:
                g = _narrow(g, d, sizes[a], coord[a])
    for a in summed:
        if a not in done:
            g = all_reduce_sum(g, (mesh, a))
    n = math.prod(sizes[a] for a in batch_axes)
    return (g / n if n > 1 else g).contiguous()


class StepClock:
    """Seconds by part of a step, summed over its calls: each part waits
    for the device before it starts and before it ends (a CUDA device), so
    a part holds its own kernels only. Each part is also a span named
    ``<prefix>/<part>`` (``obs.profiling``), recorded while spans record."""

    def __init__(self, device: torch.device, prefix: str):
        self.device = device
        self.prefix = prefix
        self.seconds: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, part: str):
        _prof.wait_for(self.device)
        with _prof.span(f"{self.prefix}/{part}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _prof.wait_for(self.device)
                self.seconds[part] += time.perf_counter() - t0


def sharded_sums(leaves: list, values: list) -> list:
    """Each leaf's partial scalar ``values[i]`` (a sum over the leaf's local
    shard) summed over the mesh dims that leaf is sharded on, and only
    those: a leaf replicated over a dim is counted once. Leaves sharded
    alike share one all-reduce a mesh dim."""
    groups: dict = defaultdict(list)
    for i, leaf in enumerate(leaves):
        if not is_dtensor(leaf):
            continue
        axes = tuple(sorted({a for e in spec_of(leaf) for a in _axes(e)}))
        if axes:
            groups[(id(leaf.device_mesh), axes)].append(i)
    out = list(values)
    for (_, axes), idx in groups.items():
        mesh = leaves[idx[0]].device_mesh
        summed = torch.stack([out[i] for i in idx])
        for a in axes:
            summed = all_reduce_sum(summed, (mesh, a))
        for j, i in enumerate(idx):
            out[i] = summed[j]
    return out


def dim_mean(x: torch.Tensor, dim: int, ref, ref_dim: int | None = None,
             keepdim: bool = False) -> torch.Tensor:
    """The mean of ``x`` (a local shard) over ``dim``, which is ``ref``'s
    dim ``ref_dim`` (``dim`` when None): ``torch.mean`` when ``ref`` is not
    a ``DTensor``, else the local sum completed over the mesh dims that
    shard that dim of ``ref``, over the whole dim's size."""
    if not is_dtensor(ref):
        return torch.mean(x, dim=dim, keepdim=keepdim)
    rd = dim if ref_dim is None else ref_dim
    out = torch.sum(x, dim=dim, keepdim=keepdim)
    for a in _axes(spec_of(ref)[rd]):
        out = all_reduce_sum(out, (ref.device_mesh, a))
    return out / ref.shape[rd]


def total_mean(x: torch.Tensor, ref) -> torch.Tensor:
    """The mean of every element of ``x`` (``ref``'s local shard, or a
    tensor shaped as it): ``torch.mean`` when ``ref`` is not a ``DTensor``,
    else completed over every mesh dim ``ref`` is sharded on."""
    if not is_dtensor(ref):
        return torch.mean(x)
    return sharded_sums([ref], [torch.sum(x)])[0] / ref.numel()

"""Logical-axis sharding rules, on DTensor placements.

Counterpart of ``repro.parallel.sharding``. Every parameter and activation
dimension carries a *logical* name (``PSpec.logical``); a :class:`Rules`
table maps logical names to mesh dims. The same model code then runs
unsharded (no rules), TP + DP on a ``(data, model)`` mesh, or with a
``pod`` dim as well, by swapping rule tables only. Divisibility is checked
against the concrete dim sizes: a rule that does not divide the dimension
degrades to replication (how 4- or 8-kv-head archs live on a 16-way model
dim).

FSDP (ZeRO-3): with ``rules.fsdp`` set, parameters also shard their largest
not-yet-sharded dimension over the data dim.

A spec is the port's own: a tuple with one entry per tensor dim, each
``None``, a mesh dim name, or a tuple of names (a dim split over several
mesh dims, major first) -- the reference's ``PartitionSpec`` entry for
entry. :func:`placements` turns it into the DTensor ``Shard``/``Replicate``
placements of a ``DeviceMesh``, :func:`spec_of` back.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import sys
from typing import Mapping, Sequence

from repro_torch import tree as _tree


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical name -> mesh dim (or tuple of dims) mapping."""

    table: Mapping[str, str | tuple[str, ...] | None] = dataclasses.field(
        default_factory=dict)
    # shard params' largest free dim over this mesh dim (ZeRO-3); None = off
    fsdp: str | None = None
    # mesh dim sizes, for the divisibility checks
    axis_sizes: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def axes_for(self, name: str):
        return self.table.get(name)

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            return self.axis_sizes.get(axes, 1)
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)


# ---------------------------------------------------------------------------
# the active rules: scoped, and a new thread starts with none

_RULES: contextvars.ContextVar["Rules | None"] = contextvars.ContextVar(
    "repro_torch_rules", default=None)


def set_rules(rules: Rules | None) -> None:
    _RULES.set(rules)


def current_rules() -> Rules | None:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: Rules | None):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


# ---------------------------------------------------------------------------


def spec_for(shape: Sequence[int], logical: Sequence[str | None], *,
             rules: Rules | None = None, fsdp_ok: bool = False) -> tuple:
    """The spec of ``shape`` from its logical dim names.

    Rules that do not divide the concrete dim are dropped (replicated), and
    no mesh dim is used twice. With ``fsdp_ok`` and ``rules.fsdp``, the
    largest still-unsharded dim that the fsdp dim divides is sharded over
    it as well."""
    rules = rules if rules is not None else current_rules()
    if rules is None:
        return (None,) * len(shape)
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical names "
                         f"{tuple(logical)} differ in length")
    out: list = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        axes = rules.axes_for(name) if name else None
        if axes is None:
            out.append(None)
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if a not in used)
        size = rules.axis_size(axes)
        if size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    if fsdp_ok and rules.fsdp and rules.fsdp not in used:
        fs = rules.axis_sizes.get(rules.fsdp, 1)
        if fs > 1:
            cands = [(dim, i) for i, (dim, s) in enumerate(zip(shape, out))
                     if s is None and dim % fs == 0]
            if cands:
                out[max(cands)[1]] = rules.fsdp
    return tuple(out)


def placements(spec: Sequence, mesh) -> tuple:
    """A spec -> the DTensor placements of ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d`` names the mesh dim, else
    ``Replicate()``. A tensor dim split over several mesh dims is
    ``Shard(d)`` on each, which DTensor nests in mesh-dim order: the spec
    must name them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {axes} of dim {d} is not in the "
                             f"mesh's dim order {names}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the counterpart of
    ``jax.sharding.NamedSharding`` (a leaf of a shardings tree, e.g. the
    ``shardings=`` of ``checkpoint.ckpt.restore``). ``placements`` are the
    spec's DTensor placements on ``mesh``."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def spec_of(dtensor) -> tuple | None:
    """The spec of a ``DTensor``'s placements, one entry per tensor dim
    (None when a placement is neither ``Shard`` nor ``Replicate``: a
    pending reduction has no spec)."""
    from torch.distributed.tensor import Replicate, Shard

    names = dtensor.device_mesh.mesh_dim_names
    per_dim: list[list[str]] = [[] for _ in range(dtensor.ndim)]
    for name, p in zip(names, dtensor.placements):
        if isinstance(p, Shard):
            per_dim[p.dim % dtensor.ndim].append(name)
        elif not isinstance(p, Replicate):
            return None
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per_dim)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``, without importing
    ``torch.distributed.tensor`` (about a second): no DTensor exists before
    that module is loaded."""
    api = sys.modules.get("torch.distributed.tensor")
    return api is not None and isinstance(t, api.DTensor)


def logical_constraint(x, *logical: str | None):
    """Redistribute a ``DTensor`` to the spec of its logical names under the
    active rules; anything else (no rules, a plain tensor) is returned
    unchanged, as the reference's is without a mesh."""
    rules = current_rules()
    if rules is None or not is_dtensor(x):
        return x
    spec = spec_for(x.shape, logical, rules=rules)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def param_sharding_tree(shapes_tree, logical_tree, mesh, rules: Rules):
    """(tree of leaves with a ``shape``, tree of logical-name tuples) -> the
    tree of each leaf's placements on ``mesh`` (FSDP allowed)."""
    return _tree.map_tree(
        lambda leaf, logical: placements(
            spec_for(leaf.shape, logical, rules=rules, fsdp_ok=True), mesh),
        shapes_tree, logical_tree)


def count_params(tree) -> int:
    return sum(math.prod(leaf.shape) for leaf in _tree.leaves(tree))

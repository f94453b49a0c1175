"""repro_torch.parallel -- the mesh, the sharding rules and the sharded ops.

Counterpart of ``repro.parallel``: :class:`MeshContext` over a
``torch.distributed`` ``DeviceMesh`` (``mesh_context``), the logical-axis
rules and their DTensor placements (``sharding``), the sharded reduce, scan,
weighted scan and SSD that ``repro_torch.ops`` routes ``DTensor``s to
(``shard_ops``), the GPipe schedule (``pipeline``), the sharded train
state (``sharded_state``), and the views its step computes on, gathered
whole or split over ``model``, and the serving steps' split of parameters,
batch rows and KV-cache rows (``tensor_parallel``).
The reference's ``compat`` shims jax versions and has no counterpart here.
"""
from repro_torch.parallel.mesh_context import (
    MeshContext,
    activate,
    current_mesh_context,
    make_context,
    parse_mesh_arg,
    shard_local_scope,
)
from repro_torch.parallel.sharding import (
    Rules,
    current_rules,
    logical_constraint,
    set_rules,
    spec_for,
    use_rules,
)

__all__ = [
    "MeshContext",
    "Rules",
    "activate",
    "current_mesh_context",
    "current_rules",
    "logical_constraint",
    "make_context",
    "parse_mesh_arg",
    "set_rules",
    "shard_local_scope",
    "spec_for",
    "use_rules",
]

"""Production meshes, the logical-axis rule tables for each, and the card's
constants the roofline reads.

Counterpart of ``repro.launch.mesh``. ``make_production_mesh`` is a
function, not a module constant, so importing this module touches no
process group: the dry run starts its world (:func:`fake_world`) first and
only then calls in here.

Mesh dims:
  single : (data=16, model=16)          = 256 ranks
  multi  : (pod=2, data=16, model=16)   = 512 ranks; ``pod`` is an outer
           data-parallel dim whose gradient all-reduce crosses the slow
           link between pods (see optim/compress.py).

The rule tables map the model code's logical dim names onto mesh dims.
Divisibility (kv_heads=4 on a 16-way dim -> replicate) is handled inside
``spec_for``; the table just states intent.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist

from repro_torch.parallel.mesh_context import MeshContext
from repro_torch.parallel.sharding import Rules

# The card's constants, one NVIDIA H100 SXM5 80GB at 700 W (NVIDIA's H100
# Tensor Core GPU datasheet, SXM5 column; the tensor-core rates are the
# dense ones, without sparsity).
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 and f16 tensor cores
PEAK_OPS = {"float16": 989e12, "bfloat16": 989e12,
            "float32": 67e12}     # f32 on the CUDA cores
HBM_BW = 3.35e12                  # bytes/s of HBM3
HBM_BYTES = 80 * 10 ** 9          # device memory
SMEM_BYTES = 227 * 2 ** 10        # shared memory a block can take
# A 16-wide mesh dim leaves the 8-GPU NVLink domain of one node, so the
# collective term runs at the per-GPU InfiniBand NDR rate (400 Gb/s);
# inside a node NVLink 4 gives 450 GB/s a direction.
LINK_BW = 50e9                    # bytes/s a GPU, between nodes
NVLINK_BW = 450e9                 # bytes/s a direction, inside a node


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as ``rank`` of a ``world_size``-rank world whose
    collectives return at once and move nothing (torch's ``fake`` process
    group): a production mesh on one host, for the dry run. The group is
    destroyed on exit."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs no process group initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(mesh shape, dim names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: str = "cpu"):
    """The production ``DeviceMesh`` over the initialised process group
    (256 or 512 ranks, e.g. :func:`fake_world`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_shape(multi_pod=multi_pod)
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_context(*, multi_pod: bool = False, fsdp: bool = True,
                            seq_shard: bool = False, op_shard_axes=(),
                            device: str = "cpu") -> MeshContext:
    """The production mesh + rules as one activatable MeshContext."""
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    return MeshContext(mesh=mesh,
                       rules=make_rules(mesh, fsdp=fsdp,
                                        seq_shard=seq_shard),
                       op_shard_axes=op_shard_axes)


def make_rules(mesh, *, fsdp: bool = True, seq_shard: bool = False) -> Rules:
    """Logical-name -> mesh-dim table for a production mesh (the
    reference's, entry for entry), the dim names and sizes read off
    ``mesh``.

    ``seq_shard`` additionally shards long sequence/cache dims over ``data``
    (sequence parallelism: the long_500k decode cells, where batch=1 leaves
    the data dim otherwise idle).
    """
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    multi_pod = "pod" in sizes
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    table = {
        # activations
        "batch": batch_axes,
        "vocab": "model",
        # attention params
        "heads": "model",
        "kv_heads": "model",
        # mlp / moe params
        "ff": "model",
        "e_ff": "model",
        "experts": "model",
        # MoE dispatch groups ride the batch dims; the flat (expert x
        # capacity) slot dim rides the model dim, exp_cap catches the
        # residual data-dim sharding
        "moe_groups": batch_axes,
        "exp_slots": "model",
        "exp_cap": "data",
        # mamba params
        "inner": "model",
        "inner_all": "model",
        "ssm_heads": "model",
        # never shard the residual width or the layer stack by name
        "embed": None,
        "layers": None,
        # serving cells shard the KV-cache sequence dim; spec_for drops a
        # mesh dim already taken by the tensor's batch dim
        "kv_seq": ("data", "model") if seq_shard else None,
    }
    return Rules(table=table, fsdp="data" if fsdp else None,
                 axis_sizes=sizes)


def make_smoke_mesh(n: int = 1, device: str = "cuda"):
    """A one-dim ``("data",)`` mesh over the first ``n`` ranks of the
    initialised process group (tests and examples)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device, list(range(n)), mesh_dim_names=("data",))

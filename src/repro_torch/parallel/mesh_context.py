"""MeshContext -- a ``DeviceMesh``, the rules and the process topology as
one object.

Counterpart of ``repro.parallel.mesh_context``. Three layers consult the
same topology, so they travel together:

* **kernel resolution** -- under an active MeshContext,
  :meth:`~repro_torch.core.policy.KernelPolicy.resolve` divides the call's
  bucket axis by the context's shard divisor for that op
  (:meth:`MeshContext.effective_n`): a device's shard is just another
  small-n band, the regime where the paper's matmul-form reduction and
  scan win. ``op_shard_axes`` declares which mesh dim shards each op's
  bucket axis.
* **sharded dispatch** -- ``repro_torch.parallel.shard_ops`` runs the
  kernel dispatch on each rank's local shard of a ``DTensor`` on the
  context's mesh, with the collective carry combine of
  ``repro_torch.core.distributed``.
* **step builders and serving** activate it, so that logical sharding
  constraints and shard-shape resolution both see it.

Activation is scoped (``with ctx:``): it installs the rule table
(``sharding.use_rules``) and publishes the context through a contextvar
(:func:`current_mesh_context`). Inside a sharded op's body shapes are
already per-shard; :func:`shard_local_scope` suppresses the divisor there,
so a shard's n is never divided twice. The contextvars do not reach
threads the context did not start.

``mesh=None`` is a *topology-only* context (axis sizes from
``rules.axis_sizes``): policy resolution and unit tests work without a
process group; the sharded ops fall back to plain dispatch under it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Mapping, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import NamedSharding, Rules, \
    placements, spec_for, use_rules

_ACTIVE: contextvars.ContextVar["MeshContext | None"] = \
    contextvars.ContextVar("repro_torch_mesh_context", default=None)
_LOCAL: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("repro_torch_mesh_context_local", default=False)


def current_mesh_context() -> "MeshContext | None":
    """The innermost active context (None outside any ``with ctx:``)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def shard_local_scope():
    """Mark the dynamic extent as *already per-shard* (a sharded op's
    body): :func:`effective_call_n` stops dividing, so a shard's n is never
    divided twice."""
    token = _LOCAL.set(True)
    try:
        yield
    finally:
        _LOCAL.reset(token)


def effective_call_n(op: str, n: int) -> int:
    """The bucket-axis size kernel resolution keys off for one call: the
    per-shard size under an active (non-local) MeshContext, else ``n``.
    :meth:`KernelPolicy.resolve` calls it."""
    ctx = _ACTIVE.get()
    if ctx is None or _LOCAL.get():
        return n
    return ctx.effective_n(op, n)


def parse_mesh_arg(spec: str) -> tuple[tuple[str, int], ...]:
    """Parse a ``--mesh``-style string: ``"data=2,model=2"`` ->
    ``(("data", 2), ("model", 2))`` (order kept: the mesh's dim order)."""
    axes = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, size = part.partition("=")
        if not sep or not name.strip():
            raise ValueError(
                f"mesh spec must be 'axis=size,...', got {spec!r}")
        axes.append((name.strip(), int(size)))
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    for name, size in axes:
        if size < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1, got {size}")
    return tuple(axes)


# The union logical-name table the launch paths share, the reference's.
DEFAULT_RULE_TABLE = {
    "batch": ("data",), "heads": "model", "kv_heads": "model",
    "ff": "model", "e_ff": "model", "experts": "model",
    "vocab": "model", "inner": "model", "inner_all": "model",
    "ssm_heads": "model", "embed": None, "layers": None,
    "moe_groups": ("data",), "exp_slots": "model",
    "exp_cap": None, "kv_seq": None,
}


@dataclasses.dataclass(frozen=True, eq=False)
class MeshContext:
    """A ``DeviceMesh``, the rules and the process topology, activated with
    ``with ctx:``.

    ``mesh``
        The ``torch.distributed.device_mesh.DeviceMesh`` (None: a
        topology-only context; resolution works off ``rules.axis_sizes``).
    ``rules``
        The logical-name sharding table (``parallel.sharding``).
    ``op_shard_axes``
        Which mesh dim shards each op's *bucket* axis (the last axis of the
        reduce/scan family, the sequence axis of attention and the SSD): a
        mapping or tuple of ``(op, dim)`` pairs, validated against the
        policy's ``KNOWN_OPS`` and the mesh's dim names. Drives
        :meth:`effective_n`, hence shard-shape resolution.

    Identity-hashed (``eq=False``) so that it can key caches; :meth:`key`
    is a value-based key.
    """

    mesh: object = None
    rules: Rules = dataclasses.field(default_factory=Rules)
    op_shard_axes: tuple = ()

    def __post_init__(self):
        # deferred: the policy imports this module for its shard hook
        from repro_torch.core.policy import KNOWN_OPS, OP_ALIASES

        pairs = self.op_shard_axes
        if isinstance(pairs, Mapping):
            pairs = pairs.items()
        norm = tuple(sorted(
            (OP_ALIASES.get(str(op), str(op)), str(ax)) for op, ax in pairs))
        for op, ax in norm:
            if op not in KNOWN_OPS:
                raise ValueError(
                    f"op_shard_axes: unknown op {op!r}; expected one of "
                    f"{KNOWN_OPS} (or a kernel-registry alias "
                    f"{tuple(OP_ALIASES)})")
            if ax not in self.axis_sizes:
                raise ValueError(
                    f"op_shard_axes[{op!r}]: unknown mesh axis {ax!r}; "
                    f"have {tuple(self.axis_sizes)}")
        object.__setattr__(self, "op_shard_axes", norm)

    # -- topology -----------------------------------------------------------

    @property
    def axis_sizes(self) -> dict[str, int]:
        if self.mesh is not None:
            return dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
        return dict(self.rules.axis_sizes)

    @property
    def process_index(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def process_count(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    def label(self) -> str:
        """Compact mesh-shape label (``"data=2,model=2"``; ``"none"`` for a
        mesh-less context)."""
        return ",".join(f"{a}={s}" for a, s in self.axis_sizes.items()) \
            or "none"

    def key(self) -> tuple:
        """Value-based cache key (Rules holds dicts, so the dataclass itself
        is identity-hashed)."""
        return (tuple(sorted(self.axis_sizes.items())),
                tuple(sorted((k, v if not isinstance(v, list) else tuple(v))
                             for k, v in self.rules.table.items())),
                self.rules.fsdp, self.op_shard_axes)

    # -- shard-shape resolution ---------------------------------------------

    def shard_axis(self, op: str) -> str | None:
        from repro_torch.core.policy import OP_ALIASES

        op = OP_ALIASES.get(op, op)
        for name, ax in self.op_shard_axes:
            if name == op:
                return ax
        return None

    def shard_divisor(self, op: str, n: int) -> int:
        """The factor the op's bucket axis is sharded by: the registered
        axis size when it divides ``n``, else 1 (the same degradation as
        ``spec_for``: a rule that does not divide replicates)."""
        ax = self.shard_axis(op)
        if ax is None:
            return 1
        size = self.axis_sizes.get(ax, 1)
        return size if size > 1 and n % size == 0 else 1

    def effective_n(self, op: str, n: int) -> int:
        return n // self.shard_divisor(op, n)

    # -- sharding helpers ---------------------------------------------------

    def spec_for(self, shape: Sequence[int],
                 logical: Sequence[str | None], *,
                 fsdp_ok: bool = False) -> tuple:
        return spec_for(shape, logical, rules=self.rules, fsdp_ok=fsdp_ok)

    def placements(self, spec: Sequence) -> tuple:
        """A spec's DTensor placements on this context's mesh (the
        reference's ``named_sharding``)."""
        if self.mesh is None:
            raise ValueError("placements need a real mesh "
                             "(this context is topology-only)")
        return placements(spec, self.mesh)

    def named_sharding(self, spec: Sequence) -> NamedSharding:
        """A spec on this context's mesh, the reference's
        ``named_sharding``."""
        if self.mesh is None:
            raise ValueError("named_sharding needs a real mesh "
                             "(this context is topology-only)")
        return NamedSharding(self.mesh, tuple(spec))

    # -- activation ---------------------------------------------------------

    def __enter__(self) -> "MeshContext":
        stack = contextlib.ExitStack()
        stack.enter_context(use_rules(self.rules))
        token = _ACTIVE.set(self)
        stack.callback(_ACTIVE.reset, token)
        object.__setattr__(self, "_stack", stack)
        return self

    def __exit__(self, *exc) -> None:
        stack = getattr(self, "_stack", None)
        object.__setattr__(self, "_stack", None)
        if stack is not None:
            stack.close()


def init_from_env(device):
    """Join the process group that ``torchrun`` / ``python -m
    torch.distributed.run`` describes in the environment (``WORLD_SIZE`` >
    1): gloo, on the CPU and on the card alike (a CUDA tensor's collectives
    go through host memory, ``core.distributed.host_staged``). Returns this
    rank's device: ``device``, or for a bare ``cuda`` in a world of several
    processes ``cuda:<LOCAL_RANK mod cards>``. Without that environment:
    ``device`` as it is, and no process group."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        dist.init_process_group("gloo")
    if device.type == "cuda" and device.index is None and world > 1:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


@contextlib.contextmanager
def activate(ctx: "MeshContext | None"):
    """``with activate(ctx):`` -- ``with ctx:``, or nothing for None (step
    builders thread an optional context through)."""
    if ctx is None:
        yield None
    else:
        with ctx:
            yield ctx


def make_context(
    mesh_spec: "str | Sequence[tuple[str, int]]",
    *,
    device: str = "cuda",
    table: Mapping | None = None,
    fsdp: bool | None = None,
    op_shard_axes: "Mapping | tuple" = (),
) -> MeshContext:
    """A MeshContext from a mesh spec (``"data=2,model=2"`` or parsed pairs)
    over the initialised process group's ranks, on ``device`` (``"cuda"``;
    the tests pass ``"cpu"``).

    The axis sizes must multiply to the world size. ``table`` defaults to
    :data:`DEFAULT_RULE_TABLE`; ``fsdp`` defaults to sharding over ``data``
    when that axis is > 1."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = parse_mesh_arg(mesh_spec) if isinstance(mesh_spec, str) \
        else tuple(mesh_spec)
    names = tuple(a for a, _ in axes)
    shape = tuple(s for _, s in axes)
    total = 1
    for s in shape:
        total *= s
    if not dist.is_initialized():
        raise RuntimeError(
            "make_context needs an initialised process group "
            "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if total != world:
        raise ValueError(
            f"mesh {dict(axes)} needs {total} devices; this process group "
            f"has {world}")
    mesh = init_device_mesh(device, shape, mesh_dim_names=names)
    sizes = dict(axes)
    if fsdp is None:
        fsdp = sizes.get("data", 1) > 1
    rules = Rules(table=dict(table if table is not None
                             else DEFAULT_RULE_TABLE),
                  fsdp="data" if fsdp and sizes.get("data", 1) > 1 else None,
                  axis_sizes=sizes)
    return MeshContext(mesh=mesh, rules=rules, op_shard_axes=op_shard_axes)

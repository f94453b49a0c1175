"""Tensor parallelism over the mesh's ``model`` dim: what GSPMD derives for
the reference's train step from its ``logical_constraint`` annotations.

The reference annotates q on ``heads``, k and v on ``kv_heads``, the MLP
hidden on ``ff``, the SSM input on ``ssm_heads``, the logits on ``vocab``
and the residual on ``embed`` (replicated); under the rules of
``repro.launch.mesh`` its step on a ``(data, model)`` mesh computes only a
rank's share of each split dim. Here that is spelled out, Megatron-style:

* a region of split compute opens with :meth:`TensorParallel.copy_in`
  (identity forward, all-reduce of the partial input gradients backward)
  and closes with :meth:`TensorParallel.reduce_out` (all-reduce forward:
  the row-parallel product's partial sums; identity backward, every rank
  holding the whole gradient of the replicated result);
* :func:`vocab_parallel_embed` (a masked lookup, then an all-reduce) and
  :func:`vocab_parallel_cross_entropy` (log-sum-exp and gold logit
  completed across ranks, in f32) split the vocab;
* :func:`split_rmsnorm` normalises over a dim split across ranks: Σx² is a
  row-segmented reduce (``core.dispatch.reduce``, ``tcu_reduce.cu`` on the
  card) summed over ``model`` both ways (:meth:`TensorParallel.sum_split`:
  each rank's outputs reach the sum's gradient only through its own
  columns).

The MoE's experts (or every expert's ``e_ff`` columns) are split like an
MLP's ``ff`` columns, its partial combines summed by :meth:`TensorParallel.
reduce_out`; every ``model`` rank routes alike, so its aux loss takes its
gradient once (:meth:`TensorParallel.once`). Its routing groups span the
whole batch: :func:`batch_layout` says how the step's rows lie across
ranks, on a split step, a serving step or the gather-whole step
(:func:`rows_active`), and :meth:`TensorParallel.gather_rows` gathers them
where the groups do not divide over the ranks.

A layer takes each parameter as a :class:`Shard` (the rank's local piece and
its spec) and asks for the part its compute uses as a :class:`Take` (ranges
of one dim). :meth:`TensorParallel.view` gathers the piece over the mesh's
other dims (FSDP, ``data``) in the compute dtype. Where the stored ``model``
shard is exactly the rank's take, it stays on the rank; elsewhere (a packed
projection such as Mamba's ``in_proj``, or a leaf replicated over ``model``
inside the region, such as KV heads that do not divide) the leaf is gathered
whole, the take cut from it, and its gradient summed over ``model``. The
backward takes the gradient back onto the rank's shard, averaged over the
batch's mesh dims (``sharded_state.scatter_grad``).

Serving (:func:`for_serving`, ``inference=True``) takes the same split
without autograd: :meth:`TensorParallel.take` cuts each parameter once, at
engine or step construction, into the part the rank's compute uses (held
resident: 1/``model`` of every split leaf); ``copy_in`` is the identity and
``reduce_out`` and ``sum_split`` a plain all-reduce. A serving context also
knows the rows of the step's batch a rank holds (``batch_axes``, the
batch rule's mesh dims: :meth:`TensorParallel.row_start`,
:meth:`TensorParallel.gather_rows`) and the rows of the KV cache's
sequence it holds (``seq_axes``, the ``kv_seq`` rule's mesh dims, and
``kv_rows``, the cache's global rows): a decode step attends the local
rows and merges the ranks' partial outputs by log-sum-exp
(:meth:`TensorParallel.merge_attention`), never gathering the cache.

Every collective goes through ``repro_torch.core.distributed`` (a CUDA
tensor through host memory on gloo) and works on the dry run's ``fake``
process group: nothing here branches on a collective's values. A step
activates one :class:`TensorParallel` (:func:`active`); the model code asks
:func:`current`, and runs as before when it is None.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch
from repro_torch.core.distributed import all_gather, all_reduce_sum, \
    all_to_all
from repro_torch.parallel.sharded_state import _axes, gather_full, \
    scatter_grad
from repro_torch.parallel.sharding import spec_for

# the mesh dim tensor parallelism splits the compute over
MODEL_AXIS = "model"

_ACTIVE: contextvars.ContextVar["TensorParallel | None"] = \
    contextvars.ContextVar("repro_torch_tensor_parallel", default=None)
# the gather-whole step's batch layout: its rows over the batch's mesh dims,
# no split compute
_ROWS: contextvars.ContextVar["TensorParallel | None"] = \
    contextvars.ContextVar("repro_torch_batch_rows", default=None)


def current() -> "TensorParallel | None":
    """The active tensor-parallel context (None outside a split step)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def active(tp: "TensorParallel | None"):
    token = _ACTIVE.set(tp)
    try:
        yield tp
    finally:
        _ACTIVE.reset(token)


def batch_layout() -> "TensorParallel | None":
    """How the step's batch rows lie across ranks: the active split step's
    or serving step's context, else the gather-whole step's
    (:func:`rows_active`), else None (every row here). The MoE lays its
    routing groups out over the whole batch by it."""
    tp = _ACTIVE.get()
    return tp if tp is not None else _ROWS.get()


@contextlib.contextmanager
def rows_active(tp: "TensorParallel | None"):
    """``tp`` as the batch layout of a step that splits no compute (the
    gather-whole step): :func:`current` stays None."""
    token = _ROWS.set(tp)
    try:
        yield tp
    finally:
        _ROWS.reset(token)


def model_size(mesh) -> int:
    """The size of ``mesh``'s ``model`` dim (1 when it has none)."""
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's local piece of a parameter (or of one layer of a stacked
    one) and its spec: what :meth:`TensorParallel.view` gathers."""

    local: torch.Tensor
    spec: tuple


@dataclasses.dataclass(frozen=True)
class Take:
    """The part of a leaf a rank's compute takes: the ``(start, stop)``
    ``ranges`` of dim ``dim``, concatenated in order."""

    dim: int
    ranges: tuple

    def select(self, t: torch.Tensor) -> torch.Tensor:
        """The take of the whole leaf ``t``, a copy of its own."""
        return torch.cat([t.narrow(self.dim, a, b - a)
                          for a, b in self.ranges], self.dim)

    def place(self, g: torch.Tensor, shape) -> torch.Tensor:
        """The take's gradient ``g`` in a zero tensor of the whole leaf's
        ``shape``."""
        out = g.new_zeros(shape)
        off = 0
        for a, b in self.ranges:
            out.narrow(self.dim, a, b - a).copy_(
                g.narrow(self.dim, off, b - a))
            off += b - a
        return out

    def shifted(self, k: int) -> "Take":
        """The same take of a leaf with ``k`` more leading dims (a stack)."""
        return Take(self.dim + k, self.ranges)


def merged(ranges) -> tuple:
    """``ranges`` with adjacent ones joined (a take of fewer pieces)."""
    out: list = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return tuple(out)


def _without(spec, axis: str) -> tuple:
    """``spec`` with mesh dim ``axis`` dropped from every entry."""
    out = []
    for entry in spec:
        rest = tuple(a for a in _axes(entry) if a != axis)
        out.append(None if not rest else rest[0] if len(rest) == 1 else rest)
    return tuple(out)


class _View(torch.autograd.Function):
    """The compute's view of a shard (forward) and the view's gradient back
    onto the shard (backward); see :meth:`TensorParallel.view`."""

    @staticmethod
    def forward(ctx, local, spec, take, tp):
        ctx.tp, ctx.spec, ctx.take, ctx.dtype = tp, spec, take, local.dtype
        ctx.aligned = tp.aligned(spec, take, local.shape)
        out, ctx.shape = tp._gather_take(local, spec, take)
        return out

    @staticmethod
    def backward(ctx, g):
        tp, spec, take = ctx.tp, ctx.spec, ctx.take
        with tp.part("reduce_scatter"):
            if ctx.aligned:
                out = scatter_grad(g, _without(spec, tp.axis), tp.mesh,
                                   tp.batch_axes, ctx.dtype)
            elif take is None:
                # every model rank computed the same: a slice, as unsplit
                out = scatter_grad(g, spec, tp.mesh, tp.batch_axes, ctx.dtype)
            else:
                out = scatter_grad(take.place(g, ctx.shape), spec, tp.mesh,
                                   tp.batch_axes, ctx.dtype,
                                   sum_axes=(tp.axis,))
        return out, None, None, None


class _CopyIn(torch.autograd.Function):
    """Identity forward; the partial gradients summed over ``model``."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceOut(torch.autograd.Function):
    """Partial sums summed over ``model`` (forward); identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of the batch (forward); each row's gradient summed
    over the ranks that used it, this rank's rows kept (backward)."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.tp, ctx.dim, ctx.rows = tp, dim, x.shape[dim]
        return tp._all_rows(x, dim)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        with tp.part("tp_all_reduce"):
            for a in tp.batch_axes:
                g = all_reduce_sum(g, (tp.mesh, a))
        return g.narrow(ctx.dim, tp.row_start(ctx.rows), ctx.rows), None, \
            None


class _SumSplit(torch.autograd.Function):
    """Partial sums summed over ``model`` both ways: the sum feeds each
    rank's split compute, whose gradients are partial too."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """One split step's topology: the ``DeviceMesh``, its ``model`` dim's
    size and this rank's index in it, the compute dtype the views are cast
    to, whether the embedding, head and logits are split over the vocab
    (``vocab_split``: decided once, by the step, from whether the vocab
    divides the ``model`` dim), the batch's mesh dims (the gradients' mean)
    and the step's clock."""

    mesh: object
    dtype: torch.dtype
    vocab_split: bool = False
    batch_axes: tuple = ()
    clock: object = None
    # a serving step (:func:`for_serving`): no autograd on the collectives;
    # the mesh dims the KV cache's rows are split over (major first) and
    # the cache's global rows (None: no KV cache)
    inference: bool = False
    seq_axes: tuple = ()
    kv_rows: int | None = None
    axis = MODEL_AXIS

    @property
    def size(self) -> int:
        return model_size(self.mesh)

    @property
    def index(self) -> int:
        return self.mesh.get_local_rank(self.axis)

    @property
    def group(self) -> tuple:
        return (self.mesh, self.axis)

    def part(self, name: str):
        """The step clock's part ``name`` (nothing without a clock)."""
        return contextlib.nullcontext() if self.clock is None \
            else self.clock(name)

    def span(self, n: int, what: str = "dim") -> tuple[int, int]:
        """This rank's even share ``[start, stop)`` of ``n``."""
        if n % self.size:
            raise ValueError(f"tensor parallelism over {self.axis}="
                             f"{self.size} splits the {what} ({n}) evenly; "
                             f"{n} does not divide")
        k = n // self.size
        return self.index * k, (self.index + 1) * k

    def aligned(self, spec, take, shape) -> bool:
        """Whether ``take`` is exactly the rank's stored ``model`` shard of a
        leaf whose local piece has ``shape`` under ``spec``."""
        if take is None or self.size == 1:
            return False
        entry = spec[take.dim] if take.dim < len(spec) else None
        if entry != self.axis:
            return False
        n = shape[take.dim]
        return take.ranges == ((self.index * n, (self.index + 1) * n),)

    # -- collectives ---------------------------------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        with self.part("tp_all_reduce"):
            return all_reduce_sum(x, self.group)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.inference else _CopyIn.apply(x, self)

    def once(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a value every ``model`` rank computes alike from inputs
        whose gradients are summed over ``model`` (a split step's
        :meth:`copy_in` and a take's), with its gradient divided by the
        ranks: so counted once in the sum."""
        if self.inference or self.size == 1:
            return x
        return x.detach() + (x - x.detach()) / self.size

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        if self.inference:
            return x if self.size == 1 else self.all_reduce(x)
        return _ReduceOut.apply(x, self)

    def sum_split(self, x: torch.Tensor) -> torch.Tensor:
        if self.inference:
            return x if self.size == 1 else self.all_reduce(x)
        return _SumSplit.apply(x, self)

    def all_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every ``model`` rank's ``x`` concatenated along ``dim`` in rank
        order (a serving step's gather of split heads or vocab columns)."""
        if self.size == 1:
            return x
        with self.part("tp_all_gather"):
            return torch.cat(all_gather(x, self.group).unbind(0), dim)

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` ``(model ranks, ...)``: piece i to ``model`` rank i; ->
        the pieces the ranks sent this one, in rank order (one
        all-to-all)."""
        with self.part("tp_all_to_all"):
            return all_to_all(x, self.group)

    # -- serving: rows of the batch and of the KV cache ----------------------

    def index_in(self, axes: tuple) -> tuple[int, int]:
        """(this rank's index, the ranks) of the group over mesh dims
        ``axes``, major first."""
        names = tuple(self.mesh.mesh_dim_names)
        coord = dict(zip(names, self.mesh.get_coordinate()))
        idx, parts = 0, 1
        for a in axes:
            n = self.mesh.size(names.index(a))
            idx, parts = idx * n + coord[a], parts * n
        return idx, parts

    def row_start(self, rows: int) -> int:
        """The first global row of this rank's ``rows`` rows of the step's
        batch (split over ``batch_axes``)."""
        return self.index_in(self.batch_axes)[0] * rows

    def row_parts(self) -> int:
        """The ranks the step's batch rows are split over."""
        return self.index_in(self.batch_axes)[1]

    def rows_split(self) -> bool:
        """Whether the step's batch rows are split across ranks."""
        return self.row_parts() > 1

    def gather_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's rows of the batch (dim ``dim`` of ``x``) in global
        order: gathered over ``batch_axes``; in a train step
        differentiable, each row's gradient summed over the ranks."""
        if not self.rows_split():
            return x
        if not self.inference:
            return _GatherRows.apply(x, dim, self)
        return self._all_rows(x, dim)

    def _all_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        with self.part("tp_all_gather"):
            spec = [None] * x.ndim
            spec[dim] = self.batch_axes
            return gather_full(x, tuple(spec), self.mesh)

    def seq_parts(self) -> int:
        """The ranks the KV cache's rows are split over."""
        return self.index_in(self.seq_axes)[1]

    def seq_start(self) -> int:
        """The first global row of this rank's range of the KV cache."""
        idx, parts = self.index_in(self.seq_axes)
        return idx * (self.kv_rows // parts)

    def merge_attention(self, o: torch.Tensor, m: torch.Tensor,
                        l: torch.Tensor) -> torch.Tensor:
        """The normalised attention output ``(B, T, H, D)`` in f32 from this
        rank's part over its range of the cache's rows (``o`` unnormalised,
        each row's max ``m`` and sum ``l``, f32; ``models.xla_attention.
        decode_attention_part``): the row maxima gathered over
        ``seq_axes``, the part rescaled to their max, its outputs and sums
        summed over ``seq_axes`` (log-sum-exp); a row no rank has a key
        for is zeros. With no ``seq_axes`` it is the part normalised."""
        top = m
        with self.part("tp_all_gather"):
            for a in self.seq_axes:
                top = all_gather(top, (self.mesh, a)).amax(0)
        scale = torch.exp(m - top)
        both = torch.cat([o * scale[..., None], (l * scale)[..., None]], -1)
        with self.part("tp_all_reduce"):
            for a in self.seq_axes:
                both = all_reduce_sum(both, (self.mesh, a))
        o, l = both[..., :-1], both[..., -1]
        return o / torch.where(l > 0, l, 1.0)[..., None]

    # -- parameters ----------------------------------------------------------

    def _gather_take(self, local: torch.Tensor, spec, take):
        """(the compute's view of a shard, the whole leaf's shape or None):
        the rank's ``model`` shard gathered over the other dims where it is
        ``take``, else the leaf gathered whole and ``take`` cut from it."""
        with self.part("gather"):
            t = local.to(self.dtype) if local.is_floating_point() else local
            if self.aligned(spec, take, local.shape):
                return gather_full(t, _without(spec, self.axis),
                                   self.mesh), None
            t = gather_full(t, spec, self.mesh)
            return (t if take is None else take.select(t)), t.shape

    def take(self, shard: Shard, take: Take | None = None) -> torch.Tensor:
        """:meth:`view` without autograd, for serving: the part ``take`` of
        ``shard`` (None: the whole leaf) in the compute dtype, which the
        rank keeps (a whole leaf already in that dtype is the caller's
        tensor)."""
        return self._gather_take(shard.local, shard.spec, take)[0]

    def takes(self, params, takes=None):
        """:meth:`take` over the :class:`Shard` leaves of ``params``, each
        with its entry of ``takes`` (as :meth:`views`)."""
        if isinstance(params, dict):
            takes = takes or {}
            return {k: self.takes(v, takes.get(k)) for k, v in params.items()}
        if isinstance(params, Shard):
            return self.take(params, takes)
        return params

    def view(self, shard: Shard, take: Take | None = None) -> torch.Tensor:
        """The compute's view of ``shard`` in the compute dtype: gathered
        over the mesh's other dims; then the rank's stored ``model`` shard
        where it is ``take``, else the whole leaf (``take`` None) or the take
        cut from it (differentiable with respect to ``shard.local``). With
        ``take`` None it is the gather-whole step's view too, which runs
        without an active context: the leaf's cast gathered whole, its
        gradient sliced over every mesh dim but the batch's (ranks that
        computed the same rows) and averaged over those."""
        return _View.apply(shard.local, shard.spec, take, self)

    def views(self, params, takes=None):
        """:meth:`view` over the :class:`Shard` leaves of ``params``, each
        with its entry of ``takes`` (a tree of :class:`Take` or None on
        ``params``' structure, missing entries None); other leaves as they
        are."""
        if isinstance(params, dict):
            takes = takes or {}
            return {k: self.views(v, takes.get(k)) for k, v in params.items()}
        if isinstance(params, Shard):
            return self.view(params, takes)
        return params

    def layers(self, stacked, takes, n: int) -> list:
        """A stacked tree of :class:`Shard` leaves ``(n, ...)`` -> ``n``
        per-layer trees: each leaf's layer as a :class:`Shard` that the
        layer gathers (:meth:`views`, or :meth:`takes` when serving); a leaf
        whose stack dim is itself sharded is gathered once, here, with its
        take on every layer, and its layers are the views."""
        view = self.take if self.inference else self.view

        def split(leaf, take):
            if leaf.spec and leaf.spec[0] is not None:
                return torch.unbind(view(
                    leaf, None if take is None else take.shifted(1)), 0)
            return [Shard(t, leaf.spec[1:])
                    for t in torch.unbind(leaf.local, 0)]

        per = _map_with(split, stacked, takes)
        return [_pick(per, i) for i in range(n)]


def splits(mesh_ctx) -> bool:
    """Whether ``mesh_ctx`` has a mesh with a dim of more than one rank: a
    step under it takes the split path."""
    return (mesh_ctx is not None and mesh_ctx.mesh is not None
            and max(mesh_ctx.axis_sizes.values()) > 1)


def batch_rows(mesh_ctx, batch: int, *, strict: bool = False,
               what: str = "rows") -> tuple:
    """The mesh dims the batch rule splits ``batch`` rows over:
    ``spec_for``'s, none where their ranks do not divide the rows (a
    dry-run cell's one row); ``strict`` raises ``ValueError`` there
    instead (the engine's slots)."""
    rules = mesh_ctx.rules
    axes = _axes(spec_for((batch,), ("batch",), rules=rules)[0])
    parts = rules.axis_size(rules.axes_for("batch"))
    if strict and not axes and parts > 1:
        raise ValueError(
            f"sharded serving steps each rank's rows of the {what}, split "
            f"over the batch's {parts} ranks of mesh {mesh_ctx.label()}; "
            f"{batch} {what} do not divide")
    return axes


def for_serving(mesh_ctx, dtype: torch.dtype, *, vocab: int,
                batch: int | None = None, kv=None,
                clock=None) -> TensorParallel:
    """The serving step's context on ``mesh_ctx``'s mesh: the vocab split
    where it divides the ``model`` dim (as the train step decides); the
    ``batch`` rows split as :func:`batch_rows` says (None: no rows, a
    context that only takes parameters); and, given ``kv`` (the KV cache's
    declaration: its global ``shape`` and ``logical`` names), the mesh dims
    its ``kv_seq`` rows are split over and their number. A ``kv_seq`` split
    that takes the ``model`` dim must take it last (minor), as the rules'
    ``("data", "model")`` does."""
    mesh, rules = mesh_ctx.mesh, mesh_ctx.rules
    m = model_size(mesh)
    rows = () if batch is None else batch_rows(mesh_ctx, batch)
    seq, kv_rows = (), None
    if kv is not None:
        dim = kv.logical.index("kv_seq")
        seq = _axes(spec_for(kv.shape, kv.logical, rules=rules)[dim])
        kv_rows = kv.shape[dim]
        if MODEL_AXIS in seq and seq[-1] != MODEL_AXIS:
            raise ValueError(f"a KV cache whose rows split over {seq} needs "
                             f"{MODEL_AXIS!r} as the minor mesh dim")
    return TensorParallel(mesh=mesh, dtype=dtype,
                          vocab_split=m > 1 and vocab % m == 0,
                          batch_axes=rows, clock=clock, inference=True,
                          seq_axes=seq, kv_rows=kv_rows)


def _map_with(fn, params, takes):
    if isinstance(params, dict):
        takes = takes or {}
        return {k: _map_with(fn, v, takes.get(k)) for k, v in params.items()}
    return fn(params, takes)


def _pick(per, i: int):
    if isinstance(per, dict):
        return {k: _pick(v, i) for k, v in per.items()}
    return per[i]


# ---------------------------------------------------------------------------
# the split functions


def vocab_parallel_embed(emb: torch.Tensor, tokens: torch.Tensor,
                         tp: TensorParallel) -> torch.Tensor:
    """Embeddings of ``tokens`` from this rank's rows of the table ``emb``
    (the vocab split evenly in rank order): a lookup masked to the rank's
    tokens, then summed over ``model``, replicated."""
    rows = emb.shape[0]
    local = tokens.long() - tp.index * rows
    inside = (local >= 0) & (local < rows)
    h = F.embedding(torch.where(inside, local, 0), emb)
    return tp.reduce_out(h * inside[..., None].to(h.dtype))


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 tp: TensorParallel) -> torch.Tensor:
    """Mean token cross-entropy of logits split over the vocab (this rank's
    columns ``logits``), in f32: the max over every rank's columns (a
    constant shift), then the sums of the shifted exponentials and the
    gold logit completed over ``model`` in one all-reduce."""
    lf = logits.float()
    cols = lf.shape[-1]
    with torch.no_grad(), tp.part("tp_all_reduce"):
        top = all_gather(lf.amax(-1), tp.group).amax(0)
    local = labels.long() - tp.index * cols
    inside = (local >= 0) & (local < cols)
    gold = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])
    sums = tp.reduce_out(torch.stack([
        torch.exp(lf - top[..., None]).sum(-1),
        gold[..., 0] * inside.to(lf.dtype)]))
    return torch.mean(torch.log(sums[0]) + top - sums[1])


def split_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float, total: int,
                  tp: TensorParallel, policy=None) -> torch.Tensor:
    """RMSNorm over a dim of ``total`` split across ranks (this rank's
    columns ``x`` and weights ``w``), in f32 and back to x's dtype: the
    rows' Σx² a segmented reduce over the local columns
    (``dispatch.reduce``), summed over ``model`` (:meth:`sum_split`), over
    ``total``."""
    xf = x.float()
    ss = tp.sum_split(dispatch.reduce(xf * xf, policy=policy))
    return (xf * torch.rsqrt(ss / total + eps)[..., None]
            * w.float()).to(x.dtype)

"""Op-level cost analysis of one rank's eager step: the three roofline
inputs and the rank's live memory, taken while the step runs.

Counterpart of ``repro.launch.hlo_analysis``. An eager torch program has no
HLO to parse; :class:`OpAnalyser` is a ``TorchDispatchMode`` that sees each
aten op as it runs (on real tensors, on ``meta`` or on fake ones) and
charges it:

  * ``flops``            matmul-class ops by ``torch.utils.flop_counter``'s
                         formulas; a pointwise op 1 an output element, a
                         reduction or scan |in| (the reference's
                         ``_instr_flops``); a cast 1 an element; softmax
                         and its backward as their pointwise and reduction
                         parts.
  * ``memory_bytes``     Σ (inputs + outputs) bytes over materialising ops;
                         views and metadata ops count nothing (the
                         reference's ``NON_MATERIAL``).
  * ``collective_bytes`` by kind, from the c10d ops and the functional
                         collectives, the reference's convention: the
                         per-rank result size (the operand size for
                         reduce-scatter), all-reduce counted twice.

The op-scope rule. The reference counts a fusion at its call site only. In
the same way a call of a :mod:`repro_torch.core.dispatch` op (``reduce``,
``scan``, ``weighted_scan``, ``ragged_*``, ``rmsnorm``, ``attention``,
``ssd``) is charged once, by the function it computes
(:func:`repro_torch.core.costs.op_flops`, its inputs' and outputs' bytes),
and the aten ops inside it are not seen. Its backward nodes are marked
(their ``metadata``): their own work goes uncounted (a wrapper's backward
through its plain version runs uncounted too), and the first to start
charges the backward: twice the forward FLOPs and the bytes of the inputs,
the incoming and the outgoing gradients. So a count taken on the kernels'
plain versions, on the Hopper kernels (which a dispatch mode cannot see
through ``ctypes``) and under ``baseline`` is the same.

An eager run executes every loop iteration, which is what the reference's
trip-count propagation reconstructs, so ``unknown_trip_whiles`` is 0.

Memory. Each storage an op makes is tracked until it is freed (a finalizer
on the storage, which autograd's saved tensors keep alive): the step's
``argument_bytes`` (its inputs, a ``DTensor`` by its local shard),
``output_bytes`` (what it returns, arguments excepted), ``peak_bytes`` (the
most live at once, arguments included) and ``temp_bytes`` (the peak less
both). A dispatch op's peak charge is its output; what its backward makes
is tracked when a counted op first reads it.

Every figure is this rank's: a sharded step runs on the rank's shards.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.core import costs

aten = torch.ops.aten

# ops that move no data: allocation, aliasing, metadata (views are found by
# their schema, ``OpOverload.is_view``)
NON_MATERIAL = {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten._unsafe_view, aten.arange, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
    aten.set_, aten.resize_,
}
SCANS = {aten.cumsum, aten.cumprod, aten.logcumsumexp, aten._cummax_helper,
         aten._cummin_helper}
# composite kernels: FLOPs an input element, their pointwise and reduction
# parts (softmax: max, subtract, exp, sum, divide)
COMPOSITE = {aten._softmax: 5, aten._log_softmax: 5,
             aten._softmax_backward_data: 4,
             aten._log_softmax_backward_data: 4}
# scatters that may accumulate (an index's backward is ``index_put`` with
# accumulate): one add a source element
ACCUMULATE = {aten.index_add, aten.scatter_add, aten.embedding_dense_backward,
              aten.index_put}


def _local(t):
    """A ``DTensor``'s local shard; any other tensor as it is."""
    inner = getattr(t, "_local_tensor", None)
    return t if inner is None else inner


def _tensors(tree) -> list:
    return [_local(t) for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def _bytes(tree) -> int:
    return costs.nbytes(*_tensors(tree))


def _numel(ts: list) -> int:
    return ts[0].numel() if ts else 0


# c10d op -> (kind, operand, result): which args hold the operand and the
# per-rank result (an index into args, or "out" for the op's return)
C10D = {
    "c10d::allgather_": ("all-gather", 1, 0),
    "c10d::_allgather_base_": ("all-gather", 1, 0),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "c10d::allgather_coalesced_": ("all-gather", 1, 0),
    "c10d::allreduce_": ("all-reduce", 0, 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0, 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 1, 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "c10d::alltoall_": ("all-to-all", 1, 0),
    "c10d::alltoall_base_": ("all-to-all", 1, 0),
    "c10d::broadcast_": ("broadcast", 0, 0),
    "c10d::send": ("collective-permute", 0, 0),
    "c10d::recv_": ("collective-permute", 0, 0),
    "c10d::recv_any_source_": ("collective-permute", 0, 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0, "out"),
    "_c10d_functional::all_gather_into_tensor_coalesced":
        ("all-gather", 0, "out"),
    "_c10d_functional::all_reduce": ("all-reduce", 0, "out"),
    "_c10d_functional::all_reduce_": ("all-reduce", 0, "out"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0, "out"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0, "out"),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0, "out"),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0, "out"),
    "_c10d_functional::broadcast": ("broadcast", 0, "out"),
    "_c10d_functional::broadcast_": ("broadcast", 0, "out"),
}
SYNC_ONLY = {"c10d::barrier", "c10d::monitored_barrier_",
             "_c10d_functional::wait_tensor"}
# the keys a dispatch op's backward nodes carry in their metadata: the op,
# and the walk that marked them; its inputs' nodes carry the walk's stop
SCOPE_KEY = "repro_torch.op_scope"
VISIT_KEY = "repro_torch.op_scope_walk"
STOP_KEY = "repro_torch.op_scope_stop"


class OpAnalyser(TorchDispatchMode):
    """Counts one rank's ops while it is active (``with OpAnalyser() as
    an:``, or :meth:`run`); :meth:`result` gives the counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.memory_bytes = 0.0
        self.collective_bytes: dict = defaultdict(float)
        self.n_collectives = 0
        self.dispatch_ops: dict = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        self.aten_ops: dict = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        self._suppress = 0
        self._sizes: dict[int, int] = {}     # id(storage) -> bytes, live
        self._finalizers: list = []
        self._args: set = set()
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0

    # -- memory ------------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def track(self, tree) -> int:
        """Tracks each storage of ``tree``'s tensors not yet tracked; ->
        the bytes newly tracked."""
        new = 0
        for t in _tensors(tree):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = id(st)
            if key in self._sizes:
                continue
            n = st.nbytes()
            self._sizes[key] = n
            self._finalizers.append(weakref.finalize(st, self._free, key))
            self.live += n
            new += n
        self.peak = max(self.peak, self.live)
        return new

    def _storage_keys(self, tree) -> set:
        keys = set()
        for t in _tensors(tree):
            try:
                keys.add(id(t.untyped_storage()))
            except (RuntimeError, NotImplementedError):
                pass
        return keys

    # -- counting ----------------------------------------------------------

    @contextlib.contextmanager
    def uncounted(self):
        """A scope in which no op is counted and no dispatch op charged."""
        self._suppress += 1
        prev, costs.ACTIVE = costs.ACTIVE, None
        try:
            yield
        finally:
            costs.ACTIVE = prev
            self._suppress -= 1

    def add_op(self, name: str, flops: float, nbytes: float) -> None:
        rec = self.dispatch_ops[name]
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.memory_bytes += nbytes

    def charge(self, op: str, fn, args: tuple, kwargs: dict):
        """Runs dispatch op ``op`` (``fn(*args, **kwargs)``) uncounted and
        charges it by formula (the hook of ``core.dispatch``); where it has
        a gradient to take, its backward is charged at its first backward
        node and the ops of its backward nodes go uncounted."""
        flops = costs.op_flops(op, args, kwargs)
        ins = [_local(a) for a in args if isinstance(a, torch.Tensor)]
        with self.uncounted():
            out = fn(*args, **kwargs)
        outs = _tensors(out)
        self.add_op(op, flops, costs.nbytes(*ins) + costs.nbytes(*outs))
        self.track(out)
        if torch.is_grad_enabled() and any(o.grad_fn is not None
                                           for o in outs):
            self._scope_backward(op, flops, ins, outs)
        return out

    def _scope_backward(self, op: str, flops: float, ins: list,
                        outs: list) -> None:
        """Marks the autograd nodes between ``outs`` and ``ins`` (their
        metadata), whose own work then goes uncounted, and charges the
        op's backward by formula when the first of them starts: twice the
        FLOPs, the inputs, the incoming gradients and the outgoing ones."""
        nbytes = costs.nbytes(*ins) + costs.nbytes(*outs) + costs.nbytes(
            *(t for t in ins if t.requires_grad))
        charged = []

        def charge_backward(*_):
            if not charged:
                charged.append(True)
                self.add_op(f"{op}.backward", 2 * flops, nbytes)

        # a node's Python object may be made anew at each access (so no
        # id() is stable): the walk keys its nodes by their metadata
        visit = object()
        stops = [t.grad_fn for t in ins if t.grad_fn is not None]
        for node in stops:
            node.metadata[STOP_KEY] = visit
        heads = [o.grad_fn for o in outs if o.grad_fn is not None]
        stack = list(heads)
        while stack:
            node = stack.pop()
            if node is None or node.metadata.get(STOP_KEY) is visit \
                    or node.metadata.get(VISIT_KEY) is visit \
                    or node.name() == "torch::autograd::AccumulateGrad":
                continue
            node.metadata[VISIT_KEY] = visit
            node.metadata[SCOPE_KEY] = op
            stack.extend(n for n, _ in node.next_functions)
        for node in stops:
            node.metadata.pop(STOP_KEY, None)
        for node in heads:
            node.register_prehook(charge_backward)

    def _collective(self, name: str, args, out) -> None:
        kind, opd, res = C10D.get(name, (name, 0, "out"))
        operand = _bytes(args[opd]) if len(args) > opd else 0
        result = _bytes(out if res == "out" else args[res])
        if kind == "all-reduce":
            moved = 2 * result
        elif kind == "reduce-scatter":
            moved = operand
        else:
            moved = result
        self.collective_bytes[kind] += moved
        self.n_collectives += 1
        self.memory_bytes += operand + result

    def _op_flops(self, func, args, kwargs, out, ins, outs) -> float:
        packet = func.overloadpacket
        if packet in flop_registry:
            largs, lkw, lout = tree_map(_local, (args, kwargs, out))
            return float(flop_registry[packet](*largs, **lkw, out_val=lout))
        if torch.Tag.pointwise in func.tags:
            return float(_numel(outs))
        if torch.Tag.reduction in func.tags or packet in SCANS:
            return float(_numel(ins))
        if packet in COMPOSITE:
            return float(COMPOSITE[packet] * _numel(ins))
        if packet in ACCUMULATE:
            return float(_numel(ins[-1:]))
        if packet is aten._to_copy and ins and outs \
                and ins[0].dtype != outs[0].dtype:
            return float(_numel(outs))
        if packet is aten.copy_ and len(ins) > 1 \
                and ins[0].dtype != ins[1].dtype:
            return float(_numel(ins))
        return 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suppress:
            return out
        node = torch._C._current_autograd_node()
        if node is not None and SCOPE_KEY in node.metadata \
                and not torch.is_grad_enabled():
            # a dispatch op's backward node, charged whole, and the engine's
            # accumulation of what it returns; with grad mode on, a
            # checkpointed layer's recompute that its unpack started, which
            # counts as any forward
            return out
        name = func._schema.name
        if name in SYNC_ONLY:
            return out
        if name in C10D or name.startswith(("c10d::", "_c10d_functional::")):
            self._collective(name, args, out)
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        flops = self._op_flops(func, args, kwargs, out, ins, outs)
        nbytes = 0 if (func.is_view or func.overloadpacket in NON_MATERIAL
                       or func.namespace == "prim") else \
            costs.nbytes(*ins) + costs.nbytes(*outs)
        self.flops += flops
        self.memory_bytes += nbytes
        rec = self.aten_ops[name]
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        # an input made where nothing was counted (a dispatch op's
        # backward) is tracked when an op first reads it
        self.track((ins, out))
        return out

    # -- a run -------------------------------------------------------------

    def __enter__(self):
        if costs.ACTIVE is not None:
            raise RuntimeError("an op analyser is already active")
        costs.ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            costs.ACTIVE = None

    def run(self, fn, *args, **kwargs):
        """-> fn's output, with this analyser watching the call; ``args``
        and ``kwargs`` are its arguments (their storages tracked from the
        start)."""
        self.argument_bytes += self.track((args, kwargs))
        self._args |= self._storage_keys((args, kwargs))
        # the backward on this thread, as on the CPU (a CUDA backward
        # would run on the engine's device thread)
        with torch.autograd.set_multithreading_enabled(False), self:
            out = fn(*args, **kwargs)
        seen = set(self._args)
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            if id(st) not in seen:
                seen.add(id(st))
                self.output_bytes += st.nbytes()
        return out

    def result(self) -> dict:
        """The reference's keys (``flops``, ``memory_bytes``,
        ``collective_bytes``, ``collective_total``, ``n_collectives``,
        ``unknown_trip_whiles``), plus ``memory`` and the counts by op:
        ``dispatch_ops`` (charged by formula) and ``aten_ops`` (by rule;
        calls, FLOPs and bytes of each)."""
        peak = max(self.peak, self.argument_bytes + self.output_bytes)
        return {
            "flops": self.flops,
            "memory_bytes": self.memory_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_total": sum(self.collective_bytes.values()),
            "n_collectives": self.n_collectives,
            "unknown_trip_whiles": 0,
            "memory": {
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": max(peak - self.argument_bytes
                                  - self.output_bytes, 0),
                "peak_bytes": peak,
            },
            "dispatch_ops": {k: dict(v) for k, v in
                             sorted(self.dispatch_ops.items())},
            "aten_ops": {k: dict(v) for k, v in
                         sorted(self.aten_ops.items())},
        }

    def close(self) -> None:
        """Stops tracking the storages still alive."""
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()


def analyse(fn, *args, **kwargs) -> dict:
    """-> the counts of one call ``fn(*args, **kwargs)`` (see
    :meth:`OpAnalyser.result`)."""
    an = OpAnalyser()
    try:
        out = an.run(fn, *args, **kwargs)
        del out
        return an.result()
    finally:
        an.close()


def roofline_terms(analysis: dict, *, peak_flops: float, hbm_bw: float,
                   link_bw: float) -> dict:
    """Three per-rank roofline terms in seconds (+ the dominant term)."""
    compute_s = analysis["flops"] / peak_flops
    memory_s = analysis["memory_bytes"] / hbm_bw
    collective_s = analysis["collective_total"] / link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


"""Serving engines over a fixed slot grid: continuous batching (default)
and the wave scheduler.

Continuous scheduler (counterpart of ``repro.serving.engine``'s default):

  * a fixed number of slots; a finished slot is refilled from the queue on
    the next tick, so no wave barrier holds the other slots;
  * the KV cache is a ring per slot with a position per slot: slot b writes
    token t at row ``(pos[b] + t) % capacity`` and attends ``min(pos[b] + t
    + 1, capacity)`` rows, so a sequence longer than the capacity degrades
    to sliding-window attention instead of failing;
  * prefill is chunked and mixed with decode: every tick is ONE block step
    of shape (slots, T), T = ``prefill_chunk`` while any slot consumes its
    prompt and 1 otherwise, with a valid-token count per slot;
  * the capacity is bucketed to powers of two, so at most two step shapes
    (T = chunk and T = 1) run per bucket.

``ServeConfig(cache_kind="paged")`` swaps the rings for the paged pool of
``serving/kvpool.py``: one pool of fixed-height KV pages shared by every
slot through block tables, prompt prefixes shared page by page (a shared
slot starts at the shared length and skips those prefill ticks),
copy-on-write of a shared page before a divergent write, admission deferred
under pool pressure, and for the ssm and hybrid families a pool of state
snapshots that a request extending a registered prompt loads instead of
prefilling it. The
host manager plans each tick; the plan is more inputs of the same step.

On a CUDA device each step shape is captured once in a ``torch.cuda.
CUDAGraph`` over the engine's cache tensors (the counterpart of the
reference's jitted block step): a tick is a copy of the inputs (the page
plan included) into the graph's static buffers, a replay, and the sampled
tokens' one fetch. The graphs share one memory pool and are captured again
only when the cache is reallocated for another capacity. A capture that
fails raises. On the CPU the same step runs eagerly.

Sampling is greedy, or with ``greedy=False`` a categorical draw over
``logits / temperature`` from a ``torch.Generator`` seeded with
``ServeConfig.seed``, outside the graph as the reference samples outside its
jitted step. The draw gives other bits than the reference's
``jax.random``: the two agree in distribution, not token for token.

Wave scheduler (``ServeConfig(scheduler="wave")``): requests are admitted in
waves of up to ``slots``; prompts are left-padded to the wave's longest
prompt (one scalar cache position; the padding is attended, as in the
reference); the wave prefills once through ``Bundle.prefill_last``, grows
the KV cache by the wave's budget, and decodes one token per step until
every member has its budget or emitted EOS. A windowed model's wave must
stay inside its window (prompt plus budget), else it raises before any
launch: a prompt past the window leaves a ring, which the growth would
break (the reference's wave attends zero rows there). An encoder-decoder
has no block step: asked for the continuous scheduler, the engine warns
and runs the wave, as the reference's does, and its prefill raises for the
missing ``frames`` (the engine has none to give; the reference fails on the
key).

Observability (``repro_torch.obs``, off by default) records what the
reference's engine records, under the same names: ``serving`` events and
``repro_serving_requests_total`` for admissions and finishes, one
step-cache lookup per engine, a ``serve_block_trace`` event per new step
shape, and per tick the queue-depth and slot-occupancy gauges, the
TTFT and token-latency histograms, ``repro_serving_tokens_total``, the four
tick phases and the tick's wall time, and the paged pool's gauges. Every
site guards on ``runtime.ACTIVE is not None``.

Spans (``obs.profiling``; recorded while a session is active or a profiler
records, read once a tick at its start): ``serving/tick``, from the end of
admission to the end of the tick, holding ``serving/block_step``, which in
a graph replay holds ``serving/stage`` (the inputs staged and copied) and
``serving/launch`` (``graph.replay()``); and for each request at its
admission ``serving/request/queue``, from its scheduled arrival to the
start of the tick that admitted it (``Result.admitted_s``).

Sharded serving (``mesh_ctx=``, a :class:`~repro_torch.parallel.
MeshContext`; every family with a block step on any mesh of ``data`` x
``model`` ranks, ``pod`` too where the rules name it), as the reference's
rules lay it out:

  * rows over the batch's mesh dims (``data``): every rank runs the same
    scheduler over the global slots and steps its own rows of them, the
    batch rule's split ``[d B / D, (d + 1) B / D)``; slots that the batch's
    mesh dims do not divide raise ``ValueError``. Each tick's logits are
    gathered into the whole ``(slots, vocab)`` and broadcast from rank 0,
    so every rank samples the same tokens;
  * heads, ``ff`` columns, the MoE's experts (``experts``, or every
    expert's ``e_ff`` columns where ``model`` does not divide the experts),
    SSM heads and vocab over ``model`` (``parallel.tensor_parallel``):
    :func:`serving_params` takes each rank's part of every parameter once,
    here (1/``model`` of every split leaf stays resident), and every block
    step runs the rank's share, with ``wo``, ``w_out``, the experts'
    combine and ``out_proj`` row-parallel (one all-reduce each) and the
    logits' vocab columns gathered; an MoE layer routes every token over
    every expert on each rank, in the groups of the whole slot grid (each
    rank its rows' groups, or where they do not divide, every rank's rows
    gathered), as the reference's one program does;
  * the caches are allocated as this rank's part
    (``models.lm.local_cache_pspec``): the ring's rows split over
    ``kv_seq``'s mesh dims where the rules shard it (the production rules'
    ``seq_shard=True``), each rank attending its range and the parts merged
    by log-sum-exp, the cache never gathered; the KV heads the rank
    computes, or every head where its rows are split over ``model``; the
    KV heads of a GQA group that does not divide ``model`` are each rank's
    own copy of its group's head, and the conv history holds the channels
    of the rank's SSM heads, two layouts the specs do not express. The
    paged KV pool and the SSM snapshot pool keep every page on every rank
    (their logical axes name no batch dim): each tick's new K and V rows,
    and the saved states, are gathered over the batch's mesh dims before
    the pool write, and the host's page plan stays global and the same on
    every rank.

Under a process group of more than one rank the engine admits in
**lockstep**, as the reference's multi-host engine does: every rank is fed
the same requests and admits them in queue order, arrival clocks ignored,
so every rank enters every step with the same shapes, idle ticks and empty
rows included; the wave scheduler raises (its steps run sharded through
``training.make_serve_step(bundle, mesh_ctx=)``). The collectives go
through host memory (gloo), which a CUDA graph cannot capture: under a
multi-rank mesh every tick runs the eager step, and ``compile_stats()``
counts no graph and says why. The encoder-decoder has no block step, and
the wave it falls back to raises under lockstep, as the reference's
engine does; its sharded wave steps run through ``training.
make_serve_step(bundle, mesh_ctx=)``, which also takes a rank's rows of
the ``frames``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core import policy as kpolicy
from repro_torch.core.policy import KernelPolicy
from repro_torch.kernels import ops as kops
from repro_torch.models.common import init_params, stack_lens, \
    unstack_blocks
from repro_torch.models import build
from repro_torch.models.lm import Bundle, local_cache_pspec, \
    pad_cache_seq, param_takes, serves_split
from repro_torch.obs import profiling as _prof
from repro_torch.obs import runtime as _obs
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.parallel.mesh_context import activate
from repro_torch.parallel.sharded_state import gather_full
from repro_torch.parallel.sharding import is_dtensor, spec_of
from repro_torch.serving import kvpool

# the block step's inputs that hold one row a slot: a rank steps its own
# rows of them (the page tables, copy pairs and snapshot saves stay whole)
ROW_INPUTS = ("tokens", "n_valid", "reset", "reset_pos", "snap_load")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4                  # concurrent sequences (static batch)
    max_new: int = 32               # decode budget per request (default)
    eos_token: int = 2
    greedy: bool = True
    temperature: float = 1.0
    scheduler: str = "continuous"   # continuous | wave
    prefill_chunk: int = 16         # prompt tokens consumed per tick/slot
    max_context: int | None = None  # cap on ring-cache capacity (rows)
    # KV-cache layout of the continuous scheduler: the per-slot rings, or
    # the paged pool with prefix sharing and copy-on-write (kvpool.py)
    cache_kind: str = "ring"        # ring | paged
    page_rows: int | None = None    # page height (None: KV_PAGE_ROWS)
    pool_pages: int | None = None   # KV pool size (None: (slots+1) pages/slot)
    state_pages: int | None = None  # SSM snapshot pool size (None: 2*slots)
    prefix_sharing: bool = True     # trie-share prompt prefixes (paged only)
    seed: int = 0                   # sampling generator seed
    trace_ring: int = 4096          # admit/finish events kept in memory
    # explicit KernelPolicy for every core op of the served model; strings
    # coerce. A value rebuilds the bundle with it; None keeps the bundle's
    # own, and where that is None too the engine binds the policy active at
    # its construction (see ServingEngine)
    policy: KernelPolicy | None = None
    # deprecated spelling of ``policy`` (a bare path label); warns once
    kernel_path: dataclasses.InitVar[str | None] = None

    def __post_init__(self, kernel_path):
        if self.scheduler not in ("continuous", "wave"):
            raise ValueError(f"scheduler must be 'continuous' or 'wave', "
                             f"got {self.scheduler!r}")
        if self.cache_kind not in ("ring", "paged"):
            raise ValueError(f"cache_kind must be 'ring' or 'paged', got "
                             f"{self.cache_kind!r}")
        if self.cache_kind == "paged" and self.scheduler == "wave":
            raise ValueError(
                "the paged KV cache requires the continuous scheduler "
                "(wave batching shares one scalar position counter)")
        if not self.greedy and not self.temperature > 0:
            raise ValueError(f"sampling needs a temperature > 0, got "
                             f"{self.temperature}")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.trace_ring < 1:
            raise ValueError("trace_ring must be >= 1")
        object.__setattr__(self, "policy", kpolicy.coerce_config_policy(
            self.policy, kernel_path, "ServeConfig"))


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (prompt_len,) int
    max_new: int | None = None      # per-request budget (None: cfg.max_new)
    arrival_s: float = 0.0          # open-loop arrival offset from run()


@dataclasses.dataclass
class Result:
    uid: int
    tokens: list                    # generated ids (up to EOS)
    prompt_len: int
    arrival_s: float = 0.0
    admitted_s: float | None = None      # start of the admitting tick
    first_token_s: float | None = None   # emission time of first token
    finish_s: float | None = None        # emission time of last token
    token_s: list = dataclasses.field(default_factory=list)
    admitted_tick: int = -1
    finish_tick: int = -1


@dataclasses.dataclass
class _Slot:
    """One row of the continuous-batching slot grid."""
    free: bool = True
    req: Request | None = None
    ppos: int = 0                   # prompt tokens consumed so far
    budget: int = 0
    last: int = 0                   # last sampled token (decode input)
    result: Result | None = None


def serving_params(params, bundle: Bundle, mesh_ctx=None):
    """The engine's compute parameters, in the model's compute dtype, the
    stacked ``(layers, ...)`` leaves split into the forward's per-layer
    list. Unsharded, every leaf whole (a ``DTensor`` leaf cast on its
    shard, then gathered). Under a mesh that splits a dim, each rank's part
    of every leaf (``models.lm.param_takes``, ``TensorParallel.take``): its
    heads' q, k and v columns and ``wo`` rows (an encoder-decoder's self
    and cross attention alike), its ``ff`` columns, its experts (or every
    expert's ``e_ff`` columns), its SSM heads' part of the Mamba leaves,
    its vocab rows of the embedding and head where the vocab divides
    ``model``, and the rest whole; a leaf already split over ``model`` as
    the rank takes it is gathered over the other mesh dims only, any other
    is gathered whole and cut, so 1/``model`` of every split leaf stays
    resident."""
    cfg = bundle.cfg
    if serves_split(cfg, mesh_ctx):
        tp = tpar.for_serving(mesh_ctx, cfg.dtype, vocab=cfg.vocab)
        top, stacks = param_takes(cfg, tp)
        shards = tree.map_tree(_shard_of, params)
        out = {k: tp.takes(v, top.get(k)) for k, v in shards.items()
               if k not in stacks}
        lens = stack_lens(cfg)
        for key, takes in stacks.items():
            layers = shards[key]
            if isinstance(layers, dict):        # the stacked layout
                layers = tp.layers(layers, takes, lens[key])
            out[key] = [tp.takes(lp, takes) for lp in layers]
        return out

    def whole(t):
        if is_dtensor(t):
            shard = t.to_local()
            shard = shard.to(cfg.dtype) if shard.is_floating_point() \
                else shard
            return gather_full(shard, spec_of(t), t.device_mesh)
        return t.to(cfg.dtype) if t.is_floating_point() else t

    params = tree.map_tree(whole, params)
    if any(isinstance(params.get(k), dict) for k in stack_lens(cfg)):
        params = unstack_blocks(params, cfg)
    return params


def _shard_of(t) -> tpar.Shard:
    """A leaf as a :class:`~repro_torch.parallel.tensor_parallel.Shard`: a
    ``DTensor``'s local shard and spec, a plain tensor whole."""
    if is_dtensor(t):
        return tpar.Shard(t.to_local(), spec_of(t))
    return tpar.Shard(t, (None,) * t.ndim)


def _bucket(n: int) -> int:
    """Next power of two >= n (floor 16): the ring-capacity buckets that
    bound the number of step shapes across mixed-length workloads."""
    return max(16, 1 << (max(int(n), 1) - 1).bit_length())


@dataclasses.dataclass
class _BlockGraph:
    """The block step of ``t_len`` tokens captured over one cache.

    ``host`` (pinned) and ``inputs`` hold the step's inputs packed into one
    int64 vector: ``fields`` gives each input's (offset, shape) there (the
    tokens, ``n_valid``, the reset flags and, on the paged cache, the page
    plan). ``launches`` is what each replay launches of the counted
    kernels."""
    t_len: int
    graph: torch.cuda.CUDAGraph
    host: torch.Tensor
    inputs: torch.Tensor
    fields: dict
    logits: torch.Tensor
    launches: dict

    @torch.inference_mode()     # the buffers were made under it
    def replay(self, step_inputs: dict) -> torch.Tensor:
        # every tick ends with a fetch that waits for the replay, so the
        # previous copy out of ``host`` is done before it is written again,
        # and the replay has read the page plan before the next is staged
        with _prof.span("serving/stage"):
            staged = self.host.numpy()
            for name, (off, shape) in self.fields.items():
                staged[off:off + int(np.prod(shape))] = \
                    np.asarray(step_inputs[name]).reshape(-1)
            self.inputs.copy_(self.host, non_blocking=True)
        with _prof.span("serving/launch"):
            self.graph.replay()
        kops.add_launches(self.launches)
        return self.logits


def _pack(step_inputs: dict) -> tuple[np.ndarray, dict]:
    """The step's inputs as one int64 vector and each one's (offset,
    shape) in it."""
    fields, off = {}, 0
    for name, arr in step_inputs.items():
        fields[name] = (off, arr.shape)
        off += arr.size
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1)
                           for a in step_inputs.values()])
    return flat, fields


def _unpack(buf: torch.Tensor, fields: dict) -> dict:
    return {name: buf[off:off + int(np.prod(shape))].view(shape)
            for name, (off, shape) in fields.items()}


class ServingEngine:
    """``run(requests)`` drains a list with the configured scheduler and
    returns that call's results sorted by uid (``self.results`` keeps them
    all).

    The parameters are cast to the model's compute dtype once, here (the
    reference casts inside its jitted serving step). ``prefills`` and
    ``decodes`` count the wave's forward passes, ``ticks`` the continuous
    scheduler's block steps. ``mesh_ctx`` serves sharded (see the module's
    docstring)."""

    def __init__(self, bundle: Bundle, params, cfg: ServeConfig,
                 mesh_ctx=None):
        if cfg.policy is not None and bundle.cfg.policy != cfg.policy:
            bundle = build(dataclasses.replace(bundle.cfg,
                                               policy=cfg.policy))
        self.mesh_ctx = mesh_ctx
        if serves_split(bundle.cfg, mesh_ctx):
            tpar.batch_rows(mesh_ctx, cfg.slots, strict=True, what="slots")
        # every rank of a multi-process world runs the same ticks (each
        # step's collectives need them all): admission in queue order,
        # arrival clocks ignored, as the reference's multi-host lockstep
        self._lockstep = mesh_ctx is not None and dist.is_initialized() \
            and dist.get_world_size() > 1
        if cfg.scheduler == "continuous" and bundle.decode_block is None:
            warnings.warn(
                "bundle has no block-decode step (encoder-decoder); "
                "falling back to the wave scheduler", stacklevel=2)
            if cfg.cache_kind == "paged":
                warnings.warn(
                    "paged KV cache requires the continuous scheduler; "
                    "ignoring cache_kind='paged'", stacklevel=2)
            cfg = dataclasses.replace(cfg, scheduler="wave",
                                      cache_kind="ring")
        # the encoder-decoder's fallback too: it has no lockstep scheduler
        if self._lockstep and cfg.scheduler == "wave":
            raise ValueError(
                "multi-host serving requires the continuous scheduler "
                "(wave admission depends on per-host wall clocks)")
        self.bundle = bundle
        self.cfg = cfg
        # the policy every eager step, prefill and capture runs under: a
        # CUDA graph bakes in the kernels of its capture, so a later
        # set_policy must not make the eager steps disagree with the replays
        # (the counterpart of the reference's jitted steps, which keep the
        # policy of their trace)
        self.policy = bundle.cfg.policy or kpolicy.get_policy()
        self.scheduler = cfg.scheduler
        self.params = serving_params(params, bundle, mesh_ctx)
        self.device = self.params["embed"].device
        self.queue: deque[Request] = deque()
        self.results: list[Result] = []
        self.prefills = 0
        self.decodes = 0
        # admit/finish events: a bounded ring, as in the reference
        self._trace: deque[dict] = deque(maxlen=cfg.trace_ring)
        self.ticks = 0                  # block steps issued (continuous)
        self._cache = None              # continuous ring cache (reused)
        self._capacity = None
        self._tp = None                 # the block step's serving context
        self._overflow_warned = False   # max_context degrade: warn once
        self._kv = None                 # PagedKVManager (cache_kind=paged)
        self._graphs: dict[int, _BlockGraph] = {}   # by T, for this cache
        self._pool = None               # the graphs' shared memory pool
        self._step_shapes: set[tuple[int, int]] = set()
        self.captures = 0
        self.capture_s = 0.0
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        if _obs.ACTIVE is not None:
            # the reference looks its jitted steps up once per engine in a
            # cache shared by the engines of one config; the port's graphs
            # belong to one engine's cache, so every engine's lookup misses
            _obs.ACTIVE.counter(
                "repro_serving_compile_cache_total",
                "serving step-cache lookups by result").inc(result="miss")

    # -- shared plumbing ----------------------------------------------------

    @property
    def trace(self) -> list[dict]:
        """The retained admit/finish events, oldest first (bounded by
        ``ServeConfig.trace_ring``)."""
        return list(self._trace)

    def _trace_event(self, tick: int, event: str, uid: int, slot: int,
                     **extra) -> None:
        ev = {"tick": tick, "event": event, "uid": uid, "slot": slot,
              **extra}
        self._trace.append(ev)
        sess = _obs.ACTIVE
        if sess is not None:
            sess.emit("serving", **ev)
            sess.counter(
                "repro_serving_requests_total",
                "request lifecycle events by type").inc(event=event)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def compile_stats(self) -> dict:
        """Step shapes of the continuous scheduler: on a CUDA device the
        graphs captured (and the seconds their warm-up and capture took),
        on the CPU the distinct (T, capacity) shapes run. Under a
        multi-rank mesh no graph is captured (``eager`` says why) and
        ``block`` counts the shapes run."""
        if self._lockstep:
            return {"block": len(self._step_shapes), "capture_s": 0.0,
                    "graphs": 0,
                    "eager": "multi-rank mesh: the host-staged gloo "
                             "collectives of a step cannot be captured"}
        if self.device.type == "cuda":
            return {"block": self.captures, "capture_s": self.capture_s}
        return {"block": len(self._step_shapes), "capture_s": 0.0}

    def kv_stats(self) -> dict | None:
        """The paged pool's occupancy and sharing counters (None under the
        ring cache): pages in use / free / shared, peak in use, CoW copies,
        defers, trie entries; see ``PagedKVManager.stats``."""
        return None if self._kv is None else self._kv.stats()

    def _budget(self, req: Request) -> int:
        return self.cfg.max_new if req.max_new is None else req.max_new

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy, or a categorical draw over ``logits / temperature`` by
        the Gumbel-max rule from the engine's seeded generator (one draw a
        row, idle slots included, as the reference draws). The fetch waits
        for the step."""
        if logits.ndim == 3:            # wave steps emit (B, T, V)
            logits = logits[:, -1]
        if self._lockstep:
            # one value on every rank: each draws the same token
            buf = logits.contiguous().cpu()
            dist.broadcast(buf, src=0)
            logits = buf.to(logits.device)
        if self.cfg.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits.float() / self.cfg.temperature + gumbel,
                            dim=-1).cpu().numpy()

    def run(self, requests: list[Request]) -> list[Result]:
        t0 = time.perf_counter()
        for r in sorted(requests, key=lambda r: r.arrival_s):
            self.submit(r)
        if self.scheduler == "continuous":
            out = self._run_continuous(t0)
        else:
            out = self._run_wave(t0)
        self.results.extend(out)        # full history; return is per-call
        return sorted(out, key=lambda r: r.uid)

    # -- continuous scheduler ----------------------------------------------

    def _ensure_cache(self) -> None:
        need = max((len(r.prompt) + self._budget(r) for r in self.queue),
                   default=16)
        cap = _bucket(need)
        if self.cfg.max_context is not None:
            cap = min(cap, _bucket(self.cfg.max_context))
        kind: dict = {}
        if self.cfg.cache_kind == "paged":
            rows = kvpool.validate_page_rows(self.cfg.page_rows
                                             or kvpool.KV_PAGE_ROWS)
            swa = self.bundle.cfg.swa_window
            if swa:
                # page granularity: the sliding window rounds UP to a whole
                # page (a paged slot keeps >= swa rows, never fewer)
                cap = min(cap, -(-swa // rows) * rows)
            cap = max(cap, rows)
            mp = cap // rows
            pool_pages = self.cfg.pool_pages or (self.cfg.slots + 1) * mp
            state_pages = self.cfg.state_pages or 2 * self.cfg.slots
            kind = {"kind": "paged", "pool_pages": pool_pages,
                    "page_rows": rows, "state_pages": state_pages}
            if self._kv is None or self._capacity != cap or \
                    self._kv.kv is not None and \
                    self._kv.kv.n_pages != pool_pages:
                self._kv = kvpool.PagedKVManager(
                    slots=self.cfg.slots, page_rows=rows, maxpages=mp,
                    pool_pages=pool_pages, family=self.bundle.cfg.family,
                    state_pages=state_pages,
                    sharing=self.cfg.prefix_sharing)
        if self._cache is None or self._capacity != cap:
            # the graphs were captured over the old cache; their memory pool
            # goes with them (a capture into a pool no live graph holds
            # fails an assertion of the caching allocator)
            self._graphs.clear()
            self._pool = None
            pspec = self.bundle.cache_pspec(self.cfg.slots, cap,
                                            per_slot_pos=True, **kind)
            if tpar.splits(self.mesh_ctx):
                cfg = self.bundle.cfg
                ring = pspec.get("attn", {}).get("k") \
                    if self.cfg.cache_kind == "ring" else None
                self._tp = tpar.for_serving(self.mesh_ctx, cfg.dtype,
                                            vocab=cfg.vocab,
                                            batch=self.cfg.slots, kv=ring)
                pspec = local_cache_pspec(cfg, pspec, self._tp)
            gen = torch.Generator(device=self.device)    # zeros draw nothing
            self._cache = init_params(pspec, gen, self.bundle.cfg.dtype)
            self._capacity = cap

    def _step_inputs(self, tokens: np.ndarray, n_valid: np.ndarray,
                     reset: np.ndarray, plan: dict | None) -> dict:
        """The block step's inputs: the tokens, ``n_valid``, the reset flags
        and, on the paged cache, the manager's plan of the tick, its
        copy-on-write entries as the fixed pairs the step of ``T`` tokens
        takes (a slot writes at most ``ceil((T-1)/R) + 1`` pages a tick)."""
        out = {"tokens": tokens, "n_valid": n_valid, "reset": reset}
        if plan is None:
            return out
        out["reset_pos"] = plan["reset_pos"]
        if "kv_copy" in plan:
            per_slot = -(-(tokens.shape[1] - 1) // self._kv.page_rows) + 1
            src, dst = kvpool.cow_pairs(plan["kv_copy"],
                                        self.cfg.slots * per_slot)
            out.update(tables=plan["tables"], kv_src=src, kv_dst=dst)
        if "snap_save" in plan:
            out.update(snap_save=plan["snap_save"],
                       snap_load=plan["snap_load"])
        return out

    def _idle_inputs(self, t_len: int) -> dict:
        """A step that changes nothing: every ``n_valid`` 0, no reset, an
        identity copy plan, no snapshot saved or loaded."""
        nb = self.cfg.slots
        zeros = np.zeros(nb, np.int64)
        plan = None
        if self._kv is not None:
            plan = {"reset_pos": zeros}
            if self._kv.has_kv:
                plan.update(tables=np.zeros((nb, self._kv.maxpages),
                                            np.int64),
                            kv_copy=np.arange(self._kv.kv.n_pages))
            if self._kv.has_state:
                plan.update(snap_save=np.full(nb, -1),
                            snap_load=np.full(nb, -1))
        return self._step_inputs(np.zeros((nb, t_len), np.int64), zeros,
                                 zeros, plan)

    def _eager_step(self, inputs: dict) -> torch.Tensor:
        tp = self._tp
        if tp is not None:              # this rank's rows of the slots
            rows = self.cfg.slots // tp.row_parts()
            r0 = tp.row_start(rows)
            inputs = {k: v.narrow(0, r0, rows) if k in ROW_INPUTS else v
                      for k, v in inputs.items()}
        kw = {"n_valid": inputs["n_valid"],
              "reset_mask": inputs["reset"].bool()}
        step = self.bundle.decode_block
        if self._kv is not None:
            step = self.bundle.decode_block_paged
            kw["page"] = {k: v for k, v in inputs.items()
                          if k not in ("tokens", "n_valid", "reset")}
        with kpolicy.using_policy(self.policy), activate(self.mesh_ctx), \
                tpar.active(tp):
            logits, _ = step(self.params, self._cache,
                             {"tokens": inputs["tokens"]}, **kw)
            if tp is not None:
                logits = tp.gather_rows(logits)
        return logits

    def _capture(self, t_len: int) -> _BlockGraph:
        """Warm the step up on a side stream, then capture it. The warm-up
        runs the idle step, which leaves the cache as it is, and builds what
        cannot be built inside a capture (the kernels' library, library
        handles)."""
        t0 = time.perf_counter()
        flat, fields = _pack(self._idle_inputs(t_len))
        host = torch.from_numpy(flat).pin_memory()
        inputs = host.to(self.device)

        def step():
            return self._eager_step(_unpack(inputs, fields))

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kops.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            logits = step()
        counted = {k: n - before[k] for k, n in kops.launch_counts().items()
                   if n != before[k]}
        kops.add_launches({k: -n for k, n in counted.items()})
        if self._pool is None:
            self._pool = graph.pool()
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return _BlockGraph(t_len, graph, host, inputs, fields, logits,
                           counted)

    def _block_step(self, inputs: dict) -> torch.Tensor:
        """One block step of the scheduler -> logits (B, vocab).

        A (T, capacity) seen first (on the card, a capture) emits
        ``serve_block_trace``, the reference's retrace event."""
        t_len = inputs["tokens"].shape[1]
        shape = (t_len, self._capacity)
        sess = _obs.ACTIVE
        if sess is not None:
            self._trace_step_shape(sess, t_len, shape)
        self._step_shapes.add(shape)
        if self.device.type != "cuda" or self._lockstep:
            return self._eager_step({k: torch.from_numpy(
                np.asarray(v, np.int64)).to(self.device)
                for k, v in inputs.items()})
        if t_len not in self._graphs:
            self._graphs[t_len] = self._capture(t_len)
        return self._graphs[t_len].replay(inputs)

    def _trace_step_shape(self, sess, t_len: int, shape: tuple) -> None:
        new = (t_len not in self._graphs
               if self.device.type == "cuda" and not self._lockstep
               else shape not in self._step_shapes)
        if new:
            sess.emit("serve_block_trace", slots=self.cfg.slots,
                      block_t=t_len, cache_kind=self.cfg.cache_kind)
            sess.counter(
                "repro_serve_block_traces_total",
                "block-step retraces (jit compiles) by T").inc(
                block_t=str(t_len))

    @torch.inference_mode()
    def _run_continuous(self, t0: float) -> list[Result]:
        """The continuous loop. Observed tick phases share their boundaries,
        so they sum to the tick: ``admission`` (refilling slots), then
        ``prefill`` or ``decode`` (building the inputs, the page plan and
        the block step), ``sample`` (the sampled tokens' fetch) and
        ``bookkeep``. On the card the block step is a graph replay that
        returns once enqueued, and the fetch is where the host waits for
        the card, as for the reference's asynchronous jitted step: the step
        phase is the enqueue, and ``sample`` holds the device's time."""
        nb = self.cfg.slots
        self._ensure_cache()
        chunk = min(self.cfg.prefill_chunk, self._capacity)
        attn = self._cache.get("attn")
        rows = (None if attn is None or self._kv is not None
                else attn["k"].shape[2])
        if rows is not None and chunk > rows:
            held = ("a rank holds (the ring's rows split across ranks)"
                    if self._tp is not None and self._tp.seq_axes else
                    f"that swa_window={self.bundle.cfg.swa_window} leaves")
            raise ValueError(
                f"prefill_chunk {chunk} exceeds the ring of {rows} rows "
                f"{held}: a block step writes each of its tokens to its own "
                "row (the reference fails the same step's assertion); set "
                "prefill_chunk <= those rows")
        slots = [_Slot() for _ in range(nb)]
        out: list[Result] = []

        while True:
            sess = _obs.ACTIVE       # per tick: sessions can open mid-run
            spans = _prof.recording()
            now = time.perf_counter() - t0
            tick_start = t0 + now    # same clock read; no cost when off
            cur = self.ticks
            # admission: refill every free slot from the arrived queue. The
            # paged cache admits head-of-line only: a deferred request
            # blocks later ones (FIFO; skipping ahead would starve it)
            reset = np.zeros(nb, bool)
            blocked = False
            for i, s in enumerate(slots):
                if blocked or not s.free or not self.queue:
                    continue
                if not self._lockstep and self.queue[0].arrival_s > now:
                    continue
                req = self.queue[0]
                budget = self._budget(req)
                start = 0
                if self._kv is not None:
                    got = self._kv.admit(i, req.prompt, budget, uid=req.uid)
                    if got is None:     # pool pressure: defer admission
                        blocked = True
                        continue
                    start = got
                need = len(req.prompt) + budget
                if need > self._capacity:
                    # capacity saturated at max_context: the slot degrades
                    # to sliding-window attention (the ring or the block
                    # table overwrites its oldest rows); correct for
                    # windowed models, lossy for full-attention ones
                    if not self._overflow_warned:
                        warnings.warn(
                            f"request uid={req.uid} needs {need} cache "
                            f"rows but capacity is {self._capacity} "
                            f"(max_context={self.cfg.max_context}); "
                            "oldest rows will be overwritten — degrading "
                            "to sliding-window attention. Further "
                            "overflows are traced, not warned.",
                            stacklevel=2)
                        self._overflow_warned = True
                    self._trace_event(cur, "swa_degrade", req.uid, i,
                                      need=need, capacity=self._capacity)
                self.queue.popleft()
                if spans:
                    _prof.add("serving/request/queue", t0 + req.arrival_s,
                              tick_start)
                slots[i] = _Slot(
                    free=False, req=req, budget=budget,
                    result=Result(uid=req.uid, tokens=[],
                                  prompt_len=len(req.prompt),
                                  arrival_s=req.arrival_s,
                                  admitted_s=now, admitted_tick=cur))
                slots[i].ppos = start   # trie-shared prefix tokens skipped
                reset[i] = True
                self._trace_event(cur, "admit", req.uid, i, start=start)
            active = [i for i, s in enumerate(slots) if not s.free]
            if not active:
                if blocked:
                    req = self.queue[0]
                    raise RuntimeError(
                        f"paged KV pool cannot admit request uid={req.uid} "
                        f"(prompt {len(req.prompt)} + budget "
                        f"{self._budget(req)}) even with every slot idle; "
                        "raise ServeConfig.pool_pages")
                if not self.queue:
                    break
                wait = self.queue[0].arrival_s - now
                if wait > 0 and not self._lockstep:
                    time.sleep(min(wait, 0.01))
                continue

            # one block step: T = chunk while anyone prefills, else 1
            any_prefill = any(slots[i].ppos < len(slots[i].req.prompt)
                              for i in active)
            t_len = chunk if any_prefill else 1
            if sess is not None:
                t_adm = time.perf_counter()
            with _prof.span("serving/tick"):
                if sess is not None:
                    sess.gauge("repro_serving_queue_depth",
                               "requests waiting for a slot").set(
                        len(self.queue))
                    sess.gauge("repro_serving_slot_occupancy",
                               "fraction of decode slots busy").set(
                        len(active) / nb)
                tokens = np.zeros((nb, t_len), np.int64)
                n_valid = np.zeros(nb, np.int64)
                for i in active:
                    s = slots[i]
                    plen = len(s.req.prompt)
                    if s.ppos < plen:
                        take = min(t_len, plen - s.ppos)
                        tokens[i, :take] = s.req.prompt[s.ppos:s.ppos + take]
                        n_valid[i] = take
                    else:
                        tokens[i, 0] = s.last
                        n_valid[i] = 1
                plan = None
                if self._kv is not None:
                    plan = self._kv.plan_tick({i: int(n_valid[i])
                                               for i in active})
                step_in = self._step_inputs(tokens, n_valid, reset, plan)
                with _prof.span("serving/block_step"):
                    logits = self._block_step(step_in)
                if sess is not None:
                    t_step = time.perf_counter()
                nxt = self._sample(logits)
                now = time.perf_counter() - t0
                self.ticks = cur + 1

                for i in active:
                    s = slots[i]
                    if self._kv is not None:
                        self._kv.advance(i, int(n_valid[i]))
                    plen = len(s.req.prompt)
                    if s.ppos < plen:
                        s.ppos += int(n_valid[i])
                        if self._kv is not None and s.ppos >= plen:
                            self._kv.mark_prefilled(i)
                        if s.ppos < plen:
                            continue        # mid-prefill: logits are interim
                    # this tick produced a real token for slot i
                    tok = int(nxt[i])
                    s.last = tok
                    res = s.result
                    if res.first_token_s is None:
                        res.first_token_s = now
                        if sess is not None:
                            sess.histogram(
                                "repro_serving_ttft_seconds",
                                "request arrival to first token").observe(
                                max(0.0, now - res.arrival_s))
                    finished = tok == self.cfg.eos_token
                    if not finished:
                        if sess is not None and res.token_s:
                            sess.histogram(
                                "repro_serving_token_latency_seconds",
                                "gap between consecutive emitted tokens"
                            ).observe(max(0.0, now - res.token_s[-1]))
                        res.tokens.append(tok)
                        res.token_s.append(now)
                        if sess is not None:
                            sess.counter("repro_serving_tokens_total",
                                         "decode tokens emitted").inc()
                        finished = len(res.tokens) >= s.budget
                    if finished:
                        res.finish_s = now
                        res.finish_tick = cur
                        self._trace_event(cur, "finish", res.uid, i)
                        out.append(res)
                        if self._kv is not None:
                            self._kv.release(i)   # pages back to the pool
                        slots[i] = _Slot()  # freed; refilled next tick
                if self._kv is not None:
                    self._kv.end_tick()
                    if sess is not None:
                        self._kv.emit_gauges()
                if sess is not None:
                    # taken before the tick's span records, so its cost
                    # falls outside the phases
                    t_end = time.perf_counter()
            if sess is not None:
                # contiguous boundaries: the four phase durations sum to
                # the tick wall time (to float addition error)
                ph = sess.histogram(
                    "repro_serving_tick_phase_seconds",
                    "per-tick phase wall time (phases sum to the tick)")
                ph.observe(t_adm - tick_start, phase="admission")
                ph.observe(t_step - t_adm,
                           phase=("prefill" if any_prefill else "decode"))
                ph.observe((t0 + now) - t_step, phase="sample")
                ph.observe(t_end - (t0 + now), phase="bookkeep")
                sess.histogram(
                    "repro_serving_tick_seconds",
                    "block-step tick wall time").observe(t_end - tick_start)
        return out

    # -- wave scheduler -----------------------------------------------------

    def _run_wave(self, t0: float) -> list[Result]:
        out: list[Result] = []
        while self.queue:
            now = time.perf_counter() - t0
            wave: list[Request] = []
            while self.queue and len(wave) < self.cfg.slots and \
                    self.queue[0].arrival_s <= now:
                wave.append(self.queue.popleft())
            if not wave:                # open loop: wait for next arrival
                time.sleep(min(self.queue[0].arrival_s - now, 0.01))
                continue
            out.extend(self.serve_wave(wave, t0))
        return out

    def serve_wave(self, wave: list[Request],
                   t0: float | None = None) -> list[Result]:
        with torch.inference_mode(), kpolicy.using_policy(self.policy):
            return self._serve_wave(wave, t0)

    def _serve_wave(self, wave: list[Request],
                    t0: float | None) -> list[Result]:
        if t0 is None:
            t0 = time.perf_counter()
        admitted = time.perf_counter() - t0
        if _prof.recording():
            for r in wave:
                _prof.add("serving/request/queue", t0 + r.arrival_s,
                          t0 + admitted)
        nb, live = self.cfg.slots, len(wave)
        budgets = [self._budget(r) for r in wave]
        wave_budget = max(budgets)
        plen = max(len(r.prompt) for r in wave)
        swa = self.bundle.cfg.swa_window
        if swa and plen + wave_budget > swa:
            raise ValueError(
                f"the wave's prompt ({plen} tokens) and budget "
                f"({wave_budget}) pass the sliding window ({swa}): its cache "
                "would grow past the window's ring; serve it with the "
                "continuous scheduler")
        tokens = np.zeros((nb, plen), np.int64)
        for i, r in enumerate(wave):                # left-pad prompts
            tokens[i, plen - len(r.prompt):] = r.prompt
        logits, cache = self.bundle.prefill_last(
            self.params, {"tokens": torch.from_numpy(tokens).to(self.device)})
        self.prefills += 1
        cache = pad_cache_seq(cache, wave_budget)
        nxt = self._sample(logits)
        now = time.perf_counter() - t0

        out = [[int(nxt[i])] for i in range(live)]
        times = [[now] for _ in range(live)]
        # rows past the wave are done from the start: never sampled into
        # results and never keep the wave alive
        done = np.ones(nb, bool)
        for i in range(live):
            done[i] = int(nxt[i]) == self.cfg.eos_token or budgets[i] <= 1
        for _ in range(wave_budget - 1):
            if done.all():
                break
            step = torch.from_numpy(nxt.reshape(nb, 1).astype(np.int64))
            logits, cache = self.bundle.decode(
                self.params, cache, {"tokens": step.to(self.device)})
            self.decodes += 1
            nxt = self._sample(logits)
            now = time.perf_counter() - t0
            for i in range(live):
                if not done[i]:
                    out[i].append(int(nxt[i]))
                    times[i].append(now)
                    done[i] = (int(nxt[i]) == self.cfg.eos_token
                               or len(out[i]) >= budgets[i])
        results = []
        for i, r in enumerate(wave):
            toks, ts = out[i], times[i]
            if self.cfg.eos_token in toks:
                cut = toks.index(self.cfg.eos_token)
                toks, ts = toks[:cut], ts[:cut]
            results.append(Result(
                uid=r.uid, tokens=toks, prompt_len=len(r.prompt),
                arrival_s=r.arrival_s, admitted_s=admitted,
                first_token_s=times[i][0], finish_s=times[i][-1],
                token_s=ts))
        return results


def demo_engine(bundle: Bundle, *, slots: int = 4, max_new: int = 16,
                seed: int = 0, scheduler: str = "continuous",
                prefill_chunk: int = 16, policy=None, device="cuda",
                gen: torch.Generator | None = None) -> ServingEngine:
    """The reference's demo engine: random parameters in the model's dtype
    drawn from ``gen`` (a generator on ``device`` seeded ``seed`` when
    None) and an engine over them; ``seed`` also seeds the sampler."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(bundle.params_pspec, gen, bundle.cfg.dtype)
    return ServingEngine(bundle, params, ServeConfig(
        slots=slots, max_new=max_new, seed=seed, scheduler=scheduler,
        prefill_chunk=prefill_chunk, policy=policy))

"""Serving engines over a fixed slot grid, greedy: continuous batching
(default) and the wave scheduler.

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

On a CUDA device each step shape is captured once in a ``torch.cuda.
CUDAGraph`` over the engine's cache tensors (the counterpart of the
reference's jitted block step): a tick is a copy of the inputs into the
graph's static buffers, a replay, and the argmax's one fetch. The graphs
share one memory pool and are captured again only when the cache is
reallocated for another capacity. A capture that fails raises. On the CPU
the same step runs eagerly.

Wave scheduler (``ServeConfig(scheduler="wave")``): requests are admitted in
waves of up to ``slots``; prompts are left-padded to the wave's longest
prompt (one scalar cache position; the padding is attended, as in the
reference); the wave prefills once through ``Bundle.prefill_last``, grows
the KV cache by the wave's budget, and decodes one token per step until
every member has its budget or emitted EOS.

Not ported yet (ROADMAP.md): the paged KV pool, non-greedy sampling, the
obs gauges of the continuous loop, multi-host lockstep.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import cast_tree, init_params
from repro_torch.models.lm import Bundle, build_lm, pad_cache_seq


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4                  # concurrent sequences (static batch)
    max_new: int = 32               # decode budget per request (default)
    eos_token: int = 2
    scheduler: str = "continuous"   # continuous | wave
    prefill_chunk: int = 16         # prompt tokens consumed per tick/slot
    max_context: int | None = None  # cap on ring-cache capacity (rows)
    cache_kind: str = "ring"        # ring (the paged pool is not ported)
    trace_ring: int = 4096          # admit/finish events kept in memory
    # path policy for every core op of the served model; None keeps the
    # bundle's own (the kernels unless the bundle says otherwise)
    policy: str | None = None

    def __post_init__(self):
        if self.scheduler not in ("continuous", "wave"):
            raise ValueError(f"scheduler must be 'continuous' or 'wave', "
                             f"got {self.scheduler!r}")
        if self.cache_kind not in ("ring", "paged"):
            raise ValueError(f"cache_kind must be 'ring' or 'paged', got "
                             f"{self.cache_kind!r}")
        if self.cache_kind == "paged":
            raise NotImplementedError(
                "the paged KV pool is not ported to PyTorch yet (queue 1 of "
                "ROADMAP.md); use cache_kind='ring'")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.trace_ring < 1:
            raise ValueError("trace_ring must be >= 1")


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


def _bucket(n: int) -> int:
    """Next power of two >= n (floor 16): the ring-capacity buckets that
    bound the number of step shapes across mixed-length workloads."""
    return max(16, 1 << (max(int(n), 1) - 1).bit_length())


@dataclasses.dataclass
class _BlockGraph:
    """The block step of ``t_len`` tokens captured over one cache.

    ``host`` (pinned) and ``inputs`` hold the step's inputs packed as (B,
    T + 2) int64: the tokens, then ``n_valid``, then the reset flag.
    ``launches`` is what each replay launches of the counted kernels."""
    t_len: int
    graph: torch.cuda.CUDAGraph
    host: torch.Tensor
    inputs: torch.Tensor
    logits: torch.Tensor
    launches: dict

    @torch.inference_mode()     # the buffers were made under it
    def replay(self, tokens: np.ndarray, n_valid: np.ndarray,
               reset: np.ndarray) -> torch.Tensor:
        # every tick ends with a fetch that waits for the replay, so the
        # previous copy out of ``host`` is done before it is written again
        staged = self.host.numpy()
        staged[:, :self.t_len] = tokens
        staged[:, self.t_len] = n_valid
        staged[:, self.t_len + 1] = reset
        self.inputs.copy_(self.host, non_blocking=True)
        self.graph.replay()
        kops.add_launches(self.launches)
        return self.logits


class ServingEngine:
    """``run(requests)`` drains a list with the configured scheduler and
    returns that call's results sorted by uid (``self.results`` keeps them
    all).

    The parameters are cast to the model's compute dtype once, here (the
    reference casts inside its jitted serving step). ``prefills`` and
    ``decodes`` count the wave's forward passes, ``ticks`` the continuous
    scheduler's block steps."""

    def __init__(self, bundle: Bundle, params, cfg: ServeConfig):
        if cfg.policy is not None and bundle.cfg.policy != cfg.policy:
            bundle = build_lm(dataclasses.replace(bundle.cfg,
                                                  policy=cfg.policy))
        self.bundle = bundle
        self.cfg = cfg
        self.scheduler = cfg.scheduler
        self.params = cast_tree(params, bundle.cfg.dtype)
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
        self._overflow_warned = False   # max_context degrade: warn once
        self._graphs: dict[int, _BlockGraph] = {}   # by T, for this cache
        self._pool = None               # the graphs' shared memory pool
        self._step_shapes: set[tuple[int, int]] = set()
        self.captures = 0
        self.capture_s = 0.0

    # -- shared plumbing ----------------------------------------------------

    @property
    def trace(self) -> list[dict]:
        """The retained admit/finish events, oldest first (bounded by
        ``ServeConfig.trace_ring``)."""
        return list(self._trace)

    def _trace_event(self, tick: int, event: str, uid: int, slot: int,
                     **extra) -> None:
        self._trace.append({"tick": tick, "event": event, "uid": uid,
                            "slot": slot, **extra})

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def compile_stats(self) -> dict:
        """Step shapes of the continuous scheduler: on a CUDA device the
        graphs captured (and the seconds their warm-up and capture took),
        on the CPU the distinct (T, capacity) shapes run."""
        if self.device.type == "cuda":
            return {"block": self.captures, "capture_s": self.capture_s}
        return {"block": len(self._step_shapes), "capture_s": 0.0}

    def _budget(self, req: Request) -> int:
        return self.cfg.max_new if req.max_new is None else req.max_new

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if logits.ndim == 3:            # wave steps emit (B, T, V)
            logits = logits[:, -1]
        return torch.argmax(logits, dim=-1).cpu().numpy()

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
        if self._cache is None or self._capacity != cap:
            self._graphs.clear()        # they were captured over the old one
            pspec = self.bundle.cache_pspec(self.cfg.slots, cap,
                                            per_slot_pos=True)
            gen = torch.Generator(device=self.device)    # zeros draw nothing
            self._cache = init_params(pspec, gen, self.bundle.cfg.dtype)
            self._capacity = cap

    def _eager_step(self, tokens: torch.Tensor, n_valid: torch.Tensor,
                    reset: torch.Tensor) -> torch.Tensor:
        logits, _ = self.bundle.decode_block(
            self.params, self._cache, {"tokens": tokens}, n_valid=n_valid,
            reset_mask=reset)
        return logits

    def _capture(self, t_len: int) -> _BlockGraph:
        """Warm the step up on a side stream, then capture it. The warm-up
        runs with every ``n_valid`` 0, which leaves the cache as it is, and
        builds what cannot be built inside a capture (the kernels' library,
        library handles)."""
        t0 = time.perf_counter()
        nb = self.cfg.slots
        host = torch.zeros((nb, t_len + 2), dtype=torch.int64,
                           pin_memory=True)
        inputs = torch.zeros_like(host, device=self.device)

        def step():
            return self._eager_step(inputs[:, :t_len], inputs[:, t_len],
                                    inputs[:, t_len + 1].bool())

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
        return _BlockGraph(t_len, graph, host, inputs, logits, counted)

    def _block_step(self, tokens: np.ndarray, n_valid: np.ndarray,
                    reset: np.ndarray) -> torch.Tensor:
        """One block step of the scheduler -> logits (B, vocab)."""
        t_len = tokens.shape[1]
        self._step_shapes.add((t_len, self._capacity))
        if self.device.type != "cuda":
            return self._eager_step(torch.from_numpy(tokens),
                                    torch.from_numpy(n_valid),
                                    torch.from_numpy(reset))
        if t_len not in self._graphs:
            self._graphs[t_len] = self._capture(t_len)
        return self._graphs[t_len].replay(tokens, n_valid, reset)

    @torch.inference_mode()
    def _run_continuous(self, t0: float) -> list[Result]:
        nb = self.cfg.slots
        self._ensure_cache()
        chunk = min(self.cfg.prefill_chunk, self._capacity)
        attn = self._cache.get("attn")
        rows = None if attn is None else attn["k"].shape[2]
        if rows is not None and chunk > rows:
            raise ValueError(
                f"prefill_chunk {chunk} exceeds the ring of {rows} rows that "
                f"swa_window={self.bundle.cfg.swa_window} leaves: a block "
                "step writes each of its tokens to its own row (the "
                "reference fails the same step's assertion); set "
                "prefill_chunk <= swa_window")
        slots = [_Slot() for _ in range(nb)]
        out: list[Result] = []

        while True:
            now = time.perf_counter() - t0
            cur = self.ticks
            # admission: refill every free slot from the arrived queue
            reset = np.zeros(nb, bool)
            for i, s in enumerate(slots):
                if not s.free or not self.queue:
                    continue
                if self.queue[0].arrival_s > now:
                    continue
                req = self.queue[0]
                budget = self._budget(req)
                need = len(req.prompt) + budget
                if need > self._capacity:
                    # capacity saturated at max_context: the slot degrades
                    # to sliding-window attention (the ring overwrites its
                    # oldest rows); correct for windowed models, lossy for
                    # full-attention ones
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
                slots[i] = _Slot(
                    free=False, req=req, budget=budget,
                    result=Result(uid=req.uid, tokens=[],
                                  prompt_len=len(req.prompt),
                                  arrival_s=req.arrival_s,
                                  admitted_tick=cur))
                reset[i] = True
                self._trace_event(cur, "admit", req.uid, i, start=0)
            active = [i for i, s in enumerate(slots) if not s.free]
            if not active:
                if not self.queue:
                    break
                wait = self.queue[0].arrival_s - now
                if wait > 0:
                    time.sleep(min(wait, 0.01))
                continue

            # one block step: T = chunk while anyone prefills, else 1
            any_prefill = any(slots[i].ppos < len(slots[i].req.prompt)
                              for i in active)
            t_len = chunk if any_prefill else 1
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
            nxt = self._sample(self._block_step(tokens, n_valid, reset))
            now = time.perf_counter() - t0
            self.ticks = cur + 1

            for i in active:
                s = slots[i]
                plen = len(s.req.prompt)
                if s.ppos < plen:
                    s.ppos += int(n_valid[i])
                    if s.ppos < plen:
                        continue        # mid-prefill: logits are interim
                # this tick produced a real token for slot i
                tok = int(nxt[i])
                s.last = tok
                res = s.result
                if res.first_token_s is None:
                    res.first_token_s = now
                finished = tok == self.cfg.eos_token
                if not finished:
                    res.tokens.append(tok)
                    res.token_s.append(now)
                    finished = len(res.tokens) >= s.budget
                if finished:
                    res.finish_s = now
                    res.finish_tick = cur
                    self._trace_event(cur, "finish", res.uid, i)
                    out.append(res)
                    slots[i] = _Slot()  # freed; refilled next tick
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

    @torch.inference_mode()
    def serve_wave(self, wave: list[Request],
                   t0: float | None = None) -> list[Result]:
        if t0 is None:
            t0 = time.perf_counter()
        nb, live = self.cfg.slots, len(wave)
        budgets = [self._budget(r) for r in wave]
        wave_budget = max(budgets)
        plen = max(len(r.prompt) for r in wave)
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
                arrival_s=r.arrival_s, first_token_s=times[i][0],
                finish_s=times[i][-1], token_s=ts))
        return results

"""Serving engine over a fixed slot grid: the wave scheduler, greedy.

Requests are admitted in waves of up to ``slots``; prompts are left-padded
to the wave's longest prompt (one scalar cache position; the padding is
attended, as in the reference); the wave prefills once through
``Bundle.prefill_last``, grows the KV cache's sequence axis by the wave's
budget, and then decodes one token per step, writing each token's k, v in
place, until every member has its budget or emitted EOS. Sampling is greedy
(argmax). Counterpart of the wave path of ``repro.serving.engine``; the
reference's continuous scheduler and paged cache are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.models.common import cast_tree
from repro_torch.models.lm import Bundle, build_lm, pad_cache_seq


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4                  # concurrent sequences (static batch)
    max_new: int = 32               # decode budget per request (default)
    eos_token: int = 2
    scheduler: str = "wave"         # only the wave scheduler is ported
    # path policy for every core op of the served model; None keeps the
    # bundle's own (the kernels unless the bundle says otherwise)
    policy: str | None = None

    def __post_init__(self):
        if self.scheduler != "wave":
            raise NotImplementedError(
                f"scheduler {self.scheduler!r} is not ported to PyTorch yet "
                "(the continuous scheduler needs lm_decode_block; see "
                "ROADMAP.md); use scheduler='wave'")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")


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


class ServingEngine:
    """``run(requests)`` drains a list with the wave scheduler and returns
    that call's results sorted by uid (``self.results`` keeps them all).

    The parameters are cast to the model's compute dtype once, here (the
    reference casts inside its jitted serving step). ``prefills`` and
    ``decodes`` count the forward passes issued."""

    def __init__(self, bundle: Bundle, params, cfg: ServeConfig):
        if cfg.policy is not None and bundle.cfg.policy != cfg.policy:
            bundle = build_lm(dataclasses.replace(bundle.cfg,
                                                  policy=cfg.policy))
        self.bundle = bundle
        self.cfg = cfg
        self.params = cast_tree(params, bundle.cfg.dtype)
        self.device = self.params["embed"].device
        self.queue: deque[Request] = deque()
        self.results: list[Result] = []
        self.prefills = 0
        self.decodes = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _budget(self, req: Request) -> int:
        return self.cfg.max_new if req.max_new is None else req.max_new

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    def run(self, requests: list[Request]) -> list[Result]:
        t0 = time.perf_counter()
        for r in sorted(requests, key=lambda r: r.arrival_s):
            self.submit(r)
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
        self.results.extend(out)
        return sorted(out, key=lambda r: r.uid)

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

"""A serving cell: ``repro_torch.serving.engine.ServingEngine.run`` on the
continuous scheduler, fed the cell's traffic, with greedy decoding and an
end-of-sequence id that never occurs (every request emits its budget).

Set-up: the model, its weights made on the card from the seed, the engine,
and one warm-up request of the run's largest capacity need, which captures
the two block-step graphs (T = chunk and T = 1) of the capacity bucket the
run uses; it is stopped after its first T = 1 tick.

The harness hooks the engine's block step and sampling, as
``chip_smoke.py::record_ticks`` does: each tick is stamped from the step's
call to the sampled tokens' return, and the admit and finish events say
which request holds which slot, so the harness knows when each request
emits its first token. The run ends from the harness's side, with no
change to the engine: the queue is emptied, every request still in a slot
is given a one-token prompt and the next tick's tokens are the
end-of-sequence id, so every slot finishes in that tick.

End: ``window`` mixes end at the window's close; ``first_token`` mixes end
once every request that arrived in the window has its first token.

Correct: a sample of the requests served, drawn from the seed, with the
longest in it, is run through the plain float32 reference (its prompt and
the served tokens), and each served token's logit is held against the
reference's best at its position; so is the first token of every other
request served (over its prompt alone). The widest gap must stay under
the cell's limit, and every request due in the window must have its
tokens.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.lib import manifest, stats, traffic, weights
from perfbench.lib.records import Records, Tick
from perfbench.lib.trace import Profile

EOS = -1                  # an id the argmax never gives


def program_config(r, cfg: dict):
    """The program's ModelConfig of the configuration file: the arch's FULL
    (or a test's ``r.model_cfg``) with the file's embedding rows and head
    tying; refused where another size differs from the file's."""
    import dataclasses

    from repro_torch import configs
    mcfg = dataclasses.replace(r.model_cfg or configs.get(cfg["arch"]).FULL,
                               vocab=cfg["vocab"],
                               tie_embeddings=cfg["tie_embeddings"])
    keys = ("n_layers", "d_model", "ssm_state", "ssm_head_dim", "ssm_groups",
            "expand", "conv_kernel", "norm_eps")
    got = {k: getattr(mcfg, k) for k in keys}
    want = {k: cfg[k] for k in keys}
    if mcfg.family != cfg["family"] or got != want:
        raise ValueError(f"the program's {mcfg.name} differs from the "
                         f"configuration file: {got} vs {want}")
    return mcfg


class Driver:
    """The harness's hooks on one engine (see the module's docstring)."""

    def __init__(self, engine, prof: Profile, prompt_len: dict):
        self.engine = engine
        self.prof = prof
        self.prompt_len = prompt_len          # uid -> prompt tokens
        self.ticks: list[Tick] = []
        self.first: dict[int, float] = {}     # uid -> first token (clock)
        self.admitted: dict[int, float] = {}  # uid -> admission (clock)
        self.slot = {}                        # slot -> [uid, consumed]
        self.requests: list = []              # the engine's Request objects
        self.on_tick = None                   # (tick) -> True to stop
        self.stopping = False
        self._span = None
        self._cur = None
        self._step, self._sample = engine._block_step, engine._sample
        self._event = engine._trace_event
        engine._block_step = self.block_step
        engine._sample = self.sample
        engine._trace_event = self.trace_event

    def trace_event(self, tick, event, uid, slot, **extra):
        if event == "admit":
            self.slot[slot] = [uid, 0]
            self.admitted[uid] = time.perf_counter()
        elif event == "finish":
            self.slot.pop(slot, None)
        return self._event(tick, event, uid, slot, **extra)

    def block_step(self, inputs):
        Profile.close_span(self._span)
        self._cur = Tick(int(inputs["tokens"].shape[1]), time.perf_counter(),
                         np.array(inputs["n_valid"]),
                         np.array(inputs["reset"]))
        with self.prof.span("step_enqueue"):
            return self._step(inputs)

    def sample(self, logits):
        with self.prof.span("sample_wait"):
            out = self._sample(logits)
        tick, now = self._cur, time.perf_counter()
        tick.end = now
        self.ticks.append(tick)
        if self.stopping:
            self._end_all()
            out = np.full_like(out, EOS)
        else:
            for slot, ent in self.slot.items():
                ent[1] += int(tick.n_valid[slot])
                if ent[1] >= self.prompt_len[ent[0]]:
                    self.first.setdefault(ent[0], now)
            if self.on_tick is not None and self.on_tick(tick):
                # no admission from here on; the next tick ends every slot
                self.engine.queue.clear()
                self.stopping = True
        self._span = self.prof.open_span("scheduler")
        return out

    def _end_all(self) -> None:
        for req in self.requests:
            req.prompt = req.prompt[:1]

    def serve(self, requests, on_tick) -> list:
        """``engine.run`` over ``requests`` until ``on_tick`` says stop."""
        self.requests, self.on_tick, self.stopping = requests, on_tick, False
        try:
            return self.engine.run(requests)
        finally:
            Profile.close_span(self._span)
            self._span = None


def build_engine(r, cfg: dict, cell: dict):
    """(the engine over the seed's weights, the program's ModelConfig) on
    ``r.device``."""
    from repro_torch import models
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    mcfg = program_config(r, cfg)
    bundle = models.build(mcfg)
    if r.device.type == "cuda":
        from repro_torch.kernels import build
        build.load()
    ref = manifest.reference(cfg)
    tree = weights.make(ref.param_specs(cfg), r.seed, mcfg.dtype, r.device)
    params = weights.per_layer(tree, cfg["n_layers"])
    weights.check_layout(params, bundle.params_pspec)
    engine = ServingEngine(bundle, params, ServeConfig(
        slots=cell["slots"], prefill_chunk=cell["prefill_chunk"],
        cache_kind=cell.get("cache", "ring"), eos_token=EOS, greedy=True,
        seed=r.seed))
    return engine, mcfg


def warm_up(driver: Driver, need: int, chunk: int, vocab: int) -> None:
    """One request of ``need`` cache rows: two prompt ticks (T = chunk),
    then one T = 1 tick, then stopped."""
    from repro_torch.serving.engine import Request
    plen = chunk + 1
    driver.prompt_len[-1] = plen
    req = Request(uid=-1, prompt=np.arange(3, 3 + plen) % vocab,
                  max_new=need - plen)
    driver.serve([req], lambda tick: tick.t_len == 1)
    driver.ticks.clear()
    driver.first.clear()
    driver.admitted.clear()


def _requests(reqs):
    from repro_torch.serving.engine import Request
    return [Request(uid=q.uid, prompt=q.prompt.copy(), max_new=q.max_new,
                    arrival_s=q.arrival_s) for q in reqs]


def run(r) -> dict:
    cfg, cell, mix = r.config, r.cell, r.mix
    cuda = r.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    engine, mcfg = build_engine(r, cfg, cell)
    reqs = traffic.make_requests(mix, cell, seconds=r.seconds, seed=r.seed,
                                 vocab=cfg["vocab"])
    prof = Profile(r.trace and cuda)
    driver = Driver(engine, prof, {q.uid: len(q.prompt) for q in reqs})
    if r.fault is not None:
        r.fault(engine)
    warm_up(driver, traffic.capacity_need(reqs), cell["prefill_chunk"],
            cfg["vocab"])
    graphs, capture_s = (engine.compile_stats()[k]
                         for k in ("block", "capture_s"))

    ws_rel = traffic.window_start(mix)
    end_rule = mix["end"]
    window_ids = {q.uid for q in reqs if q.in_window}
    max_drain = float(cell.get("max_drain_s", 60.0))
    obs_marks: dict = {}
    sess = None
    if r.trace:
        from repro_torch.obs import runtime as obs_rt
        sess = obs_rt.ObsSession()
    trace_at = ws_rel + float(cell.get("trace_at", 0.5)) * r.seconds
    trace_ticks = int(cell.get("trace_ticks", 8))
    state = {"t0": None, "traced": 0}

    def phase_sums():
        h = sess.metrics.get("repro_serving_tick_phase_seconds")
        out = {}
        for ph in ("admission", "bookkeep"):
            st = h.stats(phase=ph) if h is not None else None
            out[ph] = (st["sum"], st["count"]) if st else (0.0, 0)
        return out

    def on_tick(tick) -> bool:
        rel = tick.end - state["t0"]
        in_win = ws_rel <= tick.start - state["t0"] \
            and rel <= ws_rel + r.seconds
        tick.in_window = in_win
        if sess is not None:
            for mark, at in (("start", ws_rel), ("end", ws_rel + r.seconds)):
                if mark not in obs_marks and rel >= at:
                    obs_marks[mark] = phase_sums()
        if prof.enabled and state["traced"] == 0 and rel >= trace_at:
            if sess is not None:
                obs_marks["trace_start"] = phase_sums()
            prof.start()
            state["traced"] = 1
        elif state["traced"] == 1:
            tick.profiled = tick.in_slice = True
            if sum(t.in_slice for t in driver.ticks) >= trace_ticks:
                prof.stop()
                state["traced"] = 2
        elif state["traced"] == 2:
            tick.profiled = True     # the tick the stop's sync held up
            state["traced"] = 3
            if sess is not None:
                obs_marks["trace_end"] = phase_sums()
        if rel < ws_rel + r.seconds:
            return False
        if end_rule == "window":
            return True
        done = all(u in driver.first for u in window_ids)
        return done or rel > ws_rel + r.seconds + max_drain

    run_reqs = _requests(reqs)
    setup_s = time.perf_counter() - r.t_start
    if sess is not None:
        from repro_torch.obs import runtime as obs_rt
        ctx = obs_rt.using_obs(sess)
    else:
        import contextlib
        ctx = contextlib.nullcontext()
    with ctx:
        state["t0"] = time.perf_counter()
        results = driver.serve(run_reqs, on_tick)
    driver_end = time.perf_counter()
    if sess is not None and "start" in obs_marks:
        obs_marks.setdefault("end", phase_sums())   # all served early
    t0 = state["t0"]
    if prof.enabled and state["traced"] == 1:
        prof.stop()                  # the run ended inside the slice
        state["traced"] = 2
    captured = engine.compile_stats()["block"] - graphs
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    ws, we = ws_rel, ws_rel + r.seconds
    due = [q for q in reqs if q.in_window] if end_rule == "first_token" \
        else [q for q in reqs if q.uid in driver.first]
    e2e = serve_metrics(due, {res.uid: res.token_s for res in results},
                        ws, we)
    values = dict(e2e["values"], setup_s=setup_s)

    rec = Records(cell=cell, config=cfg, window=(t0 + ws, t0 + we),
                  ticks=driver.ticks,
                  itemsize=torch.empty((), dtype=mcfg.dtype).element_size())
    if sess is not None and {"start", "end"} <= set(obs_marks):
        rec.phases = _phases(obs_marks)
    if prof.enabled and state["traced"] >= 2:
        rec.slice = prof.slice()

    # free the program before the reference runs
    served = {res.uid: list(res.tokens) for res in results}
    del engine, driver, results
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    gap, n_tok = reference_gap(r, cfg, cell, reqs, served)
    checks = [("max_logit_gap", gap, cell["limits"]["max_logit_gap"]),
              ("requests_without_tokens", len(e2e["missing"]), 0),
              ("graphs_captured_in_run", captured, 0)]
    win = rec.window_ticks()
    notes = {"sampled_tokens": n_tok, "served_requests": len(served),
             "window_ticks": {str(t): sum(1 for x in win if x.t_len == t)
                              for t in sorted({x.t_len for x in win})},
             "graphs": graphs, "capture_s": capture_s,
             "emitted_in_window": e2e["emitted"],
             "run_s": driver_end - t0}
    if prof.error:
        notes["trace_error"] = prof.error
    if r.control is not None:
        notes["control_gap"] = reference_gap(r, cfg, cell, reqs, served,
                                             quant=r.control,
                                             served_by_control=True)[0]
    return {"values": values, "records": rec, "checks": checks,
            "attempted": len(due), "failed": len(e2e["missing"]),
            "peak_bytes": peak, "notes": notes}


def serve_metrics(due: list, token_s: dict, ws: float, we: float) -> dict:
    """The end-to-end numbers of a run, on the host clock (seconds from
    the run's start): ``due`` the requests that had to give tokens,
    ``token_s`` each request's emission times. TTFT from each due
    request's scheduled arrival to its first token; every gap between
    consecutive tokens of every request whose later token came after the
    window opened; the tokens emitted inside [ws, we] over its length. A
    due request with no token is missing: it has no TTFT and counts as
    failed."""
    missing = [q.uid for q in due if not token_s.get(q.uid)]
    ttft = [1e3 * (token_s[q.uid][0] - q.arrival_s) for q in due
            if q.uid not in missing]
    itl = [1e3 * (b - a) for ts in token_s.values()
           for a, b in zip(ts, ts[1:]) if b >= ws]
    emitted = sum(1 for ts in token_s.values() for t in ts if ws <= t <= we)
    return {"values": {"ttft_p90_ms": stats.percentile(ttft, 90),
                       "itl_p95_ms": stats.percentile(itl, 95),
                       "serve_tok_s": emitted / (we - ws)},
            "missing": missing, "emitted": emitted}


def _phases(marks: dict) -> dict:
    """Admission and bookkeep seconds and the ticks counted, over the
    window less the profiled slice."""
    def delta(a, b):
        return {ph: (marks[b][ph][0] - marks[a][ph][0],
                     marks[b][ph][1] - marks[a][ph][1])
                for ph in ("admission", "bookkeep")}

    parts = [delta("start", "end")]
    if {"trace_start", "trace_end"} <= set(marks):
        cut = delta("trace_start", "trace_end")
        parts = [{ph: (parts[0][ph][0] - cut[ph][0],
                       parts[0][ph][1] - cut[ph][1]) for ph in cut}]
    p = parts[0]
    return {"admission": p["admission"][0], "bookkeep": p["bookkeep"][0],
            "ticks": p["admission"][1]}


def sample_requests(reqs, served: dict, seed: int, want: int) -> list:
    """Requests with served tokens, drawn from the seed: the one with the
    most tokens first, then others until ``want`` tokens are in."""
    pool = [q for q in reqs if served.get(q.uid)]
    if not pool:
        return []
    longest = max(pool, key=lambda q: len(served[q.uid]))
    rng = np.random.default_rng([seed, 2])
    rest = [pool[i] for i in rng.permutation(len(pool))
            if pool[i].uid != longest.uid]
    out, n = [longest], len(served[longest.uid])
    for q in rest:
        if n >= want:
            break
        out.append(q)
        n += len(served[q.uid])
    return out


def reference_gap(r, cfg: dict, cell: dict, reqs, served: dict,
                  quant: str | None = None, served_by_control=False):
    """(the widest gap by which a served token's reference logit lies below
    the reference's best at its position, the tokens compared): every token
    of the sampled requests (:func:`sample_requests`), the first token of
    every other request served. With ``served_by_control`` the served
    tokens are the ones ``quant``'s reference puts first (the control)."""
    ref = manifest.reference(cfg)
    ref.reference_precision()
    dtype = r.model_cfg.dtype if r.model_cfg is not None \
        else getattr(torch, cfg["dtype"])
    tree = weights.make(ref.param_specs(cfg), r.seed, dtype, r.device)
    sampled = {q.uid for q in sample_requests(reqs, served, r.seed,
                                              cell["sample_tokens"])}
    worst, n_tok = 0.0, 0
    for q in reqs:
        toks = served.get(q.uid)
        if not toks:
            continue
        n = len(toks) if q.uid in sampled else 1
        seq = torch.tensor(np.concatenate([q.prompt, toks[:n - 1]]),
                           dtype=torch.long, device=r.device)
        lg = ref.served_logits(tree, cfg, seq, len(q.prompt) - 1)
        if served_by_control:
            picked = ref.served_logits(tree, cfg, seq, len(q.prompt) - 1,
                                       quant=quant).argmax(-1)
        else:
            picked = torch.tensor(toks[:n], device=r.device)
        gap = lg.max(-1).values - lg.gather(1, picked[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        n_tok += n
    return worst, n_tok

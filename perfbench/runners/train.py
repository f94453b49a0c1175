"""A training cell: ``repro_torch.training.train_lib.make_train_step`` with
AdamW, fed the cell's token batches by a prefetch thread.

Set-up builds one train state (the weights made on the card from the seed,
zero moments) and one step, and drives them through the first three steps
on three different batches of the feed; those steps are read as the
program's side of the check, then the same state and step go on into the
window. The window runs whole steps, each ended by the loss's fetch on the
host, from its start until the first step that ends ``--seconds`` or more
after it.

Correct: after the window, with the program's state freed, the plain
float32 reference takes the same three steps from the same weights and
batches. Compared, each for the worst leaf, leaving out the leaves whose
reference gradient is under a thousandth of the median leaf's: the gap of
the norms of the first gradient as the optimizer took it (clipped; the
program's read back from its first moment after one step, ``m / (1 -
b1)``), and of the norms of the parameters' change after the three steps,
each against the larger of the reference's norm of that leaf and of the
median leaf; and 1 - cos between the program's first gradient and the
reference's, which separates the program from the control where the norms
do not. The relative gap of the three steps' losses is read and printed
but not compared (its readings and why in PERF.md).
"""
from __future__ import annotations

import queue
import statistics
import threading
import time

import numpy as np
import torch

from perfbench.lib import frozen, manifest, weights
from perfbench.lib.records import Records, Step
from perfbench.lib.trace import Profile
from perfbench.runners.serve import program_config

WARM_STEPS = 3            # the steps set-up takes, and the reference follows
COMPARED = ("grad_gap", "change_gap", "grad_dir_gap")


class Feed:
    """Batches of Philox tokens (``frozen.philox_tokens``, a pure function
    of the seed and the step) built in pinned host memory by one prefetch
    thread and moved to the device without blocking the host."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int, device,
                 depth: int = 2):
        self.args = (seed, batch, seq, vocab)
        self.device = device
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self) -> None:
        step = 0
        while not self.stop.is_set():
            tok = torch.from_numpy(batch_tokens(*self.args[:1], step,
                                                *self.args[1:]))
            if self.device.type == "cuda":
                tok = tok.pin_memory()
            while not self.stop.is_set():
                try:
                    self.q.put(tok, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> dict:
        tok = self.q.get().to(self.device, non_blocking=True)
        return {"tokens": tok[:, :-1].contiguous(),
                "labels": tok[:, 1:].contiguous()}

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=10.0)


def batch_tokens(seed: int, step: int, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    return frozen.philox_tokens(seed, step, batch, seq, vocab)


def opt_config(cell: dict):
    from repro_torch.optim import OptConfig
    o = cell["opt"]
    return OptConfig(peak_lr=o["peak_lr"], warmup_steps=o["warmup_steps"],
                     decay_steps=o["decay_steps"],
                     min_lr_ratio=o["min_lr_ratio"], b1=o["b1"], b2=o["b2"],
                     eps=o["eps"], weight_decay=o["weight_decay"],
                     clip_norm=o["clip_norm"], state_dtype=torch.float32)


def build_step(r, cfg: dict, cell: dict):
    """(step, state, program config) of the cell on ``r.device``."""
    from repro_torch import models
    from repro_torch.models.common import stack_pspec
    from repro_torch.optim import init_opt_state
    from repro_torch.training.train_lib import RNG_WORDS, TrainConfig, \
        make_train_step

    mcfg = program_config(r, cfg)
    bundle = models.build(mcfg)
    if r.device.type == "cuda":
        from repro_torch.kernels import build
        build.load()
    ref = manifest.reference(cfg)
    params = weights.make(ref.param_specs(cfg), r.seed, torch.float32,
                          r.device)
    weights.check_layout(params, stack_pspec(bundle.params_pspec))
    opt = opt_config(cell)
    state = {"params": params, "opt": init_opt_state(params, opt),
             "rng": np.array(RNG_WORDS, np.uint32)}
    step = make_train_step(bundle, opt, TrainConfig(
        microbatches=cell.get("microbatches", 1)))
    return step, state, mcfg


def run(r) -> dict:
    cfg, cell = r.config, r.cell
    cuda = r.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step, state, mcfg = build_step(r, cfg, cell)
    if r.fault is not None:
        step = r.fault(step)
    batch, seq = cell["batch"], r.mix["seq_len"]
    tokens = batch * seq
    feed = Feed(r.seed, batch, seq, cfg["vocab"], r.device)
    prof = Profile(r.trace and cuda)
    b1 = cell["opt"]["b1"]
    try:
        prog_loss = []
        for s in range(WARM_STEPS):
            state, m = step(state, feed.next())
            prog_loss.append(float(m["loss"]))
            if s == 0:
                prog_first = [t / (1 - b1) for _, t in
                              weights._leaves(state["opt"]["m"])]
                prog_grad = {"/".join(k): float(t.norm()) for (k, _), t in
                             zip(weights._leaves(state["opt"]["m"]),
                                 prog_first)}
        p0 = weights.make(manifest.reference(cfg).param_specs(cfg), r.seed,
                          torch.float32, r.device)
        prog_change = {"/".join(k): float((a.float() - b).norm())
                       for (k, a), (_, b) in zip(
                           weights._leaves(state["params"]),
                           weights._leaves(p0))}
        del p0
        setup_s = time.perf_counter() - r.t_start

        steps: list[Step] = []
        trace_at = float(cell.get("trace_at", 0.5)) * r.seconds
        trace_steps = int(cell.get("trace_steps", 1))
        traced = 0
        t0 = time.perf_counter()
        while True:
            if prof.enabled and traced == 0 and \
                    time.perf_counter() - t0 >= trace_at:
                prof.start()
                traced = 1
            ts = time.perf_counter()
            with prof.span("data"):
                bt = feed.next()
            with prof.span("step"):
                state, m = step(state, bt)
            with prof.span("loss_fetch"):
                float(m["loss"])
            te = time.perf_counter()
            steps.append(Step(ts, te, tokens, True, traced in (1, 2),
                              traced == 1))
            if traced == 2:
                traced = 3
            elif traced == 1 and sum(s.in_slice for s in steps) >= \
                    trace_steps:
                prof.stop()
                traced = 2
            if te - t0 >= r.seconds:
                break
        if traced == 1:
            prof.stop()
            traced = 2
    finally:
        feed.close()
    window = steps[-1].end - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = Records(cell=cell, config=cfg, window=(t0, steps[-1].end),
                  steps=steps, itemsize=torch.empty(
                      (), dtype=mcfg.dtype).element_size())
    if traced >= 2:
        rec.slice = prof.slice()
    values = {"setup_s": setup_s,
              "train_tok_s": tokens * len(steps) / window}

    del state, step, m, bt
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ref = reference_steps(r, cfg, cell, first=prog_first)
    del prog_first
    numbers = compare(prog_loss, prog_grad, prog_change, ref,
                      ref["direction"])
    lim = cell["limits"]
    checks = [(k, numbers[k], lim[k]) for k in COMPARED]
    return {"values": values, "records": rec, "checks": checks,
            "attempted": WARM_STEPS + len(steps), "failed": 0,
            "peak_bytes": peak, "notes": {
                "window_steps": len(steps), "loss_gap": numbers["loss_gap"],
                "leaves_left_out": numbers["left_out"],
                "trace_error": prof.error}}


def reference_steps(r, cfg: dict, cell: dict, quant: str | None = None,
                    rows: slice | None = None, first: list | None = None,
                    keep_first: bool = False) -> dict:
    """The reference's three steps from the seed's weights and batches:
    losses, the first clipped gradient's norm a leaf, the change's norm a
    leaf; with ``first`` (another side's first gradient, a tensor a leaf)
    each leaf's 1 - cos between it and the reference's (1 where either is
    zero); with ``keep_first`` the reference's own first gradient.
    ``rows`` feeds a part of each batch (a planted fault)."""
    ref = manifest.reference(cfg)
    ref.reference_precision()
    specs = ref.param_specs(cfg)
    tree = weights.make(specs, r.seed, torch.float32, r.device)
    names = ["/".join(p) for p, _ in weights._leaves(tree)]
    leaves = [t.detach().requires_grad_() for _, t in weights._leaves(tree)]
    tree = _rebuild(tree, leaves)
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    out = {"loss": []}
    batch, seq = cell["batch"], r.mix["seq_len"]
    for s in range(WARM_STEPS):
        tok = torch.from_numpy(batch_tokens(r.seed, s, batch, seq,
                                            cfg["vocab"])).to(r.device)
        if rows is not None:
            tok = tok[rows]
        loss = ref.loss(tree, cfg, tok[:, :-1], tok[:, 1:], quant=quant)
        grads = torch.autograd.grad(loss, leaves)
        taken, _ = ref.adamw(leaves, list(grads), m, v, s + 1, cell["opt"])
        out["loss"].append(float(loss.detach()))
        if s == 0:
            out["grad"] = {n: float(g.norm()) for n, g in zip(names, taken)}
            if first is not None:
                out["direction"] = {n: _cos_gap(a, b) for n, a, b in
                                    zip(names, first, taken)}
            if keep_first:
                out["first"] = taken
        del grads, taken, loss
    p0 = weights.make(specs, r.seed, torch.float32, r.device)
    out["change"] = {n: float((a.detach() - b).norm())
                     for n, a, (_, b) in zip(names, leaves,
                                             weights._leaves(p0))}
    return out


def _cos_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    na, nb = float(a.norm()), float(b.norm())
    if na == 0.0 or nb == 0.0:
        return 1.0
    return 1.0 - float(torch.dot(a, b)) / (na * nb)


def _rebuild(tree, leaves: list):
    it = iter(leaves)

    def walk(t):
        return {k: walk(t[k]) for k in sorted(t)} if isinstance(t, dict) \
            else next(it)

    return walk(tree)


def compare(prog_loss: list, prog_grad: dict, prog_change: dict,
            ref: dict, direction: dict) -> dict:
    """The numbers of the module's docstring: the loss gap (read, not
    compared: it has no upper reading, see PERF.md), the worst leaf's gap
    of first-gradient norms, of change norms, and of first-gradient
    direction (``direction``: each leaf's 1 - cos)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog_loss,
                                                       ref["loss"]))
    g_ref = ref["grad"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog_grad[k] - g_ref[k]) / max(g_ref[k], g_med)
                   for k in g_ref)
    kept = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_ref = ref["change"]
    c_med = statistics.median(c_ref[k] for k in kept)
    change_gap = max(abs(prog_change[k] - c_ref[k]) / max(c_ref[k], c_med)
                     for k in kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "grad_dir_gap": max(direction[k] for k in kept),
            "left_out": sorted(set(g_ref) - set(kept))}

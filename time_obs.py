#!/usr/bin/env python3
"""Time the continuous engine's T = 1 tick on one card, with observability
off and on, beside another checkout's engine.

    python3 time_obs.py                 # this checkout: obs off, metrics
                                        # only, metrics and events, in turns
    python3 time_obs.py --other DIR     # and DIR's engine (a checkout, e.g.
                                        # the parent commit unpacked by git
                                        # archive) with obs off, first and
                                        # last

Every run serves ``chip_smoke.py``'s obs workload (llama3.2-1b FULL, bf16,
the paged cache, the eight shared-prefix requests) through
``repro_torch.launch.serve.main`` three times in one process, and reads
the last two: the first pays for the process's first kernel loads. A
tick's host ms is taken from the start of one block step to the start of
the next, as ``chip_smoke.py`` takes it; the first tick of each T (its
graph's capture) and the last tick are left out. The modes:

``off``      no flag: no session, the engine's default
``metrics``  ``--metrics-out``: a session, events kept in its ring only
``events``   ``--metrics-out --obs-events``: the ring and a JSON-lines file

``metrics`` against ``off`` is the instruments' cost, ``events`` against
``metrics`` the file's, and ``off`` against the other checkout's ``off``
the cost of the instrumented code with no session. Each mode also reports
the events emitted in a T = 1 tick and the ticks with no event and with
one or more apart; ``events`` also times one event's write into a
JSON-lines file beside its run's (a ``kv_alloc`` event, 200 emits). Each
run is a process of its own, so that its ``repro_torch`` and its kernel
build are its own; the builds start at once. Prints the card's name and
power limit as ``nvidia-smi`` gives them, a line for each run, then each
version and mode over all its turns: median (min-max, n). Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "obs_time"
MODES = {"off": (), "metrics": ("--metrics-out",),
         "events": ("--metrics-out", "--obs-events")}


@contextlib.contextmanager
def ticks_recorded(serve, make_reqs, starts: list):
    """``serve.main`` serves ``make_reqs()``, and its engine appends (T,
    host clock, events emitted so far) at the start of every block step."""
    try:
        from repro_torch.obs import runtime
    except ImportError:             # a checkout without observability
        runtime = None
    build, make = serve.build_engine, serve.make_requests

    def build_timed(*args, **kw):
        engine = build(*args, **kw)
        step = engine._block_step

        def timed(inputs):
            sess = None if runtime is None else runtime.ACTIVE
            starts.append((inputs["tokens"].shape[1], time.perf_counter(),
                           0 if sess is None else sess.events.emitted))
            return step(inputs)

        engine._block_step = timed
        return engine

    serve.build_engine = build_timed
    serve.make_requests = lambda *args, **kw: make_reqs()
    try:
        yield
    finally:
        serve.build_engine, serve.make_requests = build, make


def t1_ticks(starts: list) -> tuple[list, list]:
    """Host ms and events emitted of each T = 1 tick, start to the next
    tick's start, without the first tick of each T and the last tick."""
    ms, events, seen = [], [], set()
    for (t, t0, e0), (_, t1, e1) in zip(starts, starts[1:]):
        if t in seen and t == 1:
            ms.append(1e3 * (t1 - t0))
            events.append(e1 - e0)
        seen.add(t)
    return ms, events


def worker(src: Path, label: str, mode: str, build_only: bool) -> None:
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    build.load()
    if build_only:
        return
    make_reqs = chip_smoke.shared_prefix_requests()
    out_dir = OUT / label.replace(" ", "_")
    ms, events = [], []
    for rep in range(3):
        shutil.rmtree(out_dir, ignore_errors=True)
        out_dir.mkdir(parents=True)
        argv = list(chip_smoke.OBS_ARGV)
        for flag in MODES[mode]:
            argv += [flag, str(out_dir / flag.strip("-"))]
        starts: list = []
        with ticks_recorded(serve, make_reqs, starts):
            serve.main(argv)
        torch.cuda.synchronize()
        if rep:
            rep_ms, rep_events = t1_ticks(starts)
            ms += rep_ms
            events += rep_events
    emit_us = []
    if mode == "events":
        from repro_torch.obs.events import EventSink

        sink = EventSink(jsonl_path=str(out_dir / "emit_timing.jsonl"))
        for i in range(200):
            t0 = time.perf_counter()
            sink.emit("kv_alloc", slot=i % 4, pages=[i, i + 1],
                      fresh_pages=1, shared_pages=1, prefix_tokens=392)
            emit_us.append(1e6 * (time.perf_counter() - t0))
        sink.close()
    print("TICKS " + json.dumps({"label": label, "mode": mode, "ms": ms,
                                 "events": events, "emit_us": emit_us}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--worker", nargs=3, metavar=("SRC", "LABEL", "MODE"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        src, label, mode = args.worker
        worker(Path(src), label, mode, args.build_only)
        return 0

    import chip_smoke

    print(chip_smoke.smi_line(), flush=True)
    this = ROOT / "src"
    turns = [(this, "this", "off"), (this, "this", "metrics"),
             (this, "this", "events"), (this, "this", "events"),
             (this, "this", "metrics"), (this, "this", "off")]
    if args.other is not None:
        other = (args.other / "src").resolve()
        turns = [(other, "other", "off"), *turns, (other, "other", "off")]

    def cmd(src, label, mode, *extra):
        return [sys.executable, str(Path(__file__).resolve()), "--worker",
                str(src), label, mode, *extra]

    builds = {src: subprocess.Popen(cmd(src, "build", "off", "--build-only"))
              for src in dict.fromkeys(src for src, _, _ in turns)}
    failed = [str(src) for src, p in builds.items() if p.wait()]
    if failed:
        print(f"time_obs: the build failed in {failed}", file=sys.stderr)
        return 1
    merged: dict = {}
    for i, (src, label, mode) in enumerate(turns):
        run = subprocess.run(cmd(src, f"{label} {i}", mode),
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        line = [ln for ln in run.stdout.splitlines()
                if ln.startswith("TICKS ")][-1]
        got = json.loads(line[len("TICKS "):])
        print(f"turn {i}: {label} {mode}: T = 1 tick host ms "
              f"{chip_smoke.ms_text(got['ms'])}; events "
              f"{sum(got['events'])} in {len(got['events'])} ticks",
              flush=True)
        row = merged.setdefault((label, mode), {k: [] for k in got
                                                if isinstance(got[k], list)})
        for k in row:
            row[k] += got[k]
    for (label, mode), row in merged.items():
        n = len(row["events"])
        quiet = [ms for ms, e in zip(row["ms"], row["events"]) if not e]
        busy = [ms for ms, e in zip(row["ms"], row["events"]) if e]
        emit = (f"; one event's emit, us {chip_smoke.ms_text(row['emit_us'])}"
                if row["emit_us"] else "")
        print(f"{label} {mode}: T = 1 tick host ms "
              f"{chip_smoke.ms_text(row['ms'])}; events a tick "
              f"{sum(row['events']) / max(n, 1):.3f}; ticks with no event "
              f"{chip_smoke.ms_text(quiet)}, with events "
              f"{chip_smoke.ms_text(busy)}{emit}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

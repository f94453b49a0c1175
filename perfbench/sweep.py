#!/usr/bin/env python3
"""Find the knee of a serving cell: the highest offered rate it sustains.

    python3 perfbench/sweep.py --workload mamba2-1.3b.chat \\
        --rates 0.55 0.65 0.75 0.85 --seconds 120 --seed 1

One process and one set-up (the model, its weights, the engine and its
graphs), then for each rate an open loop of the cell's traffic at that
rate for ``--seconds``, ended at the close. A rate is sustained while the
slots keep up with it: over the second half of the span, when the slots
are past their ramp, a request that arrives waits for a slot no longer
than two ticks of the block step (the p90 of the waits; a queue that grows
makes them grow without end). Finished requests lag their arrival by
their whole life, up to two minutes here, so a count of them over a short
span reads low even far below capacity; the admissions' count beside the
arrivals' is printed too, but a burst near the close moves it by a tenth.
The knee is the highest sustained rate; the cell runs at four fifths of
it. Prints one JSON line a rate and the knee.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench import run as bench_run  # noqa: E402
from perfbench.lib import manifest, stats, traffic  # noqa: E402
from perfbench.lib.trace import Profile  # noqa: E402
from perfbench.runners import serve  # noqa: E402


def sweep(r, rates: list, seconds: float) -> list:
    cfg, cell = r.config, r.cell
    mix = dict(r.mix, lead_in_s=0.0, end="window")
    engine, _ = serve.build_engine(r, cfg, cell)
    plans = {rate: traffic.make_requests(mix, dict(cell, rate_rps=rate),
                                         seconds=seconds, seed=r.seed,
                                         vocab=cfg["vocab"])
             for rate in rates}
    lens = {q.uid: len(q.prompt) for reqs in plans.values() for q in reqs}
    driver = serve.Driver(engine, Profile(False), lens)
    need = max(traffic.capacity_need(reqs) for reqs in plans.values())
    serve.warm_up(driver, need, cell["prefill_chunk"], cfg["vocab"])
    graphs = engine.compile_stats()["block"]
    out = []
    for rate in rates:
        reqs = plans[rate]
        driver.ticks.clear()
        driver.first.clear()
        driver.admitted.clear()
        start = time.perf_counter()
        results = driver.serve(serve._requests(reqs),
                               lambda tick: tick.end - start >= seconds)
        budget = {q.uid: q.max_new for q in reqs}
        half = seconds / 2
        arrived = [q for q in reqs if half <= q.arrival_s < seconds]
        admitted = [u for u, t in driver.admitted.items()
                    if half <= t - start < seconds]
        waits = [1e3 * (driver.admitted[q.uid] - start - q.arrival_s)
                 for q in arrived if q.uid in driver.admitted]
        done = [res for res in results
                if len(res.tokens) == budget[res.uid]
                and half <= res.finish_s <= seconds]
        ttft = [1e3 * (res.token_s[0] - res.arrival_s) for res in results
                if res.token_s and res.arrival_s >= half]
        ticks = driver.ticks
        t16 = [t for t in ticks if t.t_len > 1]
        out.append({
            "rate_rps": rate, "offered": len(reqs),
            "admitted_rps": len(admitted) / half,
            "admitted_share": len(admitted) / max(1, len(arrived)),
            "queue_wait_ms_p90": stats.percentile(waits, 90),
            "not_admitted_at_close": len(arrived) - len(waits),
            "finished_rps": len(done) / half,
            "ttft_p90_ms_second_half": stats.percentile(ttft, 90),
            "ticks_t16": len(t16),
            "ticks_t1": len(ticks) - len(t16),
            "tick_ms_t16": 1e3 * sum(t.end - t.start for t in t16)
            / max(1, len(t16)),
            "captured": engine.compile_stats()["block"] - graphs})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.benchmark(ROOT)
    r = bench_run.make_run(bench, args.workload, args.seed, args.seconds,
                           False, "cuda", T_START)
    rows = sweep(r, sorted(args.rates), args.seconds)
    held = [row["rate_rps"] for row in rows
            if row["queue_wait_ms_p90"] is not None
            and row["queue_wait_ms_p90"] <= 2 * row["tick_ms_t16"]]
    knee = max(held) if held else None
    print(json.dumps({"knee_rps": knee,
                      "cell_rate_rps": None if knee is None else 0.8 * knee,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100; check it.

    python3 chip_smoke.py

Phases:

1. Header and build: the card's name and power limit as ``nvidia-smi`` gives
   them, then the build of ``src/repro_torch/csrc`` (nvcc, sm_90a) and its
   time, the registers and spills ``nvcc -Xptxas -v`` gave each instance of
   the flash-attention (wgmma), RMSNorm, tensor-core SSD (``ssd_scan``,
   ``local_ssd``), reduce/scan (``piece_totals``, ``piece_scan`` and the
   combine passes) and weighted-scan (``wscan_pass``, ``wscan_fold``,
   ``wscan_carry``) kernels, and flash attention's dynamic shared memory
   per block.
2. Main path, four runs, each with every kernel's launch count set to 0
   just before it and read just after: the public ops (``repro_torch.ops``)
   at 2^24 elements and at the models' shapes, on the linear kernels and
   on the log-depth family (``policy="tile_logdepth"``), where every kernel
   must run, with the linear reduce, scan and weighted scan of 16 rows of
   2^20 held against ``policy="baseline"`` and a mixed-dtype SSD (bf16 x,
   f32 b, c) returning y in bf16 on both families; then the engine of
   ``repro_torch.launch.serve`` serving mamba2-1.3b FULL (48 layers),
   llama3.2-1b FULL (16 layers), and mamba2-1.3b FULL again under
   ``policy="ssd=tile_logdepth"``, random weights from seed 0, to four
   requests of up to 512 prompt tokens, 16 new
   tokens each. Each serve run must show its layer kernel once per layer
   per prefill (48 SSD, 16 flash-attention, 48 local SSD launches, and no
   linear SSD launch in the log-depth run), every SSD launch on the
   tensor-core instance of the chunk body (the served type is bf16), and
   2 x layers + 1 RMSNorm launches per forward (97, 33). Each prefill's
   last-token logits, and the logits of two decode steps from its cache,
   are held against the same model on the kernels' plain versions, and its
   device time is split by kind of kernel with ``torch.profiler``; 15
   decode steps on the host clock against their device time give the
   card's idle share. These three runs use the wave scheduler.
   Then the continuous scheduler (the default): mamba2-1.3b FULL and
   llama3.2-1b FULL, 8 requests of up to 512 prompt tokens and 16 new
   tokens each on 4 slots, chunks of 16, every tick one block step
   replayed from a CUDA graph. A warm-up request of the same capacity
   bucket captures both graphs (T = 16 and T = 1); the measured run must
   capture none, admit and finish 8 requests with at least 4 slot
   refills, give every request tokens, and count 2 x layers + 1 RMSNorm
   launches a tick (a replay adds what its capture counted). One T = 16
   and one T = 1 tick from the graph are held against the eager step on a
   clone of the cache (the same argmax for every active slot);
   ``torch.profiler`` over a replayed tick must show the RMSNorm kernel 2
   x layers + 1 times (97, 33; the largest count of three profiled ticks,
   as the profiler may drop a record) and splits its device time by kind. In
   f32, each request's first-token logits are held against its
   ``prefill_last`` alone (B = 1, on the kernels) and the engine on the
   kernels against the same engine on the plain versions, both within
   1e-3 of the largest logit. Printed: tok/s, TTFT, ticks by T, host ms a
   tick, device ms a tick by kind, the idle share of the T = 1 ticks, the
   capture time, peak memory, and a T = 1 tick alone, graphed and eager.
3. Per kernel: the kernel against its plain version on the card at the main
   path's shapes (the reduce and scan at 2^24 elements from 2^20 rows of 16
   to one row, RMSNorm also at the served decode and prefill shapes,
   the continuous T = 16 tick's 64 rows, flash attention also on its
   D = 128 instance, the SSD scan also at the
   served wave and on a 64-chunk chain, the weighted scan from 65536 rows
   of 256 to one row of 2^24 and in bf16, its local pass also at 16 rows of
   2^20), with the error and its
   tolerance (flash attention row by row, against each output row's RMS),
   the times of the kernel,
   the plain version and one library call where PyTorch has one, and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   the peak rate of the input type, whichever is larger). Then each
   log-depth op whole (local kernel, tree and glue) beside the linear
   kernel's op at the same shapes.
4. A JSON line of the serve runs and whole-op times, a ``kernels`` JSON
   line (launches: the main path's runs, graph replays included), the
   ``nvidia-smi`` line, and last the ``ok`` line.

Exits non-zero and prints no result when there is no CUDA device or no
``src/repro_torch`` beside this script; exits 1 when any phase failed.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_OPS = {"float16": 989e12, "bfloat16": 989e12,   # dense tensor cores
            "float32": 67e12}                          # CUDA cores
N_ELEMS = 1 << 24
SPIN_CAP_MS = 20.0                  # longest spin before a timed launch


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures: list[str] = []
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        # the card's spin rate, so that a spin can be sized in ms
        torch.cuda._sleep(1000)
        start, end = self._events()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 1e7 / start.elapsed_time(end)
        self.spread: dict = {}

    def _events(self):
        return tuple(self.torch.cuda.Event(enable_timing=True)
                     for _ in range(2))

    def fail(self, msg: str) -> None:
        self.failures.append(msg)
        print(f"FAIL {msg}", flush=True)

    def time_ms(self, fn, *, budget_ms: float = 300.0,
                max_iters: int = 20) -> float:
        """Median device time of ``fn`` with a cold L2; its spread over the
        samples is left in ``self.spread``.

        A 64 MB write and a spin on the card precede every timed launch. The
        spin is sized to outlast the host's enqueue of ``fn``, and each
        sample checks that it did: the host must have enqueued all of ``fn``
        before the spin could end, else the event pair may hold host time.
        Such a sample is dropped and the spin doubled, up to SPIN_CAP_MS;
        past that the samples are kept and marked ``host_bound`` (a function
        of thousands of launches fills the launch queue, and then the host
        waits for the card whatever the spin)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        spin_ms = min(SPIN_CAP_MS, max(0.2, 2.0 * host_ms))
        times, dropped, host_bound = [], 0, False
        while len(times) < max_iters:
            self.flush.zero_()
            start, end = self._events()
            t0 = time.perf_counter()
            torch.cuda._sleep(int(spin_ms * self.cycles_per_ms))
            start.record()
            fn()
            end.record()
            enqueue_ms = 1e3 * (time.perf_counter() - t0)
            end.synchronize()
            clean = enqueue_ms < spin_ms
            if not clean and spin_ms < SPIN_CAP_MS:
                dropped += 1
                spin_ms = min(SPIN_CAP_MS, 2.0 * spin_ms)
                continue
            host_bound |= not clean
            times.append(start.elapsed_time(end))
            if len(times) >= 3 and sum(times) > budget_ms:
                break
        self.spread = dict(min=min(times), max=max(times), n=len(times),
                           dropped=dropped, spin_ms=spin_ms,
                           host_bound=host_bound)
        return statistics.median(times)


def ptxas_report(build_log: Path, names=("flash_attention_wgmma_kernel",
                                          "rmsnorm_kernel",
                                          "ssd_scan_mma_kernel",
                                          "local_ssd_mma_kernel",
                                          "piece_totals_kernel",
                                          "piece_scan_kernel",
                                          "tcu_reduce_combine_kernel",
                                          "tcu_scan_carry_kernel",
                                          "wscan_pass_kernel",
                                          "wscan_fold_kernel",
                                          "wscan_carry_kernel")
                 ) -> list[str]:
    """Registers, shared memory and spills that ``nvcc -Xptxas -v`` gave
    each instance of the named kernels, one line per instance."""
    out, cur = [], None
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            cur = mangled if any(n in mangled for n in names) else None
        elif cur and "spill stores" in line:
            spill = line.strip()
        elif cur and "Used" in line and "registers" in line:
            out.append(f"ptxas {cur}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
            cur = None
    return out


def instance_text(instances: dict) -> str:
    """Launches by instance of the SSD chunk body: mma (tensor cores) or
    fma."""
    return ", ".join(f"{k}/{i} {n}" for (k, i), n in
                     sorted(instances.items())) or "none"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# per-kernel cases: (label, inputs, kernel call, plain call, library call,
# tolerance, bytes, ops, input dtype)


def reduce_scan_cases(torch, kops, ref, gen):
    """The 2^24-element cases of both kernels, many short rows to few long
    ones: (dtype, rows, kernels)."""
    out = []
    f16, f32 = torch.float16, torch.float32
    for dtype, rows, kernels in (
            (f16, N_ELEMS // 16, "rs"), (f16, N_ELEMS // 256, "rs"),
            (f16, N_ELEMS // 4096, "rs"), (f32, N_ELEMS // 256, "rs"),
            # few long rows: cut into pieces across the card
            (f32, 16, "rs"), (f32, 1, "r")):
        n = N_ELEMS // rows
        x = torch.randn(rows, n, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        tag = f"{str(dtype).split('.')[-1]} rows={rows} n={n}"
        primary = (dtype, n) == (f16, 256)
        if "r" in kernels:
            out.append(dict(
                kernel="tcu_reduce", label=tag, primary=primary,
                run=lambda x=x: kops.segmented_reduce(x),
                plain=lambda x=x: ref.segmented_reduce_ref(x),
                library=lambda x=x: torch.sum(x, dim=-1,
                                              dtype=torch.float32),
                rtol=2e-4, nbytes=nbytes(x) + 4 * rows, ops=x.numel(),
                dtype=dtype))
        if "s" in kernels:
            out.append(dict(
                kernel="tcu_scan", label=tag, primary=primary,
                run=lambda x=x: kops.segmented_scan(x),
                plain=lambda x=x: ref.segmented_scan_ref(x),
                library=lambda x=x: torch.cumsum(x, dim=-1,
                                                 dtype=torch.float32),
                rtol=1e-3, nbytes=nbytes(x) + 4 * x.numel(), ops=x.numel(),
                dtype=dtype))
    return out


def ssd_inputs(torch, gen, bsz, seqlen, nheads, hdim, ngroups, nstate,
               dtype):
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = rn(bsz, seqlen, nheads, hdim).to(dtype)
    dt = torch.nn.functional.softplus(rn(bsz, seqlen, nheads) - 4.0)
    a = -(1.0 + 15.0 * torch.rand(nheads, generator=gen, device="cuda"))
    b = (rn(bsz, seqlen, ngroups, nstate) / nstate ** 0.5).to(dtype)
    c = (rn(bsz, seqlen, ngroups, nstate) / nstate ** 0.5).to(dtype)
    return x, dt, a, b, c


def ssd_flops(bsz, seqlen, nheads, hdim, nstate, q=64):
    tri = q * (q + 1) // 2
    per_chunk = 2 * (tri * nstate + tri * hdim + 2 * q * nstate * hdim)
    return bsz * nheads * (-(-seqlen // q)) * per_chunk


def ssd_cases(torch, kops, ref, gen):
    out = []
    # mamba2-1.3b FULL prefill: B=4 prompts of 512, 64 heads of 64, N=128;
    # the served wave (left-padded to 468, a ragged last chunk); one
    # sequence of 4096 (a chain of 64 chunks through the two-stage ring);
    # f32 on the FMA instance
    for shape, dtype, primary in (((4, 512, 64, 64, 1, 128), torch.bfloat16,
                                   True),
                                  ((4, 468, 64, 64, 1, 128), torch.bfloat16,
                                   False),
                                  ((1, 4096, 64, 64, 1, 128), torch.bfloat16,
                                   False),
                                  ((2, 300, 8, 64, 2, 128), torch.float32,
                                   False)):
        ins = ssd_inputs(torch, gen, *shape, dtype)
        bsz, seqlen, nheads, hdim, ngroups, nstate = shape
        y_bytes = bsz * seqlen * nheads * hdim * ins[0].element_size()
        st_bytes = bsz * nheads * hdim * nstate * 4
        out.append(dict(
            kernel="ssd_scan", label=f"{str(dtype).split('.')[-1]} "
            f"B={bsz} L={seqlen} H={nheads} P={hdim} G={ngroups} N={nstate}",
            primary=primary,
            run=lambda ins=ins: kops.ssd_scan(*ins, return_state=True),
            plain=lambda ins=ins: ref.ssd_scan_ref(*ins, return_state=True),
            library=None, rtol=8e-3 if dtype == torch.bfloat16 else 2e-3,
            nbytes=nbytes(*ins) + y_bytes + st_bytes,
            ops=ssd_flops(bsz, seqlen, nheads, hdim, nstate), dtype=dtype))
    return out


# the weighted scan's cases: (dtype, rows, n); the ops pass's shape first
WEIGHTED_CASES = (("float32", 64, 4096), ("float32", 65536, 256),
                  ("float32", 16, 1 << 20), ("float32", 1, 1 << 24),
                  ("bfloat16", 16, 1 << 20))


def weighted_cases(torch, kops, ref, gen):
    """weighted_scan.cu from many short rows to one row of 2^24, x and
    log_a in their own dtype, y in f32."""
    out = []
    for dtype, rows, n in WEIGHTED_CASES:
        dt = getattr(torch, dtype)
        x = torch.randn(rows, n, generator=gen, device="cuda").to(dt)
        la = (-0.5 * torch.rand(rows, n, generator=gen, device="cuda")).to(dt)
        out.append(dict(
            kernel="weighted_scan", label=f"{dtype} rows={rows} n={n}",
            primary=(dtype, rows, n) == WEIGHTED_CASES[0],
            run=lambda x=x, la=la: kops.weighted_scan(x, la),
            plain=lambda x=x, la=la: ref.weighted_scan_ref(x, la),
            library=None, rtol=2e-3, nbytes=nbytes(x, la) + 4 * x.numel(),
            # one multiply-add per element (and one exp)
            ops=2 * x.numel(), dtype=dt))
    return out


def local_ssd_flops(bsz, seqlen, nheads, hdim, nstate, q=64):
    """The chunk products without the carried state: C B^T and G X on the
    kept triangle, and the chunk state (B w)^T X."""
    tri = q * (q + 1) // 2
    per_chunk = 2 * (tri * nstate + tri * hdim + q * nstate * hdim)
    return bsz * nheads * (-(-seqlen // q)) * per_chunk


def logdepth_cases(torch, kops, ref, gen):
    """The three local passes of csrc/matmul_scan.cu, each with its block
    size from ``layout.HOPPER`` as the log-depth ops run it."""
    from repro_torch.kernels.layout import HOPPER

    out = []
    bn = HOPPER["scan_logdepth"]["block_n"]
    for dtype, rows, n in ((torch.float16, N_ELEMS // 256, 256),
                           (torch.float32, N_ELEMS // 256, 256),
                           (torch.float32, 16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        out.append(dict(
            kernel="matmul_local_scan",
            label=f"{str(dtype).split('.')[-1]} rows={rows} n={n} "
                  f"block_n={bn}",
            primary=dtype == torch.float16,
            run=lambda x=x: kops.matmul_local_scan(x, bn),
            plain=lambda x=x: ref.local_scan_ref(x, bn),
            library=lambda x=x: torch.cumsum(x.view(x.shape[0], -1, bn), -1,
                                             dtype=torch.float32),
            rtol=1e-3, nbytes=nbytes(x) + 4 * x.numel(), ops=x.numel(),
            dtype=dtype))
    q = HOPPER["weighted_scan_logdepth"]["q"]
    for rows, n in ((64, 4096), (16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda")
        la = -0.5 * torch.rand(rows, n, generator=gen, device="cuda")
        out.append(dict(
            kernel="matmul_local_weighted",
            label=f"f32 rows={rows} n={n} q={q}", primary=rows == 64,
            run=lambda x=x, la=la: kops.matmul_local_weighted(x, la, q),
            plain=lambda x=x, la=la: ref.local_weighted_ref(x, la, q),
            library=None, rtol=1e-4, nbytes=nbytes(x, la) + 4 * x.numel(),
            # one multiply-add per element (and one exp)
            ops=2 * x.numel(), dtype=torch.float32))
    q = HOPPER["ssd_logdepth"]["q"]
    for shape, dtype, primary in (((4, 512, 64, 64, 1, 128), torch.bfloat16,
                                   True),
                                  # the served wave, left-padded to 468
                                  ((4, 468, 64, 64, 1, 128), torch.bfloat16,
                                   False),
                                  ((2, 300, 8, 64, 2, 128), torch.float32,
                                   False)):
        ins = ssd_inputs(torch, gen, *shape, dtype)
        bsz, seqlen, nheads, hdim, ngroups, nstate = shape
        y_bytes = 4 * bsz * seqlen * nheads * hdim
        s_bytes = 4 * bsz * nheads * (-(-seqlen // q)) * nstate * hdim
        out.append(dict(
            kernel="matmul_local_ssd", label=f"{str(dtype).split('.')[-1]} "
            f"B={bsz} L={seqlen} H={nheads} P={hdim} G={ngroups} N={nstate}"
            f" q={q}", primary=primary,
            run=lambda ins=ins: kops.matmul_local_ssd(*ins, q),
            plain=lambda ins=ins: ref.local_ssd_ref(*ins, q), library=None,
            # both sides compute in f32 from the same inputs and write f32
            rtol=1e-4, nbytes=nbytes(*ins) + y_bytes + s_bytes,
            ops=local_ssd_flops(bsz, seqlen, nheads, hdim, nstate, q),
            dtype=dtype))
    return out


def rmsnorm_cases(torch, kops, ref, gen):
    import torch.nn.functional as F

    out = []
    # the ops pass's shapes, then the served ones: a decode step's 4 rows
    # (llama d 2048, mamba's inner norm d 4096; the continuous T = 1 tick),
    # the continuous T = 16 tick's 64 rows, and the wave mamba prefill's
    # 1872 rows (4 x 468)
    for rows, d in ((2048, 2048), (2048, 4096), (4, 2048), (4, 4096),
                    (64, 2048), (64, 4096), (1872, 2048), (1872, 4096)):
        x = torch.randn(rows, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
            torch.bfloat16)
        lib = (lambda x=x, w=w, d=d: F.rms_norm(x, (d,), w, eps=1e-5)) \
            if hasattr(F, "rms_norm") else None
        out.append(dict(
            kernel="rmsnorm", label=f"bf16 rows={rows} d={d}",
            primary=(rows, d) == (2048, 4096),
            run=lambda x=x, w=w: kops.rmsnorm(x, w, eps=1e-5),
            plain=lambda x=x, w=w: ref.rmsnorm_ref(x, w, eps=1e-5),
            library=lib, rtol=1e-2, nbytes=2 * nbytes(x) + nbytes(w),
            ops=4 * x.numel(), dtype=torch.bfloat16))
    return out


def attention_pairs(lq, lk, causal, window):
    """(query, key) pairs the mask leaves visible, ends aligned by lk - lq:
    the work this input needs, not the full lq x lk."""
    total = 0
    for i in range(lq):
        qpos = i + lk - lq
        hi = min(lk, qpos + 1) if causal else lk
        lo = max(0, qpos - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def row_rel_err(got, want) -> float:
    """Largest error in any output row over that row's RMS in ``want``, so
    that an error confined to late rows, whose values are small, counts as
    much as one in the first rows."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / rms).max().item()


def attention_gate(kops, q, k, v, causal, window):
    """Holds the kernel's output against the plain version run in f32 on the
    same inputs, row by row (``row_rel_err``). f16/bf16: within twice the
    plain version's own distance from that f32 run; both round the output
    once, and the kernel also rounds P before P V, which puts it at 1.0 to
    1.35 times the plain version's distance (CPU emulation over the test
    shapes). f32: within 1e-4; three-part bf16 operands and f32 sums leave
    3e-5 on an H100."""
    def plain(*ts):
        return kops.attention_plain(*ts, causal=causal, window=window)

    def gate(got):
        want = plain(q.float(), k.float(), v.float())
        tol = (1e-4 if q.element_size() == 4 else
               2.0 * row_rel_err(plain(q, k, v), want))
        return dict(errs=[row_rel_err(got, want)], tols=[tol],
                    max_abs_err=(got.float() - want).abs().max().item(),
                    measure="row-relative, against the plain version in f32")
    return gate


def attention_cases(torch, kops, gen):
    import torch.nn.functional as F

    gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    out = []
    for (bsz, lq, lk, hq, hkv, dh, causal, window, dtype, primary) in (
            (4, 512, 512, 32, 8, 64, True, None, torch.bfloat16, True),
            # the served wave: left-padded to 468, a ragged tail tile
            (4, 468, 468, 32, 8, 64, True, None, torch.bfloat16, False),
            (1, 4096, 4096, 32, 8, 64, True, None, torch.bfloat16, False),
            (1, 4096, 4096, 32, 8, 64, True, 1024, torch.bfloat16, False),
            # the kernel's D = 128 instance
            (4, 512, 512, 32, 8, 128, True, None, torch.bfloat16, False),
            (1, 100, 1000, 4, 2, 64, True, None, torch.float32, False)):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        q, k, v = rn(bsz, lq, hq, dh), rn(bsz, lk, hkv, dh), rn(bsz, lk, hkv,
                                                               dh)
        # the library call: torch's SDPA in its (B, H, S, D) layout, with
        # the same mask (bottom-right aligned, window) where is_causal's
        # top-left alignment or the window differ; K/V repeated outside the
        # timed call where this torch has no enable_gqa
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if not gqa:
            kt, vt = (t.repeat_interleave(hq // hkv, dim=1) for t in (kt, vt))
        mask = None
        if lq != lk or window is not None:
            qpos = torch.arange(lq, device="cuda")[:, None] + (lk - lq)
            kpos = torch.arange(lk, device="cuda")[None, :]
            mask = kpos <= qpos if causal else torch.ones_like(kpos > qpos)
            if window is not None:
                mask &= kpos > qpos - window
        kw = {"enable_gqa": True} if gqa else {}

        def lib(qt=qt, kt=kt, vt=vt, mask=mask, kw=kw, causal=causal):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, **kw)

        pairs = attention_pairs(lq, lk, causal, window)
        tag = (f"{str(dtype).split('.')[-1]} B={bsz} Lq={lq} Lk={lk} "
               f"Hq={hq} Hkv={hkv} D={dh} causal={causal} window={window}")
        out.append(dict(
            kernel="flash_attention", label=tag, primary=primary,
            run=lambda q=q, k=k, v=v, c=causal, w=window: kops.attention(
                q, k, v, causal=c, window=w),
            plain=lambda q=q, k=k, v=v, c=causal, w=window:
                kops.attention_plain(q, k, v, causal=c, window=w),
            library=lib, gate=attention_gate(kops, q, k, v, causal, window),
            nbytes=nbytes(q, k, v) + nbytes(q),
            ops=4 * dh * pairs * bsz * hq, dtype=dtype))
    return out


def max_err(got, want):
    """(max abs error, max |want|) over every output tensor."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    scales = [w.float().abs().max().item() for w in want]
    return errs, scales


def check_kernels(smoke: Smoke, kops, ref) -> dict:
    """Each kernel against its plain version; returns per-kernel rows."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = (reduce_scan_cases(torch, kops, ref, gen)
             + ssd_cases(torch, kops, ref, gen)
             + weighted_cases(torch, kops, ref, gen)
             + rmsnorm_cases(torch, kops, ref, gen)
             + attention_cases(torch, kops, gen)
             + logdepth_cases(torch, kops, ref, gen))
    rows: dict[str, dict] = {}
    for case in cases:
        name = case["kernel"]
        try:
            got = case["run"]()
            torch.cuda.synchronize()
            if "gate" in case:
                g = case["gate"](got)
                errs, tols, abs_err = g["errs"], g["tols"], g["max_abs_err"]
                measure = g["measure"]
            else:
                errs, scales = max_err(got, case["plain"]())
                tols = [case["rtol"] * max(1.0, s) for s in scales]
                abs_err, measure = max(errs), "abs"
            ok = all(e <= t for e, t in zip(errs, tols))
            ms = smoke.time_ms(case["run"])
            spread = smoke.spread
            plain_ms = smoke.time_ms(case["plain"], max_iters=5)
            plain_spread = smoke.spread
            lib_ms = (smoke.time_ms(case["library"])
                      if case["library"] is not None else None)
            lib_bound = lib_ms is not None and smoke.spread["host_bound"]
        except Exception as exc:  # a phase that raises is a failed phase
            smoke.fail(f"{name} [{case['label']}]: {exc!r}")
            continue
        bound_ms, bound_by = bound(case["nbytes"], case["ops"],
                                   case["dtype"])
        rec = dict(label=case["label"], max_abs_err=abs_err, err=max(errs),
                   tol=max(tols), measure=measure, ms=ms,
                   ms_spread=spread, plain_ms=plain_ms,
                   plain_ms_spread=plain_spread, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        print(f"kernel {name} [{case['label']}]: err ({measure})="
              f"{[f'{e:.3e}' for e in errs]} tol={[f'{t:.3e}' for t in tols]}"
              f" max_abs_err={abs_err:.3e} ms={ms:.4f} (min "
              f"{spread['min']:.4f} max {spread['max']:.4f} n={spread['n']}"
              f"{' HOST-BOUND' if spread['host_bound'] else ''}) "
              f"plain_ms={plain_ms:.4f}"
              f"{' HOST-BOUND' if plain_spread['host_bound'] else ''} "
              f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'}"
              f"{' HOST-BOUND' if lib_bound else ''} "
              f"bound_ms={bound_ms:.4f} ({bound_by})"
              f"{'' if ok else '  <-- OUT OF TOLERANCE'}", flush=True)
        if not ok:
            smoke.fail(f"{name} [{case['label']}] disagrees with its plain "
                       f"version: {errs} > {tols} ({measure})")
        row = rows.setdefault(name, {"cases": []})
        row["cases"].append(rec)
        if case["primary"]:
            row.update({k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "bound_by")})
    return rows


def compare_whole_ops(smoke: Smoke, ops, ref) -> list[dict]:
    """Each log-depth op whole (local kernel, tree and glue) beside the
    linear kernel's op and, for the scan, ``torch.cumsum``, at the shapes of
    the local-kernel cases; the log-depth op is held against the plain
    version of the whole op."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dtype, rows, n in ((torch.float16, N_ELEMS // 256, 256),
                           (torch.float32, N_ELEMS // 256, 256),
                           (torch.float32, 16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        cases.append((f"scan {str(dtype).split('.')[-1]} rows={rows} n={n}",
                      lambda p, x=x: ops.scan(x, policy=p),
                      lambda x=x: ref.segmented_scan_ref(x),
                      lambda x=x: torch.cumsum(x, -1, dtype=torch.float32),
                      1e-3))
    for rows, n in ((64, 4096), (16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda")
        la = -0.5 * torch.rand(rows, n, generator=gen, device="cuda")
        cases.append((f"weighted_scan f32 rows={rows} n={n}",
                      lambda p, x=x, la=la: ops.weighted_scan(x, la,
                                                              policy=p),
                      lambda x=x, la=la: ref.weighted_scan_ref(x, la), None,
                      2e-3))
    for shape, dtype in (((4, 512, 64, 64, 1, 128), torch.bfloat16),
                         ((4, 468, 64, 64, 1, 128), torch.bfloat16),
                         ((2, 300, 8, 64, 2, 128), torch.float32)):
        ins = ssd_inputs(torch, gen, *shape, dtype)
        cases.append((
            f"ssd {str(dtype).split('.')[-1]} B={shape[0]} L={shape[1]} "
            f"H={shape[2]} P={shape[3]} G={shape[4]} N={shape[5]}",
            lambda p, ins=ins: ops.ssd(*ins, policy=p, return_state=True),
            lambda ins=ins: ref.ssd_scan_ref(*ins, return_state=True), None,
            8e-3 if dtype == torch.bfloat16 else 2e-3))
    out = []
    for label, run, plain, library, rtol in cases:
        try:
            errs, scales = max_err(run("tile_logdepth"), plain())
            tols = [rtol * max(1.0, sc) for sc in scales]
            times = {}
            for key, fn in (("logdepth", lambda: run("tile_logdepth")),
                            ("linear", lambda: run("tile")),
                            ("library", library)):
                if fn is not None:
                    times[key] = (smoke.time_ms(fn),
                                  smoke.spread["host_bound"])
        except Exception as exc:  # a phase that raises is a failed phase
            smoke.fail(f"whole op [{label}]: {exc!r}")
            continue
        ok = all(e <= t for e, t in zip(errs, tols))
        rec = dict(label=label, max_abs_err=max(errs), tol=max(tols),
                   **{f"{k}_ms": v[0] for k, v in times.items()},
                   host_bound=[k for k, v in times.items() if v[1]])
        rec.setdefault("library_ms", None)
        out.append(rec)
        lib, host = rec["library_ms"], rec["host_bound"]
        print(f"whole op [{label}]: tile_logdepth {rec['logdepth_ms']:.4f} "
              f"ms, linear tile {rec['linear_ms']:.4f} ms, library "
              f"{'null' if lib is None else f'{lib:.4f}'} ms; log-depth vs "
              f"plain max_abs_err={max(errs):.3e} (tol {max(tols):.3e})"
              f"{f' HOST-BOUND {host}' if host else ''}"
              f"{'' if ok else '  <-- OUT OF TOLERANCE'}", flush=True)
        if not ok:
            smoke.fail(f"whole op [{label}] under tile_logdepth disagrees "
                       f"with the plain version: {errs} > {tols}")
    return out


# ---------------------------------------------------------------------------
# main path


def ops_pass(smoke: Smoke, ops, ref):
    """The public ops once each, at the sizes the paper and the model use,
    on the default kernels and under ``tile_logdepth``."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(N_ELEMS // 256, 256, generator=gen, device="cuda").half()
    red = ops.reduce(x)
    sc = ops.scan(x, exclusive=True)
    la = -0.5 * torch.rand(64, 4096, generator=gen, device="cuda")
    ws_x = torch.randn(64, 4096, generator=gen, device="cuda")
    ws = ops.weighted_scan(ws_x, la)
    h = torch.randn(2048, 2048, generator=gen, device="cuda").bfloat16()
    nrm = ops.rmsnorm(h, torch.ones(2048, device="cuda",
                                    dtype=torch.bfloat16), eps=1e-5)
    ssd_in = ssd_inputs(torch, gen, 4, 512, 64, 64, 1, 128, torch.bfloat16)
    y, st = ops.ssd(*ssd_in, return_state=True)
    att = ops.attention(*(torch.randn(4, 512, h, 64, generator=gen,
                                      device="cuda").bfloat16()
                          for h in (32, 8, 8)))
    # the log-depth family on the same inputs, and on one long row, where
    # the linear scan's carry walks 4096 blocks in order
    ld = "tile_logdepth"
    ld_sc = ops.scan(x, exclusive=True, policy=ld)
    long_row = torch.randn(16, 1 << 20, generator=gen, device="cuda")
    ld_long = ops.scan(long_row, policy=ld)
    long_la = -0.5 * torch.rand(16, 1 << 20, generator=gen, device="cuda")
    ws_long = ops.weighted_scan(long_row, long_la)
    ld_ws = ops.weighted_scan(ws_x, la, policy=ld)
    ld_y, ld_st = ops.ssd(*ssd_in, policy=ld, return_state=True)
    torch.cuda.synchronize()
    for name, t, shape in (("reduce", red, (N_ELEMS // 256,)),
                           ("scan", sc, (N_ELEMS // 256, 256)),
                           ("weighted_scan", ws, (64, 4096)),
                           ("weighted_scan long row", ws_long,
                            (16, 1 << 20)),
                           ("rmsnorm", nrm, (2048, 2048)),
                           ("ssd.y", y, (4, 512, 64, 64)),
                           ("ssd.state", st, (4, 64, 64, 128)),
                           ("attention", att, (4, 512, 32, 64)),
                           ("scan[tile_logdepth]", ld_sc,
                            (N_ELEMS // 256, 256)),
                           ("scan[tile_logdepth] long row", ld_long,
                            (16, 1 << 20)),
                           ("weighted_scan[tile_logdepth]", ld_ws,
                            (64, 4096)),
                           ("ssd[tile_logdepth].y", ld_y, (4, 512, 64, 64)),
                           ("ssd[tile_logdepth].state", ld_st,
                            (4, 64, 64, 128))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            smoke.fail(f"ops.{name}: shape {tuple(t.shape)} (want {shape})"
                       " or non-finite values")
    for name, t in (("scan", sc), ("scan[tile_logdepth]", ld_sc)):
        if t[:, 0].abs().max().item() != 0.0:
            smoke.fail(f"ops.{name}(exclusive=True) does not start at 0")
    # the linear kernels on the long row, where each row is cut into pieces
    # across the card, against torch.sum / torch.cumsum and the weighted
    # scan's plain version
    base = "baseline"
    for name, got, want, rtol in (
            ("reduce", ops.reduce(long_row), ops.reduce(long_row,
                                                        policy=base), 2e-4),
            ("scan", ops.scan(long_row), ops.scan(long_row, policy=base),
             1e-3),
            ("weighted_scan", ws_long,
             ops.weighted_scan(long_row, long_la, policy=base), 2e-3)):
        err = (got - want).abs().max().item()
        tol = rtol * max(1.0, want.abs().max().item())
        if got.shape != want.shape or not err <= tol:
            smoke.fail(f"ops.{name} long row: tile and baseline differ by "
                       f"{err} (tol {tol})")
    # mixed dtypes: bf16 x with f32 b, c computes in f32 and returns y in
    # x's dtype, on both families, as the plain version does
    mx, mdt, ma, mb, mc = ssd_inputs(torch, gen, 2, 130, 4, 64, 1, 128,
                                     torch.float32)
    mx = mx.bfloat16()
    my_ref = ref.ssd_scan_ref(mx, mdt, ma, mb, mc)
    for p in ("tile", ld):
        my = ops.ssd(mx, mdt, ma, mb, mc, policy=p)
        err = (my.float() - my_ref.float()).abs().max().item()
        if my.dtype != torch.bfloat16 or not err <= 1e-2 * max(
                1.0, my_ref.float().abs().max().item()):
            smoke.fail(f"ops.ssd[{p}] mixed dtypes: y {my.dtype} (want "
                       f"bfloat16), max_abs_err {err}")
    # the two families on the same inputs: the same function, summed in
    # another order (the SSD output rounds to bf16 once on each side)
    for name, got, want, rtol in (
            ("scan", ld_sc, sc, 1e-3),
            ("scan long row", ld_long,
             ops.scan(long_row, policy="baseline"), 1e-3),
            ("weighted_scan", ld_ws, ws, 2e-3), ("ssd.y", ld_y, y, 8e-3),
            ("ssd.state", ld_st, st, 2e-3)):
        err = (got.float() - want.float()).abs().max().item()
        tol = rtol * max(1.0, want.float().abs().max().item())
        if not err <= tol:
            smoke.fail(f"ops.{name}: tile_logdepth and tile differ by {err}"
                       f" (tol {tol})")


KINDS = ("flash_attention", "ssd_scan", "local_ssd", "rmsnorm", "gemm")


def kernel_events(torch, fn) -> list | None:
    """(name, launches, device ms) of each kernel that one call of ``fn``
    runs, from ``torch.profiler``'s kernel events (a CUDA graph's replayed
    kernels among them); None when the profiler fails here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except RuntimeError as exc:
        print(f"profiler: {exc!r}", flush=True)
        return None
    # kernels only: a host op's device time repeats them
    return [(e.key, e.count, getattr(e, "self_device_time_total", getattr(
        e, "self_cuda_time_total", 0.0)) / 1e3)
        for e in events if e.device_type == DeviceType.CUDA]


def split_by_kind(events) -> dict | None:
    """Device ms of ``kernel_events`` by kind of kernel: this repository's
    kernels by name, matrix products (cuBLAS/CUTLASS kernels) as ``gemm``,
    the rest as ``other``. A diagnostic: None, printed as not measured,
    when the profiler saw no device time."""
    split = dict.fromkeys((*KINDS, "other"), 0.0)
    for name, _, ms in events or ():
        name = name.lower()
        kind = next((k for k in KINDS if k in name), None)
        if kind is None and any(t in name for t in ("gemm", "xmma",
                                                     "cutlass", "nvjet")):
            kind = "gemm"
        split[kind or "other"] += max(ms, 0.0)
    if sum(split.values()) <= 0:
        return None
    return {k: round(v, 4) for k, v in split.items()}


def device_split(torch, fn) -> dict | None:
    """Device time of one call of ``fn`` by kind of kernel."""
    return split_by_kind(kernel_events(torch, fn))


# the runs of the served main path, each with its counts read on their own:
# (model, policy, the kernel it runs once per layer per prefill, a kernel
# the run must not launch)
SERVED = (("mamba2-1.3b", None, "ssd_scan", "matmul_local_ssd"),
          ("llama3.2-1b", None, "flash_attention", None),
          ("mamba2-1.3b", "ssd=tile_logdepth", "matmul_local_ssd",
           "ssd_scan"))


def serve_pass(smoke: Smoke, serve, kops, arch: str, policy: str | None,
               per_layer: str, absent: str | None):
    """``arch`` FULL through the serving engine under ``policy``; returns
    its numbers."""
    from repro_torch.models import build_lm
    from repro_torch.models.common import cast_tree
    from repro_torch.models.lm import pad_cache_seq

    torch = smoke.torch
    engine = serve.build_engine(arch, "full", device="cuda", policy=policy,
                                slots=4, max_new=16, scheduler="wave",
                                seed=0)
    cfg = engine.bundle.cfg
    print(f"serve: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"{engine.bundle.n_params / 1e9:.3f}B params {cfg.dtype}, "
          f"policy={policy}, scheduler=wave, 4 slots", flush=True)
    # warm-up: one short request (cuBLAS handles, allocator)
    engine.run(serve.make_requests(1, 16, cfg.vocab, seed=1))
    reqs = serve.make_requests(4, 512, cfg.vocab, seed=0)
    for r in reqs:
        r.max_new = 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.prefills = engine.decodes = 0
    kops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    instances = kops.instance_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(r.tokens) for r in results)
    first = min(r.first_token_s for r in results)
    last = max(r.finish_s for r in results)
    stats = dict(
        requests=len(results), prompt_lens=[r.prompt_len for r in results],
        tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
        first_token_s=first,
        decode_ms_per_token=(1e3 * (last - first) / max(engine.decodes, 1)),
        prefills=engine.prefills, decodes=engine.decodes,
        peak_mem_gb=peak_gb, launches=counts)
    print(f"serve: {len(results)} requests, prompt lens "
          f"{stats['prompt_lens']}, {n_tok} tokens in {wall:.3f}s "
          f"({stats['tok_per_s']:.2f} tok/s), first token at "
          f"{1e3 * first:.1f} ms, decode {stats['decode_ms_per_token']:.2f} "
          f"ms/step, peak memory {peak_gb:.2f} GB", flush=True)
    print(f"serve: launches {counts} over {engine.prefills} prefill(s) and "
          f"{engine.decodes} decode step(s); SSD instances "
          f"{instance_text(instances)}", flush=True)
    fma = {k: n for (k, i), n in instances.items() if i == "fma"}
    if fma:
        smoke.fail(f"serve: {fma} SSD launches on the FMA instance, want "
                   f"every {cfg.dtype} launch on the tensor cores")
    if any(len(r.tokens) == 0 for r in results):
        smoke.fail("serve: a request produced no tokens")
    want_layer = cfg.n_layers * engine.prefills
    want_norm = (2 * cfg.n_layers + 1) * (engine.prefills + engine.decodes)
    if counts[per_layer] != want_layer or engine.prefills < 1:
        smoke.fail(f"serve: {counts[per_layer]} {per_layer} launches, want "
                   f"{want_layer} ({cfg.n_layers} per prefill)")
    if absent is not None and counts[absent]:
        smoke.fail(f"serve: {counts[absent]} {absent} launches under "
                   f"policy {policy!r}, want 0")
    if counts["rmsnorm"] < want_norm:
        smoke.fail(f"serve: {counts['rmsnorm']} RMSNorm launches, want >= "
                   f"{want_norm} ({2 * cfg.n_layers + 1} per forward)")

    # prefill, kernels against plain versions, on the served wave's batch
    plen = max(r.prompt_len for r in results)
    tokens = torch.zeros((4, plen), dtype=torch.long)
    for i, r in enumerate(reqs):
        tokens[i, plen - len(r.prompt):] = torch.from_numpy(
            r.prompt.astype("int64"))
    batch = {"tokens": tokens.cuda()}

    params_by_dtype = {}

    def model(path, dtype):
        if dtype not in params_by_dtype:
            params_by_dtype[dtype] = cast_tree(engine.params, dtype)
        bundle = build_lm(dataclasses.replace(cfg, policy=path, dtype=dtype))
        return bundle, params_by_dtype[dtype]

    def prefill_fn(path, dtype):
        bundle, params = model(path, dtype)
        return lambda: bundle.prefill_last(params, batch)[0].float()

    def decoded(path, steps=2):
        """Logits of ``steps`` f32 decode steps from the prefill's cache:
        the state handed from prefill to decode is in them."""
        bundle, params = model(path, torch.float32)
        _, cache = bundle.prefill_last(params, batch)
        cache = pad_cache_seq(cache, steps)
        for _ in range(steps):
            logits, cache = bundle.decode(
                params, cache, {"tokens": batch["tokens"][:, -1:]})
        return logits.float()

    kern_bf16 = prefill_fn(policy, torch.bfloat16)
    plain_bf16 = prefill_fn("baseline", torch.bfloat16)
    prefill_ms = smoke.time_ms(kern_bf16, max_iters=5)
    prefill_spread = smoke.spread
    plain_prefill_ms = smoke.time_ms(plain_bf16, max_iters=3)
    split = device_split(torch, kern_bf16)
    got, want = kern_bf16(), plain_bf16()
    # the same weights in f32 on both paths: kernels and plain versions
    # agree to about 1e-6 per op, so every layer stack of the port stays
    # within 1e-3 of the largest logit
    got32 = prefill_fn(policy, torch.float32)()
    want32 = prefill_fn("baseline", torch.float32)()
    err32 = (got32 - want32).abs().max().item()
    tol32 = 1e-3 * want32.abs().max().item()
    dec_got, dec_want = decoded(policy), decoded("baseline")
    params_by_dtype.pop(torch.float32)
    dec_err = (dec_got - dec_want).abs().max().item()
    dec_tol = 1e-3 * dec_want.abs().max().item()
    # bf16: every norm and every SSD or attention output of a forward
    # rounds to bf16, and the two paths may round a value one ulp apart. The
    # bf16 tolerance is the bf16 error of the plain path itself, measured
    # against its f32 run, twice over: two bf16 results each that far from
    # the f32 one are at most twice that far apart.
    noise = (want - want32).abs().max().item()
    err = (got - want).abs().max().item()
    tol = 2.0 * noise
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"serve: prefill B=4 L={plen}: {prefill_ms:.2f} ms on the kernels "
          f"(device time; min {prefill_spread['min']:.2f} max "
          f"{prefill_spread['max']:.2f}"
          f"{', HOST-BOUND' if prefill_spread['host_bound'] else ''}), "
          f"{plain_prefill_ms:.2f} ms on the plain versions; device time by "
          f"kind (torch.profiler, one prefill): "
          f"{split if split else 'not measured'}", flush=True)
    print(f"serve: last-token logits, kernels vs plain versions: f32 "
          f"max_abs_err={err32:.4e} (tol {tol32:.4e}); bf16 max_abs_err="
          f"{err:.4e} (tol {tol:.4e} = 2 x the plain bf16 run's distance "
          f"from f32); kernels bf16 vs plain f32 "
          f"{(got - want32).abs().max().item():.4e}; max |logit| "
          f"{want32.abs().max().item():.3f}; argmax agreement {agree:.2f}; "
          f"f32 logits after 2 decode steps from the prefill's cache "
          f"max_abs_err={dec_err:.4e} (tol {dec_tol:.4e})", flush=True)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(got32).all()
                  and torch.isfinite(dec_got).all())
    if not (err32 <= tol32 and err <= tol and dec_err <= dec_tol
            and finite):
        smoke.fail(f"serve: logits disagree with the plain model: prefill "
                   f"f32 {err32} (tol {tol32}), bf16 {err} (tol {tol}); "
                   f"decode f32 {dec_err} (tol {dec_tol})")
    # decode steps of the served model, each on the host clock, against the
    # device time of their kernels: the card's idle share during decode
    n_steps, n_prof = 15, 5
    _, cache = engine.bundle.prefill_last(engine.params, batch)
    cache = pad_cache_seq(cache, 1 + n_steps + n_prof)
    step = {"tokens": batch["tokens"][:, -1:]}

    def decode():
        engine.bundle.decode(engine.params, cache, step)

    decode()
    torch.cuda.synchronize()
    step_times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        step_times.append(1e3 * (time.perf_counter() - t0))
    step_ms = statistics.median(step_times)
    dsplit = device_split(torch, lambda: [decode() for _ in range(n_prof)])
    if dsplit:
        dsplit = {k: round(v / n_prof, 4) for k, v in dsplit.items()}
    busy = sum(dsplit.values()) if dsplit else None
    idle = None if busy is None else [1.0 - busy / t for t in (
        step_ms, min(step_times), max(step_times))]
    print(f"serve: decode step {step_ms:.3f} ms on the host clock (median "
          f"of {n_steps}, min {min(step_times):.3f} max "
          f"{max(step_times):.3f}); device time per step by kind (mean of "
          f"{n_prof}) {dsplit if dsplit else 'not measured'}; idle share of "
          f"the card {'not measured' if idle is None else f'{idle[0]:.3f}'}"
          f"{'' if idle is None else f' ({idle[1]:.3f} to {idle[2]:.3f})'}",
          flush=True)
    stats.update(prefill_ms=prefill_ms, plain_prefill_ms=plain_prefill_ms,
                 prefill_device_ms_by_kind=split, decode_step_ms=step_ms,
                 decode_step_ms_min=min(step_times),
                 decode_step_ms_max=max(step_times),
                 decode_device_ms_by_kind=dsplit,
                 decode_idle_share=None if idle is None else idle[0],
                 decode_idle_share_range=None if idle is None else idle[1:],
                 logits_f32_max_abs_err=err32, logits_f32_tol=tol32,
                 logits_bf16_max_abs_err=err, logits_bf16_tol=tol,
                 decode_logits_f32_max_abs_err=dec_err,
                 decode_logits_f32_tol=dec_tol)
    return stats


# the continuous scheduler's runs: the reference's default serving path,
# every tick one block step replayed from a CUDA graph
CONTINUOUS = ("mamba2-1.3b", "llama3.2-1b")


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def tree_max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(tree_max_diff(a[k], b[k]) for k in a)
    return (a.float() - b.float()).abs().max().item()


def ms_text(values) -> str:
    if not values:
        return "none"
    return (f"{statistics.median(values):.3f} ({min(values):.3f}-"
            f"{max(values):.3f}, n={len(values)})")


def record_ticks(engine, keep_logits: bool = False) -> list:
    """Wrap the engine's block step and sampling: each tick appends (T, host
    ms from the step's inputs to the fetched argmax, inputs, logits)."""
    ticks, cur = [], {}
    step, sample = engine._block_step, engine._sample

    def timed_step(tokens, n_valid, reset):
        cur.update(t0=time.perf_counter(),
                   inputs=(tokens.copy(), n_valid.copy(), reset.copy()))
        logits = step(tokens, n_valid, reset)
        cur["logits"] = logits.float().clone() if keep_logits else None
        return logits

    def timed_sample(logits):
        out = sample(logits)
        if "t0" in cur:
            ticks.append((cur["inputs"][0].shape[1],
                          1e3 * (time.perf_counter() - cur.pop("t0")),
                          cur.pop("inputs"), cur.pop("logits")))
        return out

    engine._block_step, engine._sample = timed_step, timed_sample
    return ticks


def continuous_pass(smoke: Smoke, serve, kops, arch: str):
    """``arch`` FULL under the continuous scheduler: 8 requests of up to 512
    prompt tokens on 4 slots, chunks of 16; returns its numbers."""
    from repro_torch.models import build_lm
    from repro_torch.models.common import cast_tree
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    torch = smoke.torch
    engine = serve.build_engine(arch, "full", device="cuda", slots=4,
                                max_new=16, scheduler="continuous",
                                prefill_chunk=16, seed=0)
    cfg = engine.bundle.cfg
    norms = 2 * cfg.n_layers + 1
    print(f"serve: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, "
          f"scheduler=continuous, 4 slots, prefill_chunk 16", flush=True)
    reqs = serve.make_requests(8, 512, cfg.vocab, seed=0)
    for r in reqs:
        r.max_new = 16
    # warm-up: the longest prompt alone, so the same capacity bucket; it
    # captures the T = 16 and T = 1 graphs
    longest = max(reqs, key=lambda r: len(r.prompt))
    engine.run([Request(uid=-1, prompt=longest.prompt, max_new=16)])
    graphs = engine.compile_stats()
    if graphs["block"] != 2:
        smoke.fail(f"continuous {arch}: warm-up captured {graphs['block']} "
                   "graphs, want 2 (T = 16 and T = 1)")
    ticks = record_ticks(engine)
    first_tick, trace_from = engine.ticks, len(engine.trace)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = engine.trace[trace_from:]
    admits = [e for e in events if e["event"] == "admit"]
    finishes = [e for e in events if e["event"] == "finish"]
    refills = [e for e in admits if e["tick"] > first_tick]
    n_tok = sum(len(r.tokens) for r in results)
    ttft = [1e3 * (r.first_token_s - r.arrival_s) for r in results]
    by_t = {t: [ms for tt, ms, *_ in ticks if tt == t] for t in (16, 1)}
    n_ticks = engine.ticks - first_tick
    print(f"serve: {len(results)} requests, prompt lens "
          f"{[r.prompt_len for r in results]}, {n_tok} tokens in "
          f"{wall:.3f}s ({n_tok / wall:.2f} tok/s); TTFT ms median "
          f"{statistics.median(ttft):.1f} max {max(ttft):.1f}; {n_ticks} "
          f"ticks ({len(by_t[16])} of T=16, {len(by_t[1])} of T=1); host ms "
          f"a tick (inputs to fetched argmax), median (min-max): T=16 "
          f"{ms_text(by_t[16])}, T=1 {ms_text(by_t[1])}; {len(admits)} admits"
          f" ({len(refills)} refills), {len(finishes)} finishes; graphs "
          f"{engine.compile_stats()['block']}, captured in "
          f"{graphs['capture_s']:.2f}s; peak memory {peak_gb:.2f} GB; "
          f"launches {counts}", flush=True)
    if engine.compile_stats()["block"] != graphs["block"]:
        smoke.fail(f"continuous {arch}: the measured run captured "
                   f"{engine.compile_stats()['block'] - graphs['block']} "
                   "graph(s), want 0")
    if len(admits) != 8 or len(finishes) != 8 or len(refills) < 4:
        smoke.fail(f"continuous {arch}: {len(admits)} admits, "
                   f"{len(finishes)} finishes, {len(refills)} refills; want "
                   "8, 8 and >= 4")
    if len(results) != 8 or any(len(r.tokens) == 0 for r in results):
        smoke.fail(f"continuous {arch}: a request produced no tokens")
    if counts["rmsnorm"] != norms * n_ticks:
        smoke.fail(f"continuous {arch}: {counts['rmsnorm']} RMSNorm launches "
                   f"counted, want {norms} x {n_ticks} ticks")

    # one T = 16 and one T = 1 tick from the graph against the eager step
    # on a clone of the cache, with the same inputs
    gen = np.random.default_rng(5)
    cases = {16: (np.array([16, 5, 1, 0]), np.array([True, False, False,
                                                     False])),
             1: (np.array([1, 1, 1, 0]), np.zeros(4, bool))}
    inputs, replay_err = {}, {}
    for t_len, (n_valid, reset) in cases.items():
        tokens = gen.integers(3, cfg.vocab, (4, t_len))
        inputs[t_len] = (tokens, n_valid, reset)
        clone = clone_tree(engine._cache)
        got = engine._graphs[t_len].replay(tokens, n_valid, reset).clone()
        want = engine.bundle.decode_block(
            engine.params, clone, {"tokens": torch.from_numpy(tokens).cuda()},
            n_valid=torch.from_numpy(n_valid).cuda(),
            reset_mask=torch.from_numpy(reset).cuda())[0]
        live = torch.from_numpy(n_valid > 0).cuda()
        same = bool((got[live].argmax(-1) == want[live].argmax(-1)).all())
        replay_err[t_len] = ((got[live].float() - want[live].float())
                             .abs().max().item(),
                             tree_max_diff(engine._cache, clone))
        if not same:
            smoke.fail(f"continuous {arch}: T={t_len} graph replay and eager "
                       "step pick different tokens")
    print(f"serve: graph replay vs eager step, largest logit difference "
          f"(active slots) and cache difference: T=16 {replay_err[16]}, "
          f"T=1 {replay_err[1]}", flush=True)

    def graphed(t_len):
        def tick():
            logits = engine._graphs[t_len].replay(*inputs[t_len])
            return torch.argmax(logits, dim=-1).cpu()
        return tick

    def eager_tick():
        tokens, n_valid, reset = inputs[1]
        logits = engine._eager_step(torch.from_numpy(tokens).cuda(),
                                    torch.from_numpy(n_valid).cuda(),
                                    torch.from_numpy(reset).cuda())
        return torch.argmax(logits, dim=-1).cpu()

    # three replayed ticks of each shape, each under its own profiler: a
    # replay launches the same kernels every time, but the profiler may drop
    # a kernel record (96 of 97 once), so the gate reads the largest count
    def rmsnorms(events):
        return sum(n for name, n, _ in events or ()
                   if "rmsnorm" in name.lower())

    profiled = {t: [kernel_events(torch, graphed(t)) for _ in range(3)]
                for t in (16, 1)}
    per_replay = {t: [rmsnorms(ev) for ev in evs]
                  for t, evs in profiled.items()}
    if max(per_replay[1]) != norms or max(per_replay[16]) != norms:
        smoke.fail(f"continuous {arch}: torch.profiler saw {per_replay} "
                   f"RMSNorm launches in replayed ticks, want {norms}")
    events = {t: max(evs, key=rmsnorms) for t, evs in profiled.items()}
    top = {t: [(name[:60], n, round(ms, 4)) for name, n, ms in sorted(
        events[t] or (), key=lambda r: -r[2])[:6]] for t in events}
    n_prof = 5
    split = {16: split_by_kind(events[16])}
    sp = device_split(torch, lambda: [graphed(1)() for _ in range(n_prof)])
    split[1] = (None if sp is None else
                {k: round(v / n_prof, 4) for k, v in sp.items()})
    print(f"serve: the largest kernels of a replayed tick (name, launches, "
          f"ms): T=16 {top[16]}; T=1 {top[1]}", flush=True)
    loop = {}
    for name, fn in (("graphed", graphed(1)), ("eager", eager_tick)):
        fn()
        times = []
        for _ in range(15):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        loop[name] = times
    busy1 = sum(split[1].values()) if split[1] else None
    idle = (None if busy1 is None or not by_t[1] else
            1.0 - busy1 / statistics.median(by_t[1]))
    print(f"serve: device ms a tick by kind (torch.profiler, replayed): "
          f"T=16 {split[16] or 'not measured'}; T=1 (mean of {n_prof}) "
          f"{split[1] or 'not measured'}; idle share of the T=1 ticks "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; RMSNorm "
          f"launches in three profiled replays {per_replay}; a T=1 tick "
          f"alone, host "
          f"ms: graphed {ms_text(loop['graphed'])}, eager "
          f"{ms_text(loop['eager'])}", flush=True)
    stats = dict(
        scheduler="continuous", requests=len(results),
        prompt_lens=[r.prompt_len for r in results], tokens=n_tok,
        wall_s=wall, tok_per_s=n_tok / wall, ttft_ms=ttft,
        ttft_ms_median=statistics.median(ttft), ttft_ms_max=max(ttft),
        ticks=n_ticks, ticks_by_t={t: len(v) for t, v in by_t.items()},
        tick_ms={t: v for t, v in by_t.items()},
        admits=len(admits), refills=len(refills), finishes=len(finishes),
        graphs=engine.compile_stats()["block"],
        capture_s=graphs["capture_s"], peak_mem_gb=peak_gb,
        launches=counts, rmsnorm_per_replay=per_replay,
        device_ms_by_kind=split, top_kernels=top, idle_share_t1=idle,
        replay_vs_eager=replay_err, t1_tick_ms_graphed=loop["graphed"],
        t1_tick_ms_eager=loop["eager"])
    # f32: the engine on the kernels against each request's prefill alone,
    # and against the same engine on the plain versions
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = cast_tree(engine.params, torch.float32)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    for path in (None, "baseline"):
        eng = ServingEngine(build_lm(dataclasses.replace(cfg32, policy=path)),
                            params32, ServeConfig(slots=4, max_new=16,
                                                  prefill_chunk=16))
        rec = record_ticks(eng, keep_logits=True)
        res = eng.run(reqs)
        runs[path] = (eng, rec, res)
    eng, rec, res = runs[None]
    slot_of = {e["uid"]: e["slot"] for e in eng.trace
               if e["event"] == "admit"}
    first_err, first_tol = 0.0, 0.0
    for r in res:
        tick = r.admitted_tick + -(-r.prompt_len // 16) - 1
        got = rec[tick][3][slot_of[r.uid]]
        prompt = torch.from_numpy(reqs[r.uid].prompt.astype("int64"))
        want = eng.bundle.prefill_last(
            eng.params, {"tokens": prompt[None].cuda()})[0][0, -1].float()
        first_err = max(first_err, (got - want).abs().max().item())
        first_tol = max(first_tol, 1e-3 * want.abs().max().item())
    plain_rec = runs["baseline"][1]
    path_err, path_tol, compared = 0.0, 0.0, 0
    for (_, _, ins, lg), (_, _, pins, plg) in zip(rec, plain_rec):
        if not all(np.array_equal(a, b) for a, b in zip(ins, pins)):
            break               # the token streams parted: stop comparing
        live = torch.from_numpy(ins[1] > 0).cuda()
        path_err = max(path_err, (lg[live] - plg[live]).abs().max().item())
        path_tol = max(path_tol, 1e-3 * plg[live].abs().max().item())
        compared += 1
    print(f"serve: f32 first-token logits, continuous engine vs each "
          f"request's prefill alone (B=1, kernels): max_abs_err="
          f"{first_err:.4e} (tol {first_tol:.4e}); f32 continuous engine, "
          f"kernels vs plain versions over {compared} of {len(rec)} ticks: "
          f"max_abs_err={path_err:.4e} (tol {path_tol:.4e})", flush=True)
    if not first_err <= first_tol:
        smoke.fail(f"continuous {arch}: first-token logits {first_err} from "
                   f"the prefill's (tol {first_tol})")
    if compared == 0 or not path_err <= path_tol:
        smoke.fail(f"continuous {arch}: kernels vs plain versions "
                   f"{path_err} (tol {path_tol}) over {compared} ticks")
    stats.update(first_token_f32_max_abs_err=first_err,
                 first_token_f32_tol=first_tol,
                 plain_f32_max_abs_err=path_err, plain_f32_tol=path_tol,
                 plain_f32_ticks_compared=compared)
    return stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no {src / 'repro_torch'} beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import ops
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve

    # references compute in full f32 (cuDNN would take TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    t0 = time.perf_counter()
    lib_path = build.library_path()
    build.load()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.1f}s "
          f"({'built' if build.build_seconds is not None else 'cached'})",
          flush=True)
    for line in ptxas_report(lib_path.parent / "build.log"):
        print(line, flush=True)
    lib = build.load()
    print("flash_attention.cu dynamic shared memory per block: " + ", ".join(
        f"{name} D={dh} Lk={lk} "
        f"{lib.flash_attention_smem_bytes(dh, lk, code)} B"
        for name, code in (("bf16", 2), ("f32", 0)) for dh in (64, 128)
        for lk in (512, 4096)), flush=True)
    smoke = Smoke(torch)

    with torch.inference_mode():
        kops.reset_launches()
        try:
            ops_pass(smoke, ops, ref)
        except Exception as exc:
            smoke.fail(f"ops pass: {exc!r}")
        ops_counts = kops.launch_counts()
        print(f"main path, ops: launches {ops_counts}; SSD instances "
              f"{instance_text(kops.instance_counts())}", flush=True)
        for name, count in ops_counts.items():
            if count < 1:
                smoke.fail(f"ops pass launched {name} no time")
        stats = {}
        launches = dict(ops_counts)
        runs = [(f"{arch} wave" + ("" if policy is None else f" {policy}"),
                 lambda a=arch, p=policy, pl=per_layer, ab=absent:
                 serve_pass(smoke, serve, kops, a, p, pl, ab))
                for arch, policy, per_layer, absent in SERVED]
        runs += [(f"{arch} continuous",
                  lambda a=arch: continuous_pass(smoke, serve, kops, a))
                 for arch in CONTINUOUS]
        for run, fn in runs:
            try:
                stats[run] = fn()
            except Exception as exc:
                smoke.fail(f"serve pass {run}: {exc!r}")
                stats[run] = {"launches": {k: 0 for k in ops_counts}}
            gc.collect()
            torch.cuda.empty_cache()
            for k in launches:
                launches[k] += stats[run]["launches"][k]
        rows = check_kernels(smoke, kops, ref)
        whole_ops = compare_whole_ops(smoke, ops, ref)

    kernels = []
    for name, k in kops.KERNELS.items():
        row = rows.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            **{key: row.get(key) for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            "cases": row.get("cases", [])})
    print(json.dumps({"serve": stats, "whole_ops": whole_ops}))
    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} failure(s):",
              file=sys.stderr)
        for f in smoke.failures:
            print(f"  {f}", file=sys.stderr)
        print(json.dumps({"kernels": kernels}))
        return 1
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

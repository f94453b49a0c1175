"""The launch plan of the port's reduce and scan kernels, and their summation
order, against the JAX package.

``repro_torch.kernels.layout.reduce_scan_plan`` decides how
``csrc/tcu_reduce.cu`` and ``csrc/tcu_scan.cu`` cut rows into pieces: one
piece per row when the rows fill the card; few long rows, or fewer than 16
rows, cut into column ranges that a warp's 16-row tile holds. The first
tests hold the plan at the card's 132 SMs.

The CUDA kernels run only on the card (``tests/test_torch_kernels.py``).
Here :func:`emulate` repeats their arithmetic in torch, step by step and in
their order: the exact three-part bf16 split of f32 values, each step's
``A @ 1`` / ``A @ U`` rounded to f32 as the tensor cores return it (the
k-steps, or the f32 parts from the smallest up, chained), the pieces'
running sums in f32, the in-warp butterfly that folds 2 to 16 pieces, the
shuffle scans of the combine pass and the carries between pieces. The same
numpy inputs, made from a seed, go through the JAX package's kernels
(``repro.kernels.ops`` with ``path="interpret"``, the Pallas kernels in
interpret mode on padded blocks) and its oracle ``repro.kernels.ref``.

Tolerances, those of ``tests/test_kernels.py`` for the same ops: reduce f32
rtol 1e-4 / atol 1e-3 and scan f32 rtol 1e-3 / atol 1e-2 (both sides sum
in f32 in different orders); bf16 inputs are exact in f32 after the cast,
so they take the f32 tolerances as well.
"""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import layout
from repro_torch.kernels import ref as tref

SMS = 132                      # an H100's streaming multiprocessors


# ---------------------------------------------------------------------------
# the plan


def piece_ranges(n, plan):
    """The column ranges of one row's pieces (empty ones included)."""
    return [(min(n, p * plan.length), min(n, (p + 1) * plan.length))
            for p in range(plan.pieces)]


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("rows,n", [(16, 1 << 20), (1, 1 << 24)])
def test_few_long_rows_fill_the_card(rows, n, itemsize, scan):
    plan = layout.reduce_scan_plan(rows, n, itemsize, SMS, scan=scan)
    assert plan.blocks >= SMS
    assert rows * plan.pieces >= 16 * SMS        # pieces for every SM's warps


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_many_rows_keep_one_pass_per_row_group(itemsize, scan):
    plan = layout.reduce_scan_plan(65536, 256, itemsize, SMS, scan=scan)
    assert plan.pieces == 1 and plan.length == 256
    assert plan.workspace == 0
    assert plan.blocks == 65536 // 16 // 8        # a warp per 16 rows


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("rows,n", [(16, 1 << 20), (1, 1 << 24), (3, 1000003),
                                   (4096, 4096), (17, 1000), (1, 300),
                                   (5, 20000), (1 << 20, 16), (37, 100)])
def test_pieces_cover_each_row_exactly_in_whole_steps(rows, n, itemsize,
                                                      scan):
    plan = layout.reduce_scan_plan(rows, n, itemsize, SMS, scan=scan)
    ranges = piece_ranges(n, plan)
    cols = [c for lo, hi in ranges for c in range(lo, hi)] if n < 5000 \
        else None
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo                                  # no gap, no overlap
    if cols is not None:
        assert cols == list(range(n))
    if plan.pieces > 1:
        step = 64 // itemsize
        assert plan.length % step == 0                   # whole steps
        assert plan.pieces * plan.length >= n
    if 1 < plan.pieces <= 16:                            # folded in a warp
        assert 16 % plan.pieces == 0 and plan.workspace == 0
    elif plan.pieces > 16:
        sums = plan.pieces if scan else plan.pieces // 16
        assert scan or plan.pieces % 16 == 0
        assert plan.workspace == rows * sums * (2 if scan else 1)
        assert plan.combine_threads >= min(1024, 32 * -(-sums // 256))


@pytest.mark.parametrize("rows", range(1, 16))
def test_fewer_than_16_rows_are_folded_into_full_tiles(rows):
    for scan in (False, True):
        plan = layout.reduce_scan_plan(rows, 1 << 20, 4, SMS, scan=scan)
        assert rows * plan.pieces >= 16 and plan.pieces > 1


# ---------------------------------------------------------------------------
# torch emulation of the kernels' order of summation

f32 = torch.float32


def rnd(t):
    """Round float64 values to f32 (the tensor cores' f32 result)."""
    return t.to(f32).to(torch.float64)


def split3(x):
    """The kernels' exact three-part bf16 split of f32 values: hi is x with
    its low 16 bits cleared, mid the same of x - hi, lo the rest."""
    def clear(v):
        return (v.view(torch.int32) & -65536).view(f32)

    hi = clear(x)
    r = x - hi
    mid = clear(r)
    return hi, mid, r - mid


def step_prefix(step, dtype):
    """Each step's columns scanned as one ``A @ U`` on the tensor cores
    returns them, f64 holding f32 values: (..., steps, cols). f16/bf16:
    the two k-steps of 16 slots (columns c % 8 < 4, then the rest) chained;
    f32: the lo, mid, hi parts chained."""
    if dtype == torch.float32:
        d = torch.zeros(step.shape, dtype=torch.float64)
        for part in reversed(split3(step)):               # lo, mid, hi
            d = rnd(d + part.double().cumsum(-1))
        return d
    v = step.double()
    first = (torch.arange(step.shape[-1]) % 8) < 4
    d = rnd((v * first).cumsum(-1))
    return rnd(d + (v * ~first).cumsum(-1))


def hillis_steele(v):
    """The kernels' shuffle scan (shfl_up by 1, 2, 4, 8, 16) over the last
    axis, in f32."""
    v = v.clone()
    o = 1
    while o < v.shape[-1]:
        nxt = v.clone()
        nxt[..., o:] = rnd(v[..., o:] + v[..., :-o])
        v, o = nxt, 2 * o
    return v


def butterfly(t):
    """fold_sum: the xor butterfly over a run of 2, 4 or 8 values."""
    p, s = t.shape[-1], 1
    while s < p:
        t = rnd(t + t[..., torch.arange(p) ^ s])
        s *= 2
    return t[..., 0]


def combine(sums, threads, *, exclusive):
    """combine_pieces over each row's sums (rows, m): warp tiles of 256
    (eight rows of 32 lanes, each scanned by shuffles), the warps' totals
    scanned through shared memory, a running offset between block tiles."""
    rows, m = sums.shape
    nw = threads // 32
    tile = 256 * nw
    pad = -(-m // tile) * tile
    v = torch.zeros(rows, pad, dtype=torch.float64)
    v[:, :m] = sums
    v = v.view(rows, pad // tile, nw, 8, 32)
    inc = hillis_steele(v)
    ex_row = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    run = torch.zeros(inc.shape[:-1], dtype=torch.float64)   # before row j
    acc = torch.zeros(inc.shape[:-2], dtype=torch.float64)
    for j in range(8):
        run[..., j] = acc
        acc = rnd(acc + inc[..., j, 31])
    ex = rnd(run[..., None] + ex_row)
    warps = hillis_steele(acc)                       # inclusive over warps
    out = torch.zeros(rows, pad, dtype=torch.float64).view(v.shape)
    offset = torch.zeros(rows, dtype=torch.float64)
    for b in range(pad // tile):
        for w in range(nw):
            base = offset if w == 0 else rnd(offset + warps[:, b, w - 1])
            out[:, b, w] = rnd(base[:, None, None] + ex[:, b, w])
        offset = rnd(offset + warps[:, b, nw - 1])
    return out.reshape(rows, pad)[:, :m] if exclusive else offset


def fold_carries(t):
    """fold_carries: exclusive prefix of a row's 2 to 16 piece totals
    inside the warp (shuffle scans over each half, the second half after
    the whole first)."""
    p = t.shape[-1]
    seg = min(p, 8)
    halves = t.view(*t.shape[:-1], p // seg, seg)
    inc = hillis_steele(halves)
    ex = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    if p == 16:
        ex[..., 1, :] = rnd(ex[..., 1, :] + inc[..., 0, 7:8])
    return ex.reshape(t.shape)


def emulate(x, plan, *, scan):
    """The kernels' result for ``x (rows, n)`` under ``plan``, in f32."""
    rows, n = x.shape
    dtype = x.dtype
    cols = 64 // x.element_size()
    steps = -(-plan.length // cols)
    pieces = torch.zeros(rows, plan.pieces, steps * cols, dtype=dtype)
    for p, (lo, hi) in enumerate(piece_ranges(n, plan)):
        pieces[:, p, :hi - lo] = x[:, lo:hi]
    if not scan and plan.pieces % 16 == 0 and plan.pieces * plan.length == n:
        # runs of 16 whole pieces are read as one block: row g of step s is
        # the block's chunk 16 s + g
        pieces = pieces.view(rows, -1, 16 * steps, cols).unflatten(
            2, (steps, 16)).transpose(2, 3).reshape(pieces.shape)
    d = step_prefix(pieces.view(rows, plan.pieces, steps, cols).float(),
                    dtype)                              # (r, P, steps, cols)
    totals = torch.zeros(rows, plan.pieces, dtype=torch.float64)
    for s in range(steps):
        totals = rnd(totals + d[:, :, s, -1])
    p = plan.pieces
    fold = p if 1 < p <= 16 and 16 % p == 0 else (
        16 if not scan and p % 16 == 0 else 1)
    if not scan:
        if fold == 1:
            sums = totals
        elif fold < 16:
            sums = butterfly(totals.view(rows, p // fold, fold))
        else:
            halves = totals.view(rows, p // 16, 2, 8)
            sums = rnd(butterfly(halves[..., 0, :]) + butterfly(
                halves[..., 1, :]))
        if sums.shape[1] == 1:
            return sums[:, 0].float()
        return combine(sums, plan.combine_threads, exclusive=False).float()
    if p == 1:
        carry = torch.zeros(rows, 1, dtype=torch.float64)
    elif fold > 1:
        carry = fold_carries(totals)
    else:
        carry = combine(totals, plan.combine_threads, exclusive=True)
    out = torch.zeros(rows, p, steps, cols, dtype=torch.float64)
    c = carry
    for s in range(steps):
        out[:, :, s] = rnd(d[:, :, s] + c[..., None])
        c = rnd(c + d[:, :, s, -1])
    flat = out.view(rows, p * steps * cols)
    got = torch.cat([flat[:, i * steps * cols:i * steps * cols + hi - lo]
                     for i, (lo, hi) in enumerate(piece_ranges(n, plan))],
                    dim=1)
    return got.float()


def inputs(rows, n, dtype, seed):
    """The same values for both packages: numpy from a seed, bf16 through
    ml_dtypes."""
    a = np.random.default_rng(seed).standard_normal((rows, n)).astype(
        np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(a), torch.from_numpy(
            a.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# (rows, n, sms): at 132 SMs these are cut into 2-16 pieces a row (folded
# in a warp), 40 pieces (a second pass), or run whole; sms=1 cuts a 40-row
# input into 8 pieces a row. Every n is ragged against its pieces.
SHAPES = [(5, 1000, SMS), (1, 5000, SMS), (17, 300, SMS), (3, 1000, SMS),
          (40, 2000, 1), (1, 100, SMS), (33, 777, SMS), (64, 16, SMS),
          (96, 8, SMS), (2, 4096, SMS), (1, 8192, SMS)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n,sms", SHAPES)
def test_emulated_reduce_matches_the_jax_kernels(rows, n, sms, dtype):
    jx, tx = inputs(rows, n, dtype, seed=rows * n)
    plan = layout.reduce_scan_plan(rows, n, tx.element_size(), sms,
                                   scan=False)
    got = emulate(tx, plan, scan=False)
    close(got, jops.segmented_reduce(jx, path="interpret"), 1e-4, 1e-3)
    close(got, jref.segmented_reduce_ref(jx), 1e-4, 1e-3)
    close(got, tref.segmented_reduce_ref(tx), 1e-4, 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n,sms", SHAPES)
def test_emulated_scan_matches_the_jax_kernels(rows, n, sms, dtype):
    jx, tx = inputs(rows, n, dtype, seed=rows + n)
    plan = layout.reduce_scan_plan(rows, n, tx.element_size(), sms,
                                   scan=True)
    got = emulate(tx, plan, scan=True)
    close(got, jops.segmented_scan(jx, path="interpret"), 1e-3, 1e-2)
    close(got, jref.segmented_scan_ref(jx), 1e-3, 1e-2)
    close(got, tref.segmented_scan_ref(tx), 1e-3, 1e-2)


@pytest.mark.parametrize("scan", [False, True])
def test_emulation_takes_each_path(scan):
    """The shapes above reach one piece a row, pieces folded in a warp, and
    pieces combined by a second pass; for the reduce also runs of 16 whole
    pieces read as one block, folded in the warp or then combined."""
    kinds = set()
    for rows, n, sms in SHAPES:
        for itemsize in (4, 2):
            plan = layout.reduce_scan_plan(rows, n, itemsize, sms, scan=scan)
            p = plan.pieces
            kinds.add("whole" if p == 1 else "folded" if p <= 16
                      else "combined")
            if not scan and p % 16 == 0 and p * plan.length == n:
                kinds.add("block, folded" if p == 16 else "block, combined")
    assert kinds == {"whole", "folded", "combined"} | (set() if scan else {
        "block, folded", "block, combined"})


def test_ones_scan_is_exact_across_pieces():
    """Constant input: every partial sum is an integer below 2^24, so the
    emulated split path is exact, as the card test demands of the kernel."""
    x = torch.ones(2, 20000)
    plan = layout.reduce_scan_plan(2, 20000, 4, SMS, scan=True)
    assert plan.pieces > 16
    got = emulate(x, plan, scan=True)
    assert torch.equal(got, torch.arange(1, 20001, dtype=f32).expand(2, -1))
    red = emulate(x, layout.reduce_scan_plan(2, 20000, 4, SMS, scan=False),
                  scan=False)
    assert torch.equal(red, torch.full((2,), 20000.0))


def test_three_part_split_is_exact():
    """hi + mid + lo == x, each part a bf16 value, for f32 values from 2^-100
    up (normal, huge, tiny); below, where the remainders fall under f32's
    normal range, the parts lose at most the bits under 2^-133."""
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.standard_normal(4096),
                        rng.standard_normal(256) * 1e30,
                        rng.standard_normal(256) * 1e-29,
                        np.array([0.0, -0.0, 2.0 ** -100])]).astype(
        np.float32)
    x = torch.from_numpy(a)
    hi, mid, lo = split3(x)
    assert torch.equal(((hi.double() + mid.double()) + lo.double()).float(),
                       x)
    for part in (hi, mid, lo):
        assert torch.equal(part.bfloat16().float(), part)
    tiny = torch.tensor([1e-40, -3e-39, 1.5e-38, 7e-36])
    parts = [p.bfloat16().double() for p in split3(tiny)]
    assert (sum(parts) - tiny.double()).abs().max() <= 2.0 ** -133

"""The launch plan of the port's weighted-scan kernels, and their order of
combination, against the JAX package.

``repro_torch.kernels.layout.weighted_scan_plan`` decides how
``csrc/weighted_scan.cu`` cuts rows into pieces: one piece per row when the
rows fill the card; fewer rows of up to 8192 columns cut into 2, 4 or 8
pieces that one block joins; few long rows cut into pieces of whole
256-column steps that a fixed-order carry pass joins. The first tests hold
the plan at the card's 132 SMs.

The CUDA kernels run only on the card (``tests/test_torch_kernels.py``).
Here :func:`emulate` repeats their arithmetic in f32 torch, in their order
(``csrc/wscan_tile.cuh``): each lane's run of 8 columns scanned in
registers (states ``h``, decay products ``P``, summed log-decay), the
5-step shuffle scan of the lanes' ``(log-decay, state)`` pairs, each lane's
exclusive pair and the warp's carried state, the step total carried to the
next step; for rows folded in a block the pieces' totals joined in order;
for long rows the pieces' totals, the carry pass (a thread's pieces folded
in order, shuffle scans over threads and over warps) and the scan from the
carries; for the local pass the tree on segments of q / 8
lanes with nothing carried. The same numpy inputs, made from a seed, go
through the JAX package's oracle ``repro.kernels.ref.weighted_scan_ref``
and its matmul form ``repro.core.scan.tcu_weighted_scan``.

Tolerance: f32, 1e-4 of the largest value of the oracle's output (absolute
and relative): both sides compute in f32 in different orders, and with
``log_a = 0`` the weighted scan is a plain prefix sum, whose f32 rounding
grows with the values it reaches.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro.kernels import ref as jref
from repro_torch.kernels import layout
from repro_torch.kernels import ref as tref

SMS = 132                      # an H100's streaming multiprocessors
E, LANES = 8, 32               # columns per lane, lanes per warp
STEP = E * LANES               # columns per step of a warp

jit_ref = jax.jit(jref.weighted_scan_ref)
jit_tcu = jax.jit(jscan.tcu_weighted_scan)


# ---------------------------------------------------------------------------
# the plan


def piece_ranges(n, plan):
    return [(min(n, p * plan.length), min(n, (p + 1) * plan.length))
            for p in range(plan.pieces)]


@pytest.mark.parametrize("rows,n", [(16, 1 << 20), (1, 1 << 24)])
def test_few_long_rows_fill_the_card(rows, n):
    plan = layout.weighted_scan_plan(rows, n, SMS)
    # about 16 warps for every SM (pieces of whole steps, rounded up)
    assert rows * plan.pieces >= 15 * SMS
    assert plan.blocks >= SMS
    assert plan.length == 8192                   # 32 steps a piece
    assert plan.workspace == 3 * rows * plan.pieces


@pytest.mark.parametrize("rows,n", [(65536, 256), (2112, 4096), (100, 256),
                                    (1, 3)])
def test_rows_that_fill_the_card_or_are_short_take_one_launch(rows, n):
    """Many rows (a warp each fills the card), or rows of one step: one
    piece a row, no workspace, one launch."""
    plan = layout.weighted_scan_plan(rows, n, SMS)
    assert plan.pieces == 1 and plan.length == n and plan.workspace == 0
    assert plan.blocks == min(-(-rows // 8), 8 * SMS)


@pytest.mark.parametrize("rows,n,pieces,length", [
    (64, 4096, 8, 512), (1, 8192, 8, 1024), (17, 1000, 4, 256),
    (64, 300, 2, 256), (1, 4097, 8, 768), (2111, 257, 2, 256)])
def test_fewer_rows_up_to_8192_fold_into_a_block(rows, n, pieces, length):
    """Fewer rows than fill the card, of 2 to 32 steps: 2, 4 or 8 pieces of
    at most one batch (4 steps), joined inside one block, no workspace."""
    plan = layout.weighted_scan_plan(rows, n, SMS)
    assert (plan.pieces, plan.length) == (pieces, length)
    assert layout.weighted_folded(plan.pieces, plan.length)
    assert plan.workspace == 0


def test_rows_past_a_block_are_split():
    """One column past 8192: three launches, pieces of at least 16 steps."""
    plan = layout.weighted_scan_plan(1, 8193, SMS)
    assert (plan.pieces, plan.length) == (3, 4096)
    assert not layout.weighted_folded(plan.pieces, plan.length)
    assert plan.workspace == 9


@pytest.mark.parametrize("rows,n", [(16, 1 << 20), (1, 1 << 24), (3, 1000003),
                                    (64, 4096), (65536, 256), (17, 1000),
                                    (1, 1), (1, 3), (1, (1 << 16) + 3),
                                    (5, 4097), (2111, 8192), (1, 4096 * 33)])
def test_pieces_cover_each_row_exactly_in_whole_steps(rows, n):
    plan = layout.weighted_scan_plan(rows, n, SMS)
    ranges = piece_ranges(n, plan)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
        assert hi == lo                          # no gap, no overlap
    if plan.pieces > 1:
        assert plan.length % STEP == 0           # whole steps
    if layout.weighted_folded(plan.pieces, plan.length):
        assert plan.length <= 4 * STEP and plan.workspace == 0
    elif plan.pieces > 1:
        assert ranges[-1][1] > ranges[-1][0]     # no empty tail piece
        assert plan.length >= 16 * STEP          # at least min_steps
        assert plan.workspace == 3 * rows * plan.pieces
        assert 32 <= plan.combine_threads <= 256
        assert plan.combine_threads & (plan.combine_threads - 1) == 0


def test_piece_edges():
    """n at, one under and one over a whole number of pieces."""
    base = layout.weighted_scan_plan(1, 1 << 20, SMS)
    for n, pieces in ((4 * 4096, 4), (4 * 4096 - 1, 4), (4 * 4096 + 1, 5)):
        plan = layout.weighted_scan_plan(1, n, SMS)
        assert (plan.pieces, plan.length) == (pieces, 4096)
    assert base.pieces * base.length == 1 << 20


# ---------------------------------------------------------------------------
# torch emulation of the kernels' order


def shift(t, d):
    """shfl_up by d over the lane axis (the low lanes keep don't-care 0)."""
    return torch.cat([torch.zeros_like(t[..., :d]), t[..., :-d]], -1)


def lane_runs(xs, ls):
    """Each lane's run of 8 columns from a zero start: states h, decay
    products P, summed log-decay. (..., 32, 8) -> (..., 32, 8) twice and
    (..., 32)."""
    a = torch.exp(ls)
    h, p, lam = [xs[..., 0]], [a[..., 0]], ls[..., 0]
    for j in range(1, E):
        h.append(a[..., j] * h[-1] + xs[..., j])
        p.append(p[-1] * a[..., j])
        lam = lam + ls[..., j]
    return torch.stack(h, -1), torch.stack(p, -1), lam


def tree(tl, th, seg):
    """Inclusive shuffle scan of (log-decay, state) pairs over segments of
    ``seg`` lanes: (l_u, h_u) . (l, h) = (l_u + l, exp(l) h_u + h)."""
    li = torch.arange(tl.shape[-1]) % seg
    d = 1
    while d < seg:
        ul, uh = shift(tl, d), shift(th, d)
        m = li >= d
        th = torch.where(m, torch.exp(tl) * uh + th, th)
        tl = torch.where(m, tl + ul, tl)
        d *= 2
    return tl, th


def exclusive(tl, th, seg):
    first = torch.arange(tl.shape[-1]) % seg == 0
    return (torch.where(first, 0.0, shift(tl, 1)),
            torch.where(first, 0.0, shift(th, 1)))


def walk(xp, lp, c, *, seg=LANES, local=False):
    """One warp's walk over its piece, vectorised over pieces: xp, lp
    (..., steps, 32, 8) zero-padded, c (...) the state entering the piece.
    Returns the scan (..., steps * 256), the piece's final state and its
    summed log-decay."""
    lam = torch.zeros_like(c)
    ys = []
    for s in range(xp.shape[-3]):
        h, p, rl = lane_runs(xp[..., s, :, :], lp[..., s, :, :])
        tl, th = tree(rl, h[..., -1], seg)
        el, eh = exclusive(tl, th, seg)
        cl = eh if local else torch.exp(el) * c[..., None] + eh
        ys.append((p * cl[..., None] + h).flatten(-2))
        if not local:
            c = torch.exp(tl[..., -1]) * c + th[..., -1]
            lam = lam + tl[..., -1]
    return torch.cat(ys, -1), c, lam


def carry_pass(lam, h, threads):
    """wscan_carry_kernel over each row's piece totals (rows, pieces): thread
    t folds pieces [t k, t k + k) in order, shuffle scans over the threads
    of each warp and over the warps, then each thread walks its pieces from
    its carry. Returns the state entering every piece (rows, pieces)."""
    rows, m = lam.shape
    k = -(-m // threads)
    pl = torch.zeros(rows, threads * k)
    ph = torch.zeros(rows, threads * k)
    pl[:, :m], ph[:, :m] = lam, h
    pl, ph = pl.view(rows, threads, k), ph.view(rows, threads, k)
    tl, th = torch.zeros(rows, threads), torch.zeros(rows, threads)
    for j in range(k):
        th = torch.exp(pl[..., j]) * th + ph[..., j]
        tl = tl + pl[..., j]
    nw = threads // LANES
    tl, th = tree(tl.view(rows, nw, LANES), th.view(rows, nw, LANES), LANES)
    wl = torch.zeros(rows, LANES)
    wh = torch.zeros(rows, LANES)
    wl[:, :nw], wh[:, :nw] = tl[..., -1], th[..., -1]
    wl, wh = tree(wl, wh, LANES)
    warp_in = exclusive(wl, wh, LANES)[1][:, :nw]     # state entering warps
    el, eh = exclusive(tl, th, LANES)
    c = (torch.exp(el) * warp_in[..., None] + eh).view(rows, threads)
    cin = torch.zeros(rows, threads, k)
    for j in range(k):
        cin[..., j] = c
        c = torch.exp(pl[..., j]) * c + ph[..., j]
    return cin.view(rows, threads * k)[:, :m]


def as_steps(t, pieces, length):
    """(rows, n) -> (rows, pieces, steps, 32, 8), zero-padded: past n a
    column reads x = 0 and log_a = 0, which leaves a state as it is."""
    rows, n = t.shape
    steps = -(-length // STEP)
    v = torch.zeros(rows, pieces, steps * STEP)
    for p in range(pieces):
        lo, hi = min(n, p * length), min(n, (p + 1) * length)
        v[:, p, :hi - lo] = t[:, lo:hi]
    return v.view(rows, pieces, steps, LANES, E)


def emulate(x, la, plan=None):
    """weighted_scan.cu's result on ``x, la (rows, n)`` f32 under ``plan``
    (default: the card's plan)."""
    rows, n = x.shape
    plan = plan or layout.weighted_scan_plan(rows, n, SMS)
    xp, lp = (as_steps(t, plan.pieces, plan.length) for t in (x, la))
    zero = torch.zeros(rows, plan.pieces)
    cin = zero
    if layout.weighted_folded(plan.pieces, plan.length):
        # wscan_fold_kernel: the row's earlier totals folded in order
        _, h, lam = walk(xp, lp, zero)
        cin = zero.clone()
        for p in range(1, plan.pieces):
            cin[:, p] = torch.exp(lam[:, p - 1]) * cin[:, p - 1] + h[:, p - 1]
    elif plan.pieces > 1:
        _, h, lam = walk(xp, lp, zero)
        cin = carry_pass(lam, h, plan.combine_threads)
    y, _, _ = walk(xp, lp, cin)
    return torch.cat([y[:, p, :min(n, (p + 1) * plan.length)
                       - min(n, p * plan.length)]
                      for p in range(plan.pieces)], -1)


def emulate_local(x, la, q):
    """matmul_scan.cu's local pass: every q block restarted from zero, the
    tree on segments of q / 8 lanes, no carry between steps (pieces are
    whole steps, so blocks start where the row's do)."""
    rows, n = x.shape
    steps = -(-n // STEP)
    xp, lp = (as_steps(t, 1, steps * STEP) for t in (x, la))
    y, _, _ = walk(xp, lp, torch.zeros(rows, 1), seg=q // E, local=True)
    return y[:, 0, :n]


# ---------------------------------------------------------------------------
# the emulation against the JAX package


def inputs(rows, n, kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    if kind == "decay":
        la = rng.uniform(-0.5, 0.0, (rows, n)).astype(np.float32)
    elif kind == "zero":
        la = np.zeros((rows, n), np.float32)
    elif kind == "-30":
        la = np.full((rows, n), -30.0, np.float32)
    else:                       # "reset": -inf in one row in every 7th column
        la = rng.uniform(-0.5, 0.0, (rows, n)).astype(np.float32)
        la[rows // 2, ::7] = -np.inf
    return x, la


def close(got, want):
    want = torch.as_tensor(np.array(want))
    tol = 1e-4 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=tol)


@pytest.mark.parametrize("kind", ["decay", "zero", "-30", "reset"])
@pytest.mark.parametrize("n", [1, 3, 16, 17, 64, 300, 4096, (1 << 16) + 3])
def test_emulated_kernel_matches_jax(n, kind):
    """The card's plan: one piece a row up to 256 columns, 2 to 8 pieces
    folded in a block up to 8192 (300, 4096), pieces and the carry pass
    beyond (17 pieces at 2^16 + 3, the last of 3 columns)."""
    for rows in (1, 3, 16, 17):
        x, la = inputs(rows, n, kind, seed=rows * n)
        got = emulate(torch.from_numpy(x), torch.from_numpy(la))
        close(got, jit_ref(jnp.asarray(x), jnp.asarray(la)))
        if kind != "reset":     # the matmul form takes differences of -inf
            close(got, jit_tcu(jnp.asarray(x), jnp.asarray(la)))


@pytest.mark.parametrize("n,pieces,length,threads", [
    (700, 3, 256, 32),          # a ragged last piece of 188 columns
    (512, 2, 256, 32),          # folded in a block: n at whole pieces
    (1800, 8, 256, 32),         # folded: a ragged last piece, none empty
    (1000, 8, 256, 32),         # folded: empty tail pieces
    (513, 3, 256, 32),          # one column over: a last piece of 1
    (100 * 256, 100, 256, 32),  # four pieces a thread in the carry pass
    (300 * 256 - 5, 300, 256, 256),   # eight warps, two pieces a thread
])
def test_emulated_pieces_and_carry_pass_match_jax(n, pieces, length,
                                                  threads):
    """Plans with more pieces than the card's at these sizes, so that the
    carry pass folds several pieces a thread and spans warps."""
    plan = layout.PiecePlan(pieces, length, 1, threads,
                                   3 * 2 * pieces)
    for kind in ("decay", "zero", "reset"):
        x, la = inputs(2, n, kind, seed=n)
        got = emulate(torch.from_numpy(x), torch.from_numpy(la), plan)
        close(got, jit_ref(jnp.asarray(x), jnp.asarray(la)))


@pytest.mark.parametrize("q", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [17, 300, 4096])
def test_emulated_local_pass_matches_jax_per_block(n, q):
    """The local pass restarts every q columns: the JAX oracle on each
    zero-padded block."""
    for kind in ("decay", "zero", "reset"):
        x, la = inputs(3, n, kind, seed=q + n)
        got = emulate_local(torch.from_numpy(x), torch.from_numpy(la), q)
        nb = -(-n // q)
        pad = ((0, 0), (0, nb * q - n))
        want = jit_ref(jnp.asarray(np.pad(x, pad).reshape(3, nb, q)),
                       jnp.asarray(np.pad(la, pad).reshape(3, nb, q)))
        close(got, np.asarray(want).reshape(3, nb * q)[:, :n])
        close(tref.local_weighted_ref(torch.from_numpy(x),
                                      torch.from_numpy(la), q), got)


@pytest.mark.parametrize("n", [0, 1, 2, 17, 4096, (1 << 16) + 3])
def test_log_step_reference_matches_jax(n):
    for kind in ("decay", "zero", "-30", "reset"):
        x, la = inputs(3, n, kind, seed=n + 1)
        got = tref.weighted_scan_ref(torch.from_numpy(x),
                                     torch.from_numpy(la))
        assert got.shape == (3, n) and got.dtype == torch.float32
        if n:
            close(got, jit_ref(jnp.asarray(x), jnp.asarray(la)))
        assert torch.isfinite(got).all()


def test_log_step_reference_does_not_return_its_input():
    x = torch.randn(2, 1)
    got = tref.weighted_scan_ref(x, torch.zeros(2, 1))
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()


def test_zero_decay_is_the_prefix_sum():
    """log_a = 0: the emulated kernel equals segmented_scan_ref."""
    x, la = inputs(3, 5000, "zero", seed=5)
    got = emulate(torch.from_numpy(x), torch.from_numpy(la))
    want = tref.segmented_scan_ref(torch.from_numpy(x))
    close(got, want)


def test_total_decay_that_underflows_leaves_finite_values():
    """A row whose summed log-decay underflows exp to 0 (pieces whose
    decay is exp(-4096)): the carries vanish and nothing is NaN."""
    x, la = inputs(2, 20000, "decay", seed=9)
    la[:, :] = -1.0
    got = emulate(torch.from_numpy(x), torch.from_numpy(la))
    assert torch.isfinite(got).all()
    close(got, jit_ref(jnp.asarray(x), jnp.asarray(la)))

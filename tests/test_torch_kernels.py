"""The port's CUDA kernels against their plain versions, on a Hopper card.

Imports neither JAX nor the JAX package, so that it runs where only the
port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py

Without a CUDA device every test skips: a CUDA kernel has no CPU mode. The
tolerances are those of ``tests/test_kernels.py`` for the same op; flash
attention is held row by row, against each output row's RMS.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import device as devmod
from repro_torch.kernels import layout, ref
from repro_torch.kernels import ops as kops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card; the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def ssd_inputs(bsz, seqlen, nheads, hdim, ngroups, nstate, dtype, device):
    g = torch.Generator(device=device).manual_seed(seqlen)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    x = (0.2 * rn(bsz, seqlen, nheads, hdim)).to(dtype)
    dt = torch.nn.functional.softplus(rn(bsz, seqlen, nheads))
    a = -torch.exp(0.2 * rn(nheads))
    b = (rn(bsz, seqlen, ngroups, nstate) * nstate ** -0.5).to(dtype)
    c = (rn(bsz, seqlen, ngroups, nstate) * nstate ** -0.5).to(dtype)
    return x, dt, a, b, c


def assert_reduce_scan_close(x):
    """Both kernels against their plain versions, one launch each, at the
    tolerances of tests/test_kernels.py for the same ops."""
    before = kops.launch_counts()
    torch.testing.assert_close(kops.segmented_reduce(x),
                               ref.segmented_reduce_ref(x), rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(kops.segmented_scan(x),
                               ref.segmented_scan_ref(x), rtol=1e-3,
                               atol=1e-2)
    after = kops.launch_counts()
    assert after["tcu_reduce"] == before["tcu_reduce"] + 1
    assert after["tcu_scan"] == before["tcu_scan"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("n", [16, 100, 4096])
def test_reduce_scan_kernels_match_plain(cuda, n, dtype):
    assert_reduce_scan_close(torch.randn(37, n, device=cuda).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 1 << 20])
def test_scan_carry_across_tiles_and_warps(cuda, n):
    """Constant input: the scan is i + 1 everywhere, across every step,
    every warp's pieces and, at 16 x 2^20, every piece of the split path
    (each row cut into column ranges, carried by the fixed-order pass).
    Sums up to 2^20 are exact in f32, so the tolerance is 0."""
    x = torch.ones(16, n, device=cuda)
    want = torch.arange(1, n + 1, device=cuda,
                        dtype=torch.float32).expand(16, -1)
    torch.testing.assert_close(kops.segmented_scan(x), want, rtol=0, atol=0)
    torch.testing.assert_close(kops.segmented_reduce(x),
                               torch.full((16,), float(n), device=cuda),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 1 << 20), (1, 1 << 24),
                                   (3, 1_000_003), (4096, 4096),
                                   (1 << 20, 16)])
def test_reduce_scan_long_rows_match_plain(cuda, shape, dtype):
    """Few long rows (cut into pieces across the card), one row of 2^24
    (folded into full 16-row tiles), a row length that is not a multiple of
    the vector width (the element-by-element load path) and the many-row
    shapes."""
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    assert_reduce_scan_close(
        torch.randn(*shape, generator=g, device=cuda).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(1 << 20, 8), (1 << 18, 4), (1001, 16),
                                   (6, 8)])
def test_reduce_scan_short_rows_match_plain(cuda, shape, dtype):
    """Rows shorter than a step (a quad's 64 bytes): the rest of the step
    reads as zero; n = 4 in 16 bits is not a whole vector and takes the
    element-by-element loads."""
    g = torch.Generator(device=cuda).manual_seed(shape[0])
    assert_reduce_scan_close(
        torch.randn(*shape, generator=g, device=cuda).to(dtype))


def _piece_len(rows, n, itemsize):
    return layout.reduce_scan_plan(rows, n, itemsize, devmod.sm_count(
        torch.device("cuda")), scan=True).length


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("rows", list(range(1, 18)))
def test_reduce_scan_rows_and_piece_edges(cuda, rows, dtype):
    """Rows 1..17 (fewer than a tile, a tile, one past it) at an n that is
    cut into pieces, and n at, one under and one over a whole number of
    pieces."""
    size = torch.tensor([], dtype=dtype).element_size()
    length = _piece_len(rows, 20000, size)
    for n in (20000, 3 * length - 1, 3 * length, 3 * length + 1):
        g = torch.Generator(device=cuda).manual_seed(rows * n)
        assert_reduce_scan_close(
            torch.randn(rows, n, generator=g, device=cuda).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 1 << 20), (1, 1 << 24),
                                   (65536, 256), (3, 1_000_003)])
def test_reduce_scan_are_deterministic(cuda, shape):
    """No atomics: two launches on the same input give the same bits."""
    x = torch.randn(*shape, device=cuda)
    assert torch.equal(kops.segmented_reduce(x), kops.segmented_reduce(x))
    assert torch.equal(kops.segmented_scan(x), kops.segmented_scan(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 100, 4, 16, 2, 8),
                                   (1, 200, 2, 64, 1, 128)])
def test_ssd_kernel_matches_plain(cuda, shape, dtype):
    ins = ssd_inputs(*shape, dtype, cuda)
    y, st = kops.ssd_scan(*ins, return_state=True)
    yr, sr = ref.ssd_scan_ref(*ins, return_state=True)
    assert y.dtype == dtype and st.dtype == torch.float32
    # bf16 output: one rounding of the same f32 value, at most one ulp apart
    tol = 2e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(st, sr, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_weighted_scan_kernel_matches_plain(cuda):
    x = torch.randn(5, 300, device=cuda)
    la = -0.5 * torch.rand(5, 300, device=cuda)
    torch.testing.assert_close(kops.weighted_scan(x, la),
                               ref.weighted_scan_ref(x, la), rtol=2e-3,
                               atol=2e-3)


# the weighted scan (weighted_scan.cu on csrc/wscan_tile.cuh): one launch
# per call with one piece a row, three with pieces (totals, carries, scan)


def weighted_inputs(shape, dtype, device, la_dtype=None, seed=None):
    g = torch.Generator(device=device).manual_seed(
        shape[-1] if seed is None else seed)
    x = torch.randn(*shape, generator=g, device=device).to(dtype)
    la = (-0.5 * torch.rand(*shape, generator=g, device=device)).to(
        la_dtype or dtype)
    return x, la


def assert_weighted_close(x, la):
    """weighted_scan against its plain version on the same inputs, one
    launch of its kernel and none of another, at the tolerance of
    test_weighted_scan_kernel_matches_plain."""
    before = kops.launch_counts()
    got = kops.weighted_scan(x, la)
    after = kops.launch_counts()
    assert got.dtype == torch.float32 and got.shape == x.shape
    torch.testing.assert_close(got, ref.weighted_scan_ref(x, la), rtol=2e-3,
                               atol=2e-3)
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"weighted_scan": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 4096), (65536, 256), (16, 1 << 20),
                                   (1, 1 << 24), (3, 1_000_003),
                                   (1 << 20, 16), (1000, 1), (7, 3),
                                   (17, 1000), (1, 8192), (1, 4097),
                                   (1, 8193), (2111, 257)])
def test_weighted_scan_long_and_short_rows_match_plain(cuda, shape, dtype):
    """Many rows of one step (four a warp), rows folded in a block (2 to 8
    pieces, empty tail pieces at 4097), few long rows cut into pieces
    (three launches, from 8193 columns), one row of 2^24, a row length
    that is not a multiple of the 8-column run (the element-by-element
    loads), and rows of 1 and 3 columns; x and log_a in the same dtype,
    read as they are."""
    assert_weighted_close(*weighted_inputs(shape, dtype, cuda))


def _weighted_piece_len(rows, n):
    return layout.weighted_scan_plan(rows, n, devmod.sm_count(
        torch.device("cuda"))).length


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", list(range(1, 18)))
def test_weighted_scan_rows_and_piece_edges(cuda, rows, dtype):
    """Rows 1..17 at an n cut into pieces, and n at, one under and one over
    a whole number of pieces."""
    length = _weighted_piece_len(rows, 200_000)
    for n in (200_000, 3 * length - 1, 3 * length, 3 * length + 1):
        assert_weighted_close(*weighted_inputs((rows, n), dtype, cuda,
                                               seed=rows * n))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,la_dtype", [
    (torch.bfloat16, torch.float32), (torch.float16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float16, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(65536, 256), (16, 1 << 20), (5, 999)])
def test_weighted_scan_mixed_dtypes_match_plain(cuda, shape, x_dtype,
                                                la_dtype):
    """A 16-bit x with an f32 log_a is read as it is; another log_a dtype is
    widened to f32 first."""
    assert_weighted_close(*weighted_inputs(shape, x_dtype, cuda, la_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(16, 1 << 20), (300, 256), (3, 100_000)])
def test_weighted_scan_reads_unaligned_views(cuda, rows, n, dtype):
    """Rows that do not start 16-byte aligned: a contiguous view one element
    into its storage, and a column slice (copied to rows of n - 1)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    flat = torch.randn(rows * n + 1, generator=g, device=cuda).to(dtype)
    lflat = (-0.5 * torch.rand(rows * n + 1, generator=g,
                               device=cuda)).to(dtype)
    x, la = flat[1:].view(rows, n), lflat[1:].view(rows, n)
    assert x.data_ptr() % 16 and x.is_contiguous()
    assert_weighted_close(x, la)
    assert_weighted_close(x[:, 1:], la[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 1 << 20), (4096, 300), (1, 1 << 22)])
def test_weighted_scan_with_zero_decay_is_the_prefix_sum(cuda, shape, dtype):
    """log_a = 0: exp is exactly 1 and the weighted scan is the plain
    prefix sum, held at the scan's tolerance (tcu_scan.cu's test)."""
    x = torch.randn(*shape, device=cuda).to(dtype)
    got = kops.weighted_scan(x, torch.zeros_like(x))
    torch.testing.assert_close(got, ref.segmented_scan_ref(x), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 1 << 20), (3, 1_000_003),
                                   (64, 4096)])
def test_weighted_scan_resets_and_underflow_stay_finite(cuda, shape):
    """log_a = -inf (a hard reset: exp is 0) in every 7th column of one
    row, and a row whose summed log-decay underflows exp to 0 (log_a = -1
    throughout): every value is finite and matches the plain version."""
    x, la = weighted_inputs(shape, torch.float32, cuda)
    la[shape[0] // 2, ::7] = float("-inf")
    la[0] = -1.0
    y = kops.weighted_scan(x, la)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, ref.weighted_scan_ref(x, la), rtol=2e-3,
                               atol=2e-3)
    ql = kops.matmul_local_weighted(x, la, 64)
    assert torch.isfinite(ql).all()
    torch.testing.assert_close(ql, ref.local_weighted_ref(x, la, 64),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 1 << 20), (1, 1 << 24),
                                   (65536, 256), (3, 1_000_003), (64, 4096)])
def test_weighted_scans_are_deterministic(cuda, shape):
    """No atomics: two launches on the same input give the same bits."""
    x, la = weighted_inputs(shape, torch.float32, cuda)
    assert torch.equal(kops.weighted_scan(x, la), kops.weighted_scan(x, la))
    assert torch.equal(kops.matmul_local_weighted(x, la, 64),
                       kops.matmul_local_weighted(x, la, 64))


# the tensor-core instance of the SSD chunk body (f16/bf16, q <= 64,
# P <= 64, N <= 128): every product on mma.sync with hi/lo operand pairs,
# a two-stage cp.async ring in ssd_scan.cu


def assert_ssd_close(ins, dtype):
    """ssd_scan against its plain version at the tolerances of
    test_ssd_kernel_matches_plain: y within one rounding of the same f32
    value (1e-2 in f16/bf16, 2e-3 in f32), the f32 state within 2e-3."""
    y, st = kops.ssd_scan(*ins, return_state=True)
    yr, sr = ref.ssd_scan_ref(*ins, return_state=True)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 2e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(st, sr, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [
    (2, 468, 8, 64, 1, 128),      # the served wave: a ragged last chunk
    (2, 5, 4, 64, 1, 128),        # L < 64: fit_block gives q = 16
    (1, 17, 2, 64, 1, 128),       # q = 32
    (3, 40, 2, 64, 1, 128),       # q = 48
    (2, 100, 4, 16, 2, 8),        # N = 8 and P = 16 padded up to the tile
    (2, 130, 4, 64, 2, 128),      # G = 2 with H = 4
    (1, 4096, 8, 64, 1, 128),     # a 64-chunk chain through the ring
])
def test_ssd_mma_instance_matches_plain(cuda, shape, dtype):
    before = kops.instance_counts().get(("ssd_scan", "mma"), 0)
    assert_ssd_close(ssd_inputs(*shape, dtype, cuda), dtype)
    assert kops.instance_counts()[("ssd_scan", "mma")] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ssd_mma_instance_closed_form(cuda, dtype):
    """lambda = 0 (a = 0) and B = C = 1/4 with N = 16, so C_t B_s = 1: y is
    the plain cumulative sum of dt o x over the whole sequence, and the
    final state H[p, n] = sum_s dt_s x_s[p] / 4, across 16 chunks."""
    bsz, seqlen, nheads, hdim, nstate = 2, 1000, 2, 16, 16
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (0.2 * torch.randn(bsz, seqlen, nheads, hdim, generator=g,
                           device=cuda)).to(dtype)
    dt = torch.rand(bsz, seqlen, nheads, generator=g, device=cuda)
    a = torch.zeros(nheads, device=cuda)
    b = torch.full((bsz, seqlen, 1, nstate), 0.25, device=cuda, dtype=dtype)
    y, st = kops.ssd_scan(x, dt, a, b, b.clone(), return_state=True)
    xdt = x.double() * dt.double()[..., None]
    want = torch.cumsum(xdt, 1)
    torch.testing.assert_close(y.double(), want.to(dtype).double(),
                               rtol=1e-2, atol=1e-2)
    want_st = (0.25 * xdt.sum(1))[..., None].expand(-1, -1, -1, nstate)
    torch.testing.assert_close(st.double(), want_st, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_f32_and_weighted_scan_launch_the_fma_instance(cuda):
    """The instance is chosen by dtype and shape before the launch: f32,
    mixed dtypes and a state wider than the tile run the FMA loops; f16/bf16
    at the served shape the tensor cores. The weighted scan runs its own
    kernel, no SSD instance."""
    def launched(fn):
        before = kops.instance_counts()
        fn()
        after = kops.instance_counts()
        return {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}

    ins = ssd_inputs(1, 100, 2, 64, 1, 128, torch.float32, cuda)
    assert launched(lambda: kops.ssd_scan(*ins)) == {("ssd_scan", "fma"): 1}
    mixed = (ins[0].bfloat16(), *ins[1:])
    assert launched(lambda: kops.ssd_scan(*mixed)) == {
        ("ssd_scan", "fma"): 1}
    wide = ssd_inputs(1, 100, 2, 64, 1, 136, torch.bfloat16, cuda)
    assert launched(lambda: assert_ssd_close(wide, torch.bfloat16)) == {
        ("ssd_scan", "fma"): 1}
    # the weighted scan has its own kernel (weighted_scan.cu) and launches
    # no instance of the SSD chunk body
    x = torch.randn(3, 200, device=cuda)
    la = -0.5 * torch.rand(3, 200, device=cuda)
    ws_before = kops.launch_counts()["weighted_scan"]
    assert launched(lambda: kops.weighted_scan(x, la)) == {}
    assert kops.launch_counts()["weighted_scan"] == ws_before + 1
    assert launched(lambda: kops.matmul_local_ssd(*ins, 64)) == {
        ("matmul_local_ssd", "fma"): 1}
    ins16 = ssd_inputs(1, 100, 2, 64, 1, 128, torch.bfloat16, cuda)
    assert launched(lambda: kops.ssd_scan(*ins16)) == {("ssd_scan", "mma"): 1}
    assert launched(lambda: kops.matmul_local_ssd(*ins16, 64)) == {
        ("matmul_local_ssd", "mma"): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["tile", "tile_logdepth"])
def test_ssd_mixed_dtypes_return_y_in_x_dtype(cuda, policy):
    """bf16 x with f32 b, c: the kernels compute in f32 and y comes back in
    the caller's x dtype, as the reference and the plain version return it,
    within the bf16 tolerance of assert_ssd_close."""
    from repro_torch import ops

    x, dt, a, b, c = ssd_inputs(2, 130, 4, 64, 1, 128, torch.float32, cuda)
    x = x.bfloat16()
    y, st = ops.ssd(x, dt, a, b, c, policy=policy, return_state=True)
    yr, sr = ref.ssd_scan_ref(x, dt, a, b, c, return_state=True)
    assert y.dtype == yr.dtype == torch.bfloat16
    assert st.dtype == torch.float32
    torch.testing.assert_close(y, yr, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(st, sr, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_ssd_mma_instance_reads_strided_model_layout(cuda):
    """x, b, c as views of one fused projection (rows 16-byte aligned), and
    as views whose rows are not (the wrapper copies them first); both run
    the tensor-core instance."""
    bsz, seqlen, nheads, hdim, nstate = 2, 150, 4, 64, 128
    for width, off in ((nheads * hdim + 2 * nstate, 0),
                       (nheads * hdim + 2 * nstate + 4, 4)):
        g = torch.Generator(device=cuda).manual_seed(width)
        xbc = (0.2 * torch.randn(bsz, seqlen, width + off, generator=g,
                                 device=cuda)).to(torch.bfloat16)
        d0 = off + nheads * hdim
        x = xbc[..., off:d0].unflatten(-1, (nheads, hdim))
        b = xbc[..., d0:d0 + nstate].unflatten(-1, (1, nstate))
        c = xbc[..., d0 + nstate:d0 + 2 * nstate].unflatten(-1, (1, nstate))
        dt = torch.nn.functional.softplus(
            torch.randn(bsz, seqlen, nheads, generator=g, device=cuda))
        a = -torch.exp(0.2 * torch.randn(nheads, generator=g, device=cuda))
        before = kops.instance_counts().get(("ssd_scan", "mma"), 0)
        assert_ssd_close((x, dt, a, b, c), torch.bfloat16)
        assert kops.instance_counts()[("ssd_scan", "mma")] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [100, 2048])
def test_rmsnorm_kernel_matches_plain(cuda, d, dtype):
    x = torch.randn(33, d, device=cuda).to(dtype)
    w = (torch.rand(d, device=cuda) + 0.5).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(kops.rmsnorm(x, w, eps=1e-5),
                               ref.rmsnorm_ref(x, w, eps=1e-5), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("w_f32", [False, True])
@pytest.mark.parametrize("d", [8, 100, 2048, 4096, 20000])
@pytest.mark.parametrize("rows", [1, 4, 33, 527, 528, 1872])
def test_rmsnorm_kernel_at_each_threads_per_row(cuda, rows, d, w_f32):
    """bf16 rows on both sides of the warp-per-row / block-per-row switch
    (527 and 528 rows), at widths that fill whole 16-byte vectors (2048,
    4096), a part of one (8), none evenly (100), and more than a block's
    registers hold (20000, streamed), with the weight in bf16 or f32.
    Tolerance: the output rounds once to bf16 on both sides."""
    g = torch.Generator(device=cuda).manual_seed(rows * d)
    x = torch.randn(rows, d, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.rand(d, generator=g, device=cuda) + 0.5
    w = w if w_f32 else w.to(torch.bfloat16)
    before = kops.launch_counts()["rmsnorm"]
    torch.testing.assert_close(kops.rmsnorm(x, w, eps=1e-5),
                               ref.rmsnorm_ref(x, w, eps=1e-5), rtol=5e-2,
                               atol=5e-2)
    assert kops.launch_counts()["rmsnorm"] == before + 1


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        kops.segmented_reduce(torch.ones(4, 16, device=cuda,
                                         dtype=torch.float64))
    with pytest.raises(ValueError):
        kops.rmsnorm(torch.ones(4, 16, device=cuda), torch.ones(8,
                                                                device=cuda))


def attention_inputs(bsz, lq, lk, hq, hkv, dh, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    return rn(bsz, lq, hq, dh), rn(bsz, lk, hkv, dh), rn(bsz, lk, hkv, dh)


def row_rel_err(got, want) -> float:
    """Largest error in any output row over that row's RMS in ``want``: an
    error confined to late rows, whose values are small, counts as much as
    one in the first rows."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / rms).max().item()


def assert_attention_close(q, k, v, got, **kw):
    """The kernel against the plain version run in f32 on the same inputs,
    row by row. f16/bf16: within twice the plain version's own distance from
    that f32 run (both round the output; the kernel also rounds P before
    P V, 1.0 to 1.35 times that distance in a CPU emulation of these
    shapes). f32: within 1e-4 (three-part bf16 operands, f32 sums)."""
    want = kops.attention_plain(q.float(), k.float(), v.float(), **kw)
    if q.dtype == torch.float32:
        tol = 1e-4
    else:
        tol = 2.0 * row_rel_err(kops.attention_plain(q, k, v, **kw), want)
    err = row_rel_err(got, want)
    assert err <= tol, f"row-relative error {err:.3e} > {tol:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 256, 256, 4, 2, 64), True, None),      # block-aligned, GQA 4/2
    ((2, 256, 256, 4, 2, 64), False, None),
    ((1, 512, 512, 2, 2, 64), True, 128),       # sliding window
    ((3, 100, 1000, 4, 2, 32), True, None),     # ragged, Lq < Lk
    ((2, 468, 468, 8, 2, 64), True, None),      # a left-padded wave
    ((1, 77, 77, 6, 3, 128), False, 40),        # D = 128, window, no causal
    ((2, 200, 200, 4, 2, 16), True, None),      # D below the 64 instance
    ((2, 200, 200, 4, 2, 48), True, None),
    ((2, 130, 130, 4, 1, 96), True, None),      # D below the 128 instance
    ((2, 40, 40, 4, 2, 64), True, None),        # Lk below one KV tile
    ((3, 1, 300, 8, 2, 64), True, None),        # one query row
    ((1, 2048, 2048, 4, 1, 64), True, 256),     # long, windowed
])
def test_flash_attention_kernel_matches_plain(cuda, shape, causal, window,
                                              dtype):
    q, k, v = attention_inputs(*shape, dtype, cuda)
    before = kops.launch_counts()["flash_attention"]
    got = kops.attention(q, k, v, causal=causal, window=window)
    assert kops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        want = kops.attention_plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert_attention_close(q, k, v, got, causal=causal, window=window)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_strided_model_layout(cuda):
    """q, k, v as views of one fused projection, as a model makes them."""
    qkv = torch.randn(2, 130, 6 * 64, device=cuda, dtype=torch.bfloat16)
    q = qkv[..., :256].unflatten(-1, (4, 64))
    k = qkv[..., 256:320].unflatten(-1, (1, 64))
    v = qkv[..., 320:].unflatten(-1, (1, 64))
    assert_attention_close(q, k, v, kops.attention(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_kernel_copies_views_tma_cannot_read(cuda, dtype):
    """Row strides of 388 elements (776 bytes) and a base 8 bytes past a
    16-byte boundary: TMA cannot read them, so the wrapper copies the views
    and still launches the kernel, once."""
    qkv = torch.randn(2, 130, 388, device=cuda, dtype=dtype)
    q = qkv[..., 4:260].unflatten(-1, (4, 64))
    k = qkv[..., 260:324].unflatten(-1, (1, 64))
    v = qkv[..., 324:388].unflatten(-1, (1, 64))
    before = kops.launch_counts()["flash_attention"]
    got = kops.attention(q, k, v)
    assert kops.launch_counts()["flash_attention"] == before + 1
    assert_attention_close(q, k, v, got)


@pytest.mark.cuda
def test_flash_attention_kernel_raises_on_shapes_it_does_not_take(cuda):
    q, k, v = attention_inputs(1, 32, 32, 2, 2, 100, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        kops.attention(q, k, v)
    q, k, v = attention_inputs(1, 32, 32, 3, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple"):
        kops.attention(q, k, v)
    q, k, v = attention_inputs(1, 32, 32, 2, 2, 256, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        kops.attention(q, k, v)


# ---------------------------------------------------------------------------
# the log-depth family: each local kernel against its plain version, then
# the whole op (local kernel + tree) against the plain version of the op


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape,block_n", [((37, 100), 128),
                                           ((33, 1000), 64),
                                           ((16, 8192), 256),
                                           ((3, (1 << 20) + 3), 256)])
def test_local_scan_kernel_matches_plain(cuda, shape, block_n, dtype):
    x = torch.randn(*shape, device=cuda).to(dtype)
    before = kops.launch_counts()["matmul_local_scan"]
    torch.testing.assert_close(kops.matmul_local_scan(x, block_n),
                               ref.local_scan_ref(x, block_n), rtol=1e-3,
                               atol=1e-2)
    assert kops.launch_counts()["matmul_local_scan"] == before + 1
    torch.testing.assert_close(kops.segmented_scan_logdepth(x),
                               ref.segmented_scan_ref(x), rtol=1e-3,
                               atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,q", [((2, 77), 32), ((5, 300), 64),
                                     ((64, 4096), 64), ((3, 1000), 128)])
def test_local_weighted_kernel_matches_plain(cuda, shape, q):
    x = torch.randn(*shape, device=cuda)
    la = -0.5 * torch.rand(*shape, device=cuda)
    before = kops.launch_counts()["matmul_local_weighted"]
    torch.testing.assert_close(kops.matmul_local_weighted(x, la, q),
                               ref.local_weighted_ref(x, la, q), rtol=1e-4,
                               atol=1e-4)
    assert kops.launch_counts()["matmul_local_weighted"] == before + 1
    torch.testing.assert_close(kops.weighted_scan_logdepth(x, la),
                               ref.weighted_scan_ref(x, la), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [16, 32, 64, 128])
@pytest.mark.parametrize("shape", [(16, 1 << 20), (3, 1_000_003), (1, 5),
                                   (4097, 33)])
def test_local_weighted_kernel_long_and_short_rows(cuda, shape, q):
    """The local pass at every q it takes, on few long rows (cut into
    pieces of whole steps), a ragged row length and rows shorter than a
    block, bf16 inputs (widened by the wrapper) against the plain version
    at 1e-4, one launch each."""
    x, la = weighted_inputs(shape, torch.bfloat16, cuda)
    before = kops.launch_counts()["matmul_local_weighted"]
    torch.testing.assert_close(kops.matmul_local_weighted(x, la, q),
                               ref.local_weighted_ref(x, la, q), rtol=1e-4,
                               atol=1e-4)
    assert kops.launch_counts()["matmul_local_weighted"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 100, 4, 16, 2, 8),
                                   (1, 200, 2, 64, 1, 128),
                                   (2, 468, 4, 64, 1, 128)])
def test_local_ssd_kernel_matches_plain(cuda, shape, dtype):
    ins = ssd_inputs(*shape, dtype, cuda)
    before = kops.launch_counts()["matmul_local_ssd"]
    # both sides compute in f32 from the same inputs and return f32
    for got, want in zip(kops.matmul_local_ssd(*ins, 64),
                         ref.local_ssd_ref(*ins, 64)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert kops.launch_counts()["matmul_local_ssd"] == before + 1
    y, st = kops.ssd_scan_logdepth(*ins, return_state=True)
    yr, sr = ref.ssd_scan_ref(*ins, return_state=True)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 2e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(st, sr, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape,q", [((2, 468, 4, 64, 1, 128), 64),
                                     ((2, 100, 4, 16, 2, 8), 64),
                                     ((2, 130, 4, 64, 2, 128), 64),
                                     ((2, 40, 2, 64, 1, 128), 48),
                                     ((1, 100, 2, 64, 1, 128), 16)])
def test_local_ssd_mma_instance_matches_plain(cuda, shape, q, dtype):
    """The tensor-core local pass at a ragged wave, N = 8, G = 2 and chunks
    below 64, against its plain version at 1e-4 (both return f32 from the
    same inputs)."""
    ins = ssd_inputs(*shape, dtype, cuda)
    before = kops.instance_counts().get(("matmul_local_ssd", "mma"), 0)
    for got, want in zip(kops.matmul_local_ssd(*ins, q),
                         ref.local_ssd_ref(*ins, q)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert kops.instance_counts()[("matmul_local_ssd", "mma")] == before + 1


@pytest.mark.cuda
def test_local_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.randn(4, 100, device=cuda)
    with pytest.raises(RuntimeError, match="matmul_local_scan"):
        kops.matmul_local_scan(x, 48)             # not a multiple of 32
    with pytest.raises(RuntimeError, match="matmul_local_weighted"):
        kops.matmul_local_weighted(x, -x.abs(), 256)   # above 128
    with pytest.raises(TypeError):
        kops.matmul_local_scan(x.double(), 64)
    ins = ssd_inputs(1, 64, 3, 16, 2, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple"):
        kops.matmul_local_ssd(*ins, 64)           # H = 3, G = 2

"""The operand rounding of the tensor-core SSD kernels, emulated on the CPU.

``csrc/ssd_chunk.cuh`` runs the f16/bf16 SSD chunk body on mma.sync: B, C
and X enter exactly in their own 16-bit type, and every operand the kernel
forms in f32 -- G o dt (the masked, decayed C B^T scaled by dt), X o w o dt
(the chunk state's weights) and the carried state H -- enters as a pair of
16-bit values, hi + lo, each multiplied against the exact operand. This
file emulates that rounding in torch (float64 sums of the rounded operands)
and holds the emulated linear scan (state carried across chunks) and the
emulated local pass (each chunk from a zero state) against the JAX package:
``repro.kernels.ref.ssd_scan_ref`` and the Pallas
``repro.kernels.matmul_scan.matmul_local_ssd`` in interpret mode, on numpy
inputs from a seed, at the card's gates: the local pass within 1e-4
(``tests/test_torch_kernels.py``), the scan's y within 8e-3 and its state
within 2e-3 of the largest value (``chip_smoke.py``). One case records that
a single 16-bit rounding of the formed operands misses the local gate,
which is why the pair is there.
"""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import matmul_scan as jmm
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

Q = 64   # the kernels' chunk (kernels/layout.HOPPER["ssd"]["q"])


def ssd_arrays(shape, dtype, seed):
    """The card tests' SSD inputs as numpy f32 arrays: x, b, c rounded to
    ``dtype`` (bf16 or f16), dt and a in f32."""
    bsz, seqlen, nheads, hdim, ngroups, nstate = shape
    rng = np.random.default_rng(seed)
    x = 0.2 * rng.standard_normal((bsz, seqlen, nheads, hdim))
    dt = np.log1p(np.exp(rng.standard_normal((bsz, seqlen, nheads))))
    a = -np.exp(0.2 * rng.standard_normal(nheads))
    b = rng.standard_normal((bsz, seqlen, ngroups, nstate)) * nstate ** -0.5
    c = rng.standard_normal((bsz, seqlen, ngroups, nstate)) * nstate ** -0.5
    np16 = ml_dtypes.bfloat16 if dtype == torch.bfloat16 else np.float16
    x, b, c = (t.astype(np16).astype(np.float32) for t in (x, b, c))
    return x, dt.astype(np.float32), a.astype(np.float32), b, c


def rounded(v: torch.Tensor, dtype, pairs: bool) -> torch.Tensor:
    """An f32 operand as the kernel hands it to the tensor cores: hi + lo
    (``pairs``) or hi alone, as float64."""
    hi = v.to(dtype)
    out = hi.double()
    if pairs:
        out = out + (v - hi.float()).to(dtype).double()
    return out


def emulate(x, dt, a, b, c, *, q, dtype, pairs=True, carry):
    """The tensor-core chunk body on numpy inputs, in torch.

    With ``carry`` the linear scan: returns y (B, L, H, P) rounded to
    ``dtype`` and the final state (B, H, P, N). Without, the local pass:
    y_local (B, L, H, P) and the chunk states (B, H, nchunks, N, P), f32.
    Products of exact operands are summed in float64 and rounded to f32,
    as the tensor cores' f32 accumulation leaves them to within its
    summation order."""
    x, dt, a, b, c = (torch.from_numpy(t) for t in (x, dt, a, b, c))
    bsz, seqlen, nheads, hdim = x.shape
    rep = nheads // b.shape[2]
    nc = -(-seqlen // q)

    def chunks(t):          # (B, L, H, ...) -> (B, H, nc, q, ...), zeros past L
        t = tref.pad_chunks(t, q)                   # (B, nc, q, H, ...)
        return t.movedim(3, 1)

    xs = chunks(x)                                  # (B, H, nc, q, P)
    dts = chunks(dt)                                # (B, H, nc, q)
    lam = dts * a[None, :, None, None]
    bs = chunks(torch.repeat_interleave(b, rep, 2))  # (B, H, nc, q, N)
    cs = chunks(torch.repeat_interleave(c, rep, 2))
    idx = torch.arange(q)
    below = idx[:, None] >= idx[None, :]            # s <= t

    h = torch.zeros(bsz, nheads, hdim, b.shape[3])  # H^T (P, N), f32
    ys, states = [], []
    for j in range(nc):
        cum = torch.cumsum(lam[:, :, j], -1)        # (B, H, q) f32
        last = cum[..., -1:]
        cb = torch.einsum("bhtn,bhsn->bhts", cs[:, :, j].double(),
                          bs[:, :, j].double()).float()
        diff = cum[..., :, None] - cum[..., None, :]
        gd = torch.where(below, cb * torch.exp(torch.where(below, diff, 0.0))
                         * dts[:, :, j, None, :], 0.0)
        y = torch.einsum("bhts,bhsp->bhtp", rounded(gd, dtype, pairs),
                         xs[:, :, j].double())
        if carry:
            inter = torch.einsum("bhtn,bhpn->bhtp", cs[:, :, j].double(),
                                 rounded(h, dtype, pairs))
            y = y + torch.exp(cum).double()[..., None] * inter
        w = torch.exp(last - cum) * dts[:, :, j]    # (B, H, q)
        xw = rounded(xs[:, :, j] * w[..., None], dtype, pairs)
        s = torch.einsum("bhsp,bhsn->bhpn", xw, bs[:, :, j].double()).float()
        h = torch.exp(last)[..., None] * h + s if carry else s
        ys.append(y.float())
        states.append(s.transpose(-1, -2))          # (B, H, N, P)
    y = torch.stack(ys, 2).flatten(2, 3)[:, :, :seqlen].movedim(1, 2)
    if carry:
        return y.to(dtype).float(), h
    return y, torch.stack(states, 2)


def local_ref(x, dt, a, b, c, q):
    """The local pass from the JAX package's sequential reference: every
    chunk of q steps scanned from a zero state; its final state, (N, P), is
    the chunk state."""
    bsz, seqlen, nheads, hdim = x.shape
    nc = -(-seqlen // q)
    pad = nc * q - seqlen

    def fold(t):            # (B, L, ...) -> (B * nc, q, ...), zeros past L
        t = np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
        return t.reshape(bsz * nc, q, *t.shape[2:])

    y, st = jref.ssd_scan_ref(*(jnp.asarray(fold(t)) for t in (x, dt)),
                              jnp.asarray(a),
                              *(jnp.asarray(fold(t)) for t in (b, c)),
                              return_state=True)
    y = np.asarray(y).reshape(bsz, nc * q, nheads, hdim)[:, :seqlen]
    st = np.asarray(st).reshape(bsz, nc, nheads, hdim, -1)
    return y, np.moveaxis(st, 2, 1).swapaxes(-1, -2)   # (B, H, nc, N, P)


def max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


# the card tests' shapes of the local pass: a ragged served wave, and a
# chain of 200 steps over two heads
SHAPES = [(2, 468, 4, 64, 1, 128), (1, 200, 2, 64, 1, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", SHAPES)
def test_operand_pairs_hold_the_local_pass_to_its_gate(shape, dtype):
    arrs = ssd_arrays(shape, dtype, seed=shape[1])
    y, s = emulate(*arrs, q=Q, dtype=dtype, carry=False)
    want_y, want_s = local_ref(*arrs, Q)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-4, atol=1e-4)


def test_a_single_bf16_rounding_misses_the_local_gate():
    """One bf16 rounding of G o dt and X o w o dt, where the kernel uses a
    pair, leaves errors of several 1e-4 on y_local and the chunk states:
    over the card's 1e-4, which the pair meets with two orders to spare."""
    arrs = ssd_arrays(SHAPES[0], torch.bfloat16, seed=SHAPES[0][1])
    want_y, want_s = local_ref(*arrs, Q)
    one = emulate(*arrs, q=Q, dtype=torch.bfloat16, pairs=False, carry=False)
    two = emulate(*arrs, q=Q, dtype=torch.bfloat16, carry=False)
    one_err = max(max_err(one[0], want_y), max_err(one[1], want_s))
    two_err = max(max_err(two[0], want_y), max_err(two[1], want_s))
    assert one_err > 1e-4, one_err
    assert two_err < 1e-4 / 20, two_err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(2, 468, 4, 64, 1, 128),
                                   (1, 1000, 2, 64, 2, 128),
                                   (2, 100, 4, 16, 2, 8)])
def test_operand_pairs_hold_the_scan_to_its_gates(shape, dtype):
    """The linear scan with H carried across chunks (the pair of H enters
    C H), its y rounded to the 16-bit type once, against the JAX package's
    sequential reference: y within 8e-3 and the f32 state within 2e-3 of
    the largest value, chip_smoke.py's gates."""
    arrs = ssd_arrays(shape, dtype, seed=shape[1] + 1)
    y, h = emulate(*arrs, q=Q, dtype=dtype, carry=True)
    want_y, want_h = jref.ssd_scan_ref(*map(jnp.asarray, arrs),
                                       return_state=True)
    want_y, want_h = np.asarray(want_y), np.asarray(want_h)
    assert max_err(y, want_y) <= 8e-3 * max(1.0, np.abs(want_y).max())
    assert max_err(h, want_h) <= 2e-3 * max(1.0, np.abs(want_h).max())


def test_emulated_local_pass_matches_the_pallas_kernel():
    """The emulation's chunk body against the JAX package's Pallas local
    kernel in interpret mode, at the chunk and widths that kernel takes
    (q and P multiples of 128), in the folded layout it reads."""
    shape, q = (1, 256, 2, 128, 1, 16), 128
    x, dt, a, b, c = ssd_arrays(shape, torch.bfloat16, seed=7)
    bsz, seqlen, nheads, hdim, ngroups, nstate = shape

    def fold(t):                       # (B, L, H, ...) -> (B*H, L, ...)
        return np.moveaxis(t, 2, 1).reshape(bsz * nheads, seqlen,
                                            *t.shape[3:])

    rep = nheads // ngroups
    y_j, s_j = jmm.matmul_local_ssd(
        *map(jnp.asarray, (fold(x * dt[..., None]),
                           fold((dt * a)[..., None])[..., 0],
                           fold(np.repeat(b, rep, 2)),
                           fold(np.repeat(c, rep, 2)))), q=q, interpret=True)
    y, s = emulate(x, dt, a, b, c, q=q, dtype=torch.bfloat16, carry=False)
    np.testing.assert_allclose(
        y.movedim(2, 1).reshape(bsz * nheads, seqlen, hdim).numpy(),
        np.asarray(y_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.reshape(bsz * nheads, -1, hdim).numpy(),
                               np.asarray(s_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q", [16, 48, 64])
def test_emulated_local_pass_matches_the_ports_plain_version(q):
    """The emulation against ``local_ssd_ref``, the plain version the card
    holds the kernel against, at the chunks the kernel takes (q <= 64)."""
    arrs = ssd_arrays((2, 100, 4, 16, 2, 8), torch.bfloat16, seed=q)
    y, s = emulate(*arrs, q=q, dtype=torch.bfloat16, carry=False)
    want_y, want_s = tref.local_ssd_ref(*map(torch.from_numpy, arrs), q)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, want_s, rtol=1e-4, atol=1e-4)

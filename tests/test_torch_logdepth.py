"""Parity of the port's log-depth MatMulScan family with the JAX package.

The same numpy inputs, made from a seed, go through
``repro.kernels.matmul_scan`` / ``repro.core.dispatch`` under
``path="tile_logdepth"`` (local Pallas kernels in interpret mode, the XLA
tree) and through ``repro_torch`` under ``policy="tile_logdepth"``. On the
CPU each port wrapper runs its local kernel's plain version and then the
same torch tree as on the card, so these tests exercise the log-depth
algorithm itself. Tolerances are those of ``tests/test_logdepth_scan.py``:
tree rtol 1e-5 / atol 1e-4; scan f32 1e-5 / 1e-3, bf16 2e-2 / 2e-1;
weighted 1e-4 / 1e-3; SSD 1e-3 / 1e-3. The CUDA kernels themselves are
tested on the card by ``tests/test_torch_kernels.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro_torch.ops as tops
from repro.core import dispatch as jdispatch
from repro.kernels import matmul_scan as jmm
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import layout as tlayout
from repro_torch.kernels import matmul_scan as tmm
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref


def close(got, want, rtol, atol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol)


def arrays(seed, *shapes, low=None):
    """float32 numpy arrays from one seed: normal, or uniform in
    ``[low, 0)`` (log decays) when ``low`` is given."""
    rng = np.random.default_rng(seed)
    if low is not None:
        return [rng.uniform(low, 0.0, s).astype(np.float32) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def to_both(a, dtype="float32"):
    """One numpy array as equal (jax, torch) values; bf16 via ml_dtypes."""
    if dtype == "bfloat16":
        ab = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(ab), torch.from_numpy(
            ab.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# the tree combines


def jit_tree(fn, radix):
    """The reference tree jitted whole: one compile instead of one per
    eager op of every recursion level."""
    return jax.jit(functools.partial(fn, radix=radix, fan_in=radix))


@pytest.mark.parametrize("radix", [2, 4, 16])
@pytest.mark.parametrize("m", [1, 3, 16, 17, 64, 257, 1024])
def test_tree_scan_matches_jax(m, radix):
    (t,) = arrays(m, (5, m))
    want = jit_tree(jmm.tree_scan, radix)(jnp.asarray(t))
    got = tmm.tree_scan(torch.from_numpy(t), radix=radix, fan_in=radix)
    close(got, want, rtol=1e-5, atol=1e-4)
    close(got, np.cumsum(t.astype(np.float64), -1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("radix", [2, 4, 16])
@pytest.mark.parametrize("m", [1, 3, 16, 17, 64, 257, 1024])
def test_tree_weighted_matches_jax(m, radix):
    """Trailing features, as the SSD glue runs the tree over N * P."""
    (t,) = arrays(m, (2, m, 3))
    (logp,) = arrays(m + 1, (2, m), low=-1.0)
    want = jit_tree(jmm.tree_weighted, radix)(jnp.asarray(logp),
                                              jnp.asarray(t))
    got = tmm.tree_weighted(torch.from_numpy(logp), torch.from_numpy(t),
                            radix=radix, fan_in=radix)
    close(got, want, rtol=1e-5, atol=1e-4)


def test_shift_right_is_a_shift():
    x = torch.tensor([[1e8, 1.0, -1e8, 2.0]])
    torch.testing.assert_close(tmm.shift_right(x, -1),
                               torch.tensor([[0.0, 1e8, 1.0, -1e8]]))
    x3 = torch.arange(12.0).reshape(2, 3, 2)
    got = tmm.shift_right(x3, 1)
    assert torch.equal(got[:, 0], torch.zeros(2, 2))
    assert torch.equal(got[:, 1:], x3[:, :-1])


# ---------------------------------------------------------------------------
# each local kernel's plain version against the JAX local kernel, run in
# interpret mode at aligned shapes (block_s % 8, block_n % 128, q % 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_scan_plain_matches_jax_kernel(dtype):
    (x,) = arrays(1, (16, 384))
    jx, tx = to_both(x, dtype)
    want = jmm.matmul_local_scan(jx, block_s=8, block_n=128, interpret=True)
    close(tref.local_scan_ref(tx, 128), want, rtol=1e-5, atol=1e-4)


def test_local_weighted_plain_matches_jax_kernel():
    (x,) = arrays(2, (4, 256))
    (la,) = arrays(3, (4, 256), low=-0.5)
    want = jmm.matmul_local_weighted(jnp.asarray(x), jnp.asarray(la), q=128,
                                     interpret=True)
    got = tref.local_weighted_ref(torch.from_numpy(x), torch.from_numpy(la),
                                  128)
    close(got, want, rtol=1e-4, atol=1e-4)


def test_local_ssd_plain_matches_jax_kernel():
    """The JAX kernel takes the folded layout (B*H, L, P) with dt folded
    into x and B/C repeated per head; the port's plain version takes the
    model layout and returns the same y_local and chunk states."""
    bsz, seqlen, nheads, hdim, ngroups, nstate, q = 1, 256, 2, 128, 1, 16, 128
    x, b, c = arrays(4, (bsz, seqlen, nheads, hdim),
                     (bsz, seqlen, ngroups, nstate),
                     (bsz, seqlen, ngroups, nstate))
    rng = np.random.default_rng(5)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, seqlen, nheads)))
                  ).astype(np.float32)
    a = -np.exp(0.2 * rng.standard_normal(nheads)).astype(np.float32)
    b, c = b / 4, c / 4
    rep = nheads // ngroups

    def fold(t):                       # (B, L, H, ...) -> (B*H, L, ...)
        return np.moveaxis(t, 2, 1).reshape(bsz * nheads, seqlen,
                                            *t.shape[3:])

    xdt = fold(x * dt[..., None])
    lam = fold((dt * a)[..., None])[..., 0]
    y_j, s_j = jmm.matmul_local_ssd(
        *map(jnp.asarray, (xdt, lam, fold(np.repeat(b, rep, 2)),
                           fold(np.repeat(c, rep, 2)))), q=q, interpret=True)
    y, s = tref.local_ssd_ref(*map(torch.from_numpy, (x, dt, a, b, c)), q)
    close(y.movedim(2, 1).reshape(bsz * nheads, seqlen, hdim), y_j,
          rtol=1e-4, atol=1e-4)
    close(s.reshape(bsz * nheads, -1, hdim), s_j, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the public ops under tile_logdepth against the JAX package's, ragged


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-5, 1e-3),
                                             ("bfloat16", 2e-2, 2e-1)])
@pytest.mark.parametrize("n", [100, 700])
def test_scan_logdepth_matches_jax(n, dtype, rtol, atol, exclusive):
    (x,) = arrays(n, (3, 2, n))
    jx, tx = to_both(x, dtype)
    want = jdispatch.scan(jx, path="tile_logdepth", exclusive=exclusive)
    got = tops.scan(tx, policy="tile_logdepth", exclusive=exclusive)
    assert got.dtype == torch.float32 and got.shape == tx.shape
    close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_logdepth_long_ragged_row(exclusive):
    """2^20 + 3: 4097 blocks, the last of them 3 wide, and a tree of three
    levels. The reference would interpret thousands of grid steps here, so
    this case is held against float64 numpy."""
    n = (1 << 20) + 3
    (x,) = arrays(7, (2, n))
    got = tops.scan(torch.from_numpy(x), policy="tile_logdepth",
                    exclusive=exclusive)
    want = np.cumsum(x.astype(np.float64), -1)
    if exclusive:
        want = np.concatenate([np.zeros((2, 1)), want[:, :-1]], -1)
    close(got, want, rtol=1e-5, atol=1e-3)


def test_exclusive_scan_logdepth_adversarial_magnitudes():
    """exclusive[i] stays exact when the prefix is small and x[i] huge, in
    the second block, where the tree's carry enters: the port shifts, never
    subtracts (``inclusive - x`` would round the prefix 27 to a multiple of
    8 next to 1e8)."""
    x = torch.full((1, 300), 0.1)
    x[0, 270], x[0, 271] = 1e8, -1e8
    got = tops.scan(x, policy="tile_logdepth", exclusive=True)[0]
    want = np.concatenate([[0.0], np.cumsum(x.double().numpy()[0])[:-1]])
    close(got[:271], want[:271], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [100, 700])
def test_weighted_scan_logdepth_matches_jax(n):
    (x,) = arrays(n, (3, n))
    (la,) = arrays(n + 1, (3, n), low=-1.0)
    want = jdispatch.weighted_scan(jnp.asarray(x), jnp.asarray(la),
                                   path="tile_logdepth")
    got = tops.weighted_scan(torch.from_numpy(x), torch.from_numpy(la),
                             policy="tile_logdepth")
    close(got, want, rtol=1e-4, atol=1e-3)


def ssd_arrays(seqlen, seed=5, b=2, h=4, p=32, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = (0.2 * rng.standard_normal((b, seqlen, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, seqlen, h)))
                  ).astype(np.float32)
    a = (-np.exp(0.2 * rng.standard_normal(h))).astype(np.float32)
    bb = (rng.standard_normal((b, seqlen, g, n)) / np.sqrt(n)
          ).astype(np.float32)
    cc = (rng.standard_normal((b, seqlen, g, n)) / np.sqrt(n)
          ).astype(np.float32)
    return x, dt, a, bb, cc


@pytest.mark.parametrize("seqlen", [200, 384, 468])
def test_ssd_logdepth_matches_jax(seqlen):
    arrs = ssd_arrays(seqlen)
    want_y, want_s = jdispatch.ssd(*map(jnp.asarray, arrs),
                                   path="tile_logdepth", return_state=True)
    got_y, got_s = tops.ssd(*map(torch.from_numpy, arrs),
                            policy="tile_logdepth", return_state=True)
    assert got_s.shape == (2, 4, 32, 16)          # (B, H, P, N)
    close(got_y, want_y, rtol=1e-3, atol=1e-3)
    close(got_s, want_s, rtol=1e-3, atol=1e-3)


def test_ssd_logdepth_single_chunk_and_one_step():
    """L within one chunk (no tree level) and L = 1, against the port's
    sequential oracle."""
    for seqlen in (1, tlayout.HOPPER["ssd_logdepth"]["q"]):
        ins = [torch.from_numpy(t) for t in ssd_arrays(seqlen, seed=seqlen)]
        y, s = tops.ssd(*ins, policy="tile_logdepth", return_state=True)
        yr, sr = tref.ssd_scan_ref(*ins, return_state=True)
        close(y, yr, rtol=1e-5, atol=1e-5)
        close(s, sr, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the CPU path runs the tree, gradients, policy


def test_cpu_path_runs_the_local_pass_and_the_tree(monkeypatch):
    calls = []
    for name in ("tree_scan", "tree_weighted"):
        real = getattr(tkops, name)
        monkeypatch.setattr(
            tkops, name,
            lambda *a, _real=real, _name=name, **k: calls.append(_name)
            or _real(*a, **k))
    tkops.reset_launches()
    (x,) = arrays(8, (3, 1000))
    (la,) = arrays(9, (3, 1000), low=-0.5)
    tx, tla = torch.from_numpy(x), torch.from_numpy(la)
    close(tkops.segmented_scan_logdepth(tx), np.cumsum(x, -1), rtol=1e-5,
          atol=1e-3)
    close(tkops.weighted_scan_logdepth(tx, tla),
          tref.weighted_scan_ref(tx, tla), rtol=1e-4, atol=1e-3)
    ins = [torch.from_numpy(t) for t in ssd_arrays(200)]
    tkops.ssd_scan_logdepth(*ins)
    assert calls == ["tree_scan", "tree_weighted", "tree_weighted"]
    assert tkops.launch_counts() == {k: 0 for k in tkops.KERNELS}


def test_gradients_under_logdepth_equal_the_plain_ops():
    torch.manual_seed(0)
    x = torch.randn(3, 300, requires_grad=True)
    la = (-torch.rand(3, 300)).requires_grad_()
    w = torch.randn(3, 300)
    for fn, plain in (
            (lambda: tops.scan(x, policy="tile_logdepth", exclusive=True),
             lambda: torch.cat([torch.zeros(3, 1),
                                torch.cumsum(x, -1)[:, :-1]], -1)),
            (lambda: tops.weighted_scan(x, la, policy="tile_logdepth"),
             lambda: tref.weighted_scan_ref(x, la))):
        g = torch.autograd.grad((fn() * w).sum(), (x, la), allow_unused=True)
        r = torch.autograd.grad((plain() * w).sum(), (x, la),
                                allow_unused=True)
        for a, b in zip(g, r):
            if b is None:
                assert a is None or not a.abs().any()
            else:
                torch.testing.assert_close(a, b)
    ins = [torch.from_numpy(t).requires_grad_() for t in ssd_arrays(100)]
    y, s = tops.ssd(*ins, policy="tile_logdepth", return_state=True)
    g = torch.autograd.grad(y.sum() + s.sum(), ins)
    yr, sr = tref.ssd_scan_ref(*ins, return_state=True)
    gr = torch.autograd.grad(yr.sum() + sr.sum(), ins)
    for a, b in zip(g, gr):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("op", ["reduce", "rmsnorm", "attention"])
def test_policy_raises_outside_the_scan_family(op):
    x = torch.randn(2, 8, 4, 16)
    call = {"reduce": lambda p: tops.reduce(x, policy=p),
            "rmsnorm": lambda p: tops.rmsnorm(x, torch.ones(16), policy=p),
            "attention": lambda p: tops.attention(x, x, x, policy=p)}[op]
    with pytest.raises(RuntimeError, match="scan family"):
        call("tile_logdepth")
    with pytest.raises(RuntimeError, match="scan, weighted_scan, ssd"):
        call(f"{op}=tile_logdepth")


def test_policy_routes_the_scan_family():
    pol = "ssd=tile_logdepth"
    assert tpolicy.resolve(pol, "ssd") == "tile_logdepth"
    assert tpolicy.resolve(pol, "rmsnorm") == "tile"
    for op in tpolicy.LOGDEPTH_OPS:
        assert tpolicy.resolve("tile_logdepth", op) == "tile_logdepth"
    assert tpolicy.resolve("tile_logdepth,reduce=tile", "reduce") == "tile"


def test_registry_lists_the_three_local_kernels():
    for name, line in (("matmul_local_scan", 211),
                       ("matmul_local_weighted", 255),
                       ("matmul_local_ssd", 325)):
        k = tkops.KERNELS[name]
        assert k.source == "src/repro_torch/csrc/matmul_scan.cu"
        assert k.replaces == f"src/repro/kernels/matmul_scan.py:{line}"

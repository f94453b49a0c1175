"""Parity of the PyTorch port's ops (``repro_torch``) with the JAX package.

The same numpy inputs, made from a seed, go through ``repro.ops`` (Pallas
kernels in interpret mode, the fused XLA forms, the oracles) and through
``repro_torch.ops`` on every port path (``tile`` runs each kernel's plain
version on the CPU, ``fused``, ``baseline``). Tolerances are those of
``tests/test_kernels.py`` for the same op, or tighter, and are stated at
each test. The CUDA kernels themselves are tested on the card by
``tests/test_torch_kernels.py``.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.ops as jops
import repro_torch.ops as tops
from repro.core import reduce as jreduce
from repro.core import scan as jscan
from repro.core import ssd as jssd
from repro.core import tiles as jtiles
from repro.kernels import layout as jlayout
from repro.kernels import ref as jref
from repro_torch.core import policy as tpolicy
from repro_torch.core import reduce as treduce
from repro_torch.core import scan as tscan
from repro_torch.core import ssd as tssd
from repro_torch.core import tiles as ttiles
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import layout as tlayout
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref

PORT_PATHS = ("tile", "fused", "baseline")
JAX_PATHS = ("interpret", "fused")
SRC = Path(__file__).resolve().parent.parent / "src"


def pair(shape, dtype="float32", seed=0, scale=1.0, low=None, high=None):
    """One numpy input as a (jax array, torch tensor) pair with equal
    values; bf16 goes through ml_dtypes on both sides."""
    rng = np.random.default_rng(seed)
    if low is not None:
        x = rng.uniform(low, high, shape).astype(np.float32)
    else:
        x = (scale * rng.standard_normal(shape)).astype(np.float32)
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(xb), torch.from_numpy(
            xb.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol)


def jax_outputs(fn):
    return {p: np.asarray(fn(p), np.float32) for p in JAX_PATHS}


# ---------------------------------------------------------------------------
# the public ops, every port path against every JAX path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 100, 256, 1024])
def test_reduce_matches_jax(n, dtype):
    jx, tx = pair((3, 4, n), dtype, seed=n)
    want = jax_outputs(lambda p: jops.reduce(jx, policy=p))
    want["ref"] = np.asarray(jref.segmented_reduce_ref(jx))
    for path in PORT_PATHS:
        got = tops.reduce(tx, policy=path)
        assert got.dtype == torch.float32 and got.shape == (3, 4)
        for w in want.values():
            close(got, w, rtol=1e-4, atol=1e-3)   # test_kernels' wrapper tol


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 100, 256, 1024])
def test_scan_matches_jax(n, dtype, exclusive):
    jx, tx = pair((5, n), dtype, seed=n + 1)
    want = jax_outputs(lambda p: jops.scan(jx, policy=p, exclusive=exclusive))
    for path in PORT_PATHS:
        got = tops.scan(tx, policy=path, exclusive=exclusive)
        assert got.dtype == torch.float32 and got.shape == (5, n)
        for w in want.values():
            close(got, w, rtol=1e-3, atol=1e-2)   # test_kernels' wrapper tol


@pytest.mark.parametrize("path", PORT_PATHS)
def test_exclusive_scan_adversarial_magnitudes(path):
    """exclusive[i] stays exact when the prefix is tiny and x[i] huge: the
    port shifts, never subtracts (as repro.core.dispatch does)."""
    x = torch.tensor([0.1, 0.2, 0.3, 1e8, -1e8, 0.4], dtype=torch.float32)
    got = tops.scan(x, policy=path, exclusive=True).numpy()
    want = np.concatenate([[0.0], np.cumsum(x.double().numpy())[:-1]])
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-6, atol=1e-6)
    assert got.shape == (6,)


@pytest.mark.parametrize("n", [16, 100, 300])
def test_weighted_scan_matches_jax(n):
    jx, tx = pair((4, n), seed=n)
    jla, tla = pair((4, n), seed=n + 7, low=-0.5, high=0.0)
    # the Pallas interpreter is slow here: one length (padded, one chunk)
    paths = JAX_PATHS if n == 100 else ("fused",)
    want = {p: np.asarray(jops.weighted_scan(jx, jla, policy=p))
            for p in paths}
    want["ref"] = np.asarray(jref.weighted_scan_ref(jx, jla))
    for path in PORT_PATHS:
        got = tops.weighted_scan(tx, tla, policy=path)
        for w in want.values():
            close(got, w, rtol=2e-3, atol=2e-3)   # SSD-kernel tolerance


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (3, 5, 256), (7, 100)])
def test_rmsnorm_matches_jax(shape, dtype):
    jx, tx = pair(shape, dtype, seed=shape[-1])
    jw, tw = pair(shape[-1:], dtype, seed=1, low=0.5, high=1.5)
    want = jax_outputs(lambda p: jops.rmsnorm(jx, jw, eps=1e-5, policy=p))
    # f32: one rounding of the same f32 formula; bf16: test_kernels' 5e-2
    tol = 1e-5 if dtype == "float32" else 5e-2
    for path in PORT_PATHS:
        got = tops.rmsnorm(tx, tw, eps=1e-5, policy=path)
        assert got.dtype == tx.dtype
        for w in want.values():
            close(got, w, rtol=tol, atol=tol)


def ssd_pair(bsz, seqlen, nheads, hdim, ngroups, nstate, seed):
    x = pair((bsz, seqlen, nheads, hdim), seed=seed, scale=0.2)
    dt_raw = np.random.default_rng(seed + 1).standard_normal(
        (bsz, seqlen, nheads)).astype(np.float32)
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)       # softplus
    a = -np.exp(0.2 * np.random.default_rng(seed + 2).standard_normal(
        nheads)).astype(np.float32)
    b = pair((bsz, seqlen, ngroups, nstate), seed=seed + 3,
             scale=nstate ** -0.5)
    c = pair((bsz, seqlen, ngroups, nstate), seed=seed + 4,
             scale=nstate ** -0.5)
    jins = (x[0], jnp.asarray(dt), jnp.asarray(a), b[0], c[0])
    tins = (x[1], torch.from_numpy(dt), torch.from_numpy(a), b[1], c[1])
    return jins, tins


@pytest.mark.parametrize("shape", [(2, 100, 4, 16, 2, 8),
                                   (1, 200, 2, 8, 1, 16)])
def test_ssd_matches_jax(shape):
    jins, tins = ssd_pair(*shape, seed=shape[1])
    want = {p: jops.ssd(*jins, policy=p, return_state=True)
            for p in JAX_PATHS}
    want["ref"] = jref.ssd_scan_ref(*jins, return_state=True)
    for path, kw in (("tile", {}), ("fused", {}), ("fused", {"chunk": 32}),
                     ("baseline", {})):
        y, state = tops.ssd(*tins, policy=path, return_state=True, **kw)
        assert y.shape == shape[:4] and state.shape == (
            shape[0], shape[2], shape[3], shape[5])
        for wy, ws in want.values():
            close(y, wy, rtol=2e-3, atol=2e-3)     # test_kernels' SSD tol
            close(state, ws, rtol=2e-3, atol=2e-3)


def test_ssd_bf16_fused_matmul_dtype_matches_jax():
    """``matmul_dtype`` rounds the large products' operands, as the
    reference's ``preferred_element_type`` form does."""
    jins, tins = ssd_pair(2, 64, 4, 16, 2, 8, seed=5)
    wy, ws = jssd.ssd_chunked(*jins, chunk=32, matmul_dtype=jnp.bfloat16)
    y, s = tssd.ssd_chunked(*tins, chunk=32, matmul_dtype=torch.bfloat16)
    close(y, wy, rtol=2e-3, atol=2e-3)
    close(s, ws, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# core modules, one by one


@pytest.mark.parametrize("t", [8, 16])
def test_tiles_match_jax(t):
    for jf, tf in ((jtiles.p_matrix, ttiles.p_matrix),
                   (jtiles.u_matrix, ttiles.u_matrix),
                   (jtiles.strict_u_matrix, ttiles.strict_u_matrix),
                   (jtiles.l_matrix, ttiles.l_matrix),
                   (jtiles.ones_matrix, ttiles.ones_matrix)):
        np.testing.assert_array_equal(tf(t).numpy(), np.asarray(jf(t)))
    jla, tla = pair((3, t), seed=t, low=-1.0, high=0.0)
    np.testing.assert_allclose(ttiles.segsum(tla).numpy(),
                               np.asarray(jtiles.segsum(jla)), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("formulation", ["fused", "tile"])
@pytest.mark.parametrize("n", [10, 16, 300])
def test_core_reduce_formulations_match_jax(n, formulation):
    jx, tx = pair((2, 3, n), seed=n)
    want = jreduce.tcu_segmented_reduce(jx, tile=16, formulation=formulation)
    got = treduce.tcu_segmented_reduce(tx, tile=16, formulation=formulation)
    close(got, want, rtol=1e-5, atol=1e-5)
    close(treduce.tcu_reduce(tx, tile=16), jreduce.tcu_reduce(jx, tile=16),
          rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("n", [5, 16, 300, 5000])
def test_core_scan_recursion_matches_jax(n, exclusive):
    """Tile 16 and n = 5000 recurse three levels deep."""
    jx, tx = pair((2, n), seed=n)
    want = jscan.tcu_scan(jx, tile=16, exclusive=exclusive)
    got = tscan.tcu_scan(tx, tile=16, exclusive=exclusive)
    close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", [12, 16, 300])
def test_core_weighted_scan_matches_jax(n):
    jx, tx = pair((3, n), seed=n)
    jla, tla = pair((3, n), seed=n + 1, low=-0.5, high=0.0)
    close(tscan.tcu_weighted_scan(tx, tla, tile=16),
          jscan.tcu_weighted_scan(jx, jla, tile=16), rtol=1e-4, atol=1e-4)


def test_core_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((2, 4, 8, 16), (2, 4, 8), (2, 4), (4,), (2, 2, 16), (2, 2, 16))]
    arrs[2] = np.log1p(np.exp(arrs[2]))
    arrs[3] = -np.exp(arrs[3])
    wy, ws = jssd.ssd_decode_step(*map(jnp.asarray, arrs))
    y, s = tssd.ssd_decode_step(*map(torch.from_numpy, arrs))
    close(y, wy, rtol=1e-5, atol=1e-5)
    close(s, ws, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,block,mult", [(100, 64, 16), (5, 64, 16),
                                             (1000, 100, 16), (0, 64, 16)])
def test_layout_fit_block_matches_jax(size, block, mult):
    assert tlayout.fit_block(size, block, mult) == jlayout.fit_block(
        size, block, mult)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [1, 8, 100, 2048, 4096, 100_000])
@pytest.mark.parametrize("rows", [1, 4, 33, 527, 528, 1872])
def test_rmsnorm_threads_per_row_fit_rows_and_cover_d(rows, d, itemsize):
    """rmsnorm.cu's threads per row: a power of two from a warp to 256;
    below ``many_rows`` rows a block per row (one 16-byte vector a thread
    where the row allows, so that 4 decode rows use 4 SMs), from there a
    warp or a few per row; and the row always fits the threads' registers
    unless it is longer than 256 threads' worth."""
    geo = tlayout.HOPPER["rmsnorm"]
    tpr = tlayout.rmsnorm_threads(rows, d, itemsize)
    assert tpr & (tpr - 1) == 0 and 32 <= tpr <= 256
    nvec = -(-d // (16 // itemsize))
    if tpr < 256:
        assert -(-nvec // tpr) <= geo["max_vectors"]
    else:
        assert nvec > 128 or rows < geo["many_rows"]
    if rows < geo["many_rows"]:
        assert tpr == max(32, min(256, 1 << (nvec - 1).bit_length()))
    else:
        assert -(-nvec // tpr) <= geo["vectors_many"] or tpr == 256


def test_flash_wrapper_copies_only_views_tma_cannot_read():
    """The f16/bf16 flash kernel reads q, k, v through TMA tensor maps: a
    16-byte aligned base, and strides that are multiples of 16 bytes
    wherever the extent is above 1. The wrapper copies any other view."""
    qkv = torch.zeros(2, 130, 388, dtype=torch.bfloat16)
    assert tkops._tma_ready(qkv[..., :256].unflatten(-1, (4, 64))) is False
    fused = torch.zeros(2, 130, 384, dtype=torch.bfloat16)
    assert tkops._tma_ready(fused[..., 256:320].unflatten(-1, (1, 64)))
    assert not tkops._tma_ready(fused[..., 4:260].unflatten(-1, (4, 64)))
    # a dimension of extent 1 has no stride to check
    one = torch.zeros(1, 7, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 7, 1, 64), (3, 64, 5, 1))
    assert tkops._tma_ready(one)


def test_rmsnorm_threads_switch_at_the_decode_and_prefill_rows():
    assert tlayout.rmsnorm_threads(4, 2048, 2) == 256      # block per row
    assert tlayout.rmsnorm_threads(4, 4096, 2) == 256
    assert tlayout.rmsnorm_threads(1872, 1024, 2) == 32    # warp per row
    assert tlayout.rmsnorm_threads(1872, 2048, 2) == 64
    assert tlayout.rmsnorm_threads(1872, 4096, 2) == 128
    assert tlayout.rmsnorm_threads(527, 4096, 2) == 256
    assert tlayout.rmsnorm_threads(528, 4096, 2) == 128


# ---------------------------------------------------------------------------
# policy, kernel wrappers, autograd, package boundary


def resolve_on_cpu(spec, op, **kw):
    return tpolicy.as_policy(spec).resolve(op=op, device=torch.device("cpu"),
                                           **kw)


def test_policy_labels_and_overrides():
    """On a CPU tensor ``auto`` without a shape is the static choice
    (``fused``), ``tile`` runs the plain version (``interpret``), and a
    per-op override beats the global label; ``tile_gpu`` raises off the
    card and a bad label or op raises ``ValueError``."""
    assert resolve_on_cpu(None, "ssd") == "fused"
    assert resolve_on_cpu("fused", "scan") == "fused"
    assert resolve_on_cpu("fused,ssd=tile", "ssd") == "interpret"
    assert resolve_on_cpu("fused,ssd=tile", "reduce") == "fused"
    assert resolve_on_cpu("reduce=baseline", "scan") == "fused"
    assert resolve_on_cpu("reduce=baseline", "reduce") == "baseline"
    with pytest.raises(RuntimeError, match="tile_gpu"):
        resolve_on_cpu("tile_gpu", "reduce")
    for bad in ("bogus", "reduce=nope", "bogus=fused"):
        with pytest.raises(ValueError):
            resolve_on_cpu(bad, "reduce")


def test_wrappers_run_the_plain_version_on_cpu_without_launching():
    tkops.reset_launches()
    plain = {name: k.plain for name, k in tkops.KERNELS.items()}
    x = torch.randn(6, 48)
    w = torch.rand(48) + 0.5
    torch.testing.assert_close(tkops.segmented_reduce(x),
                               plain["tcu_reduce"](x), rtol=0, atol=0)
    torch.testing.assert_close(tkops.segmented_scan(x),
                               plain["tcu_scan"](x), rtol=0, atol=0)
    torch.testing.assert_close(tkops.rmsnorm(x, w, eps=1e-5),
                               plain["rmsnorm"](x, w, eps=1e-5), rtol=0,
                               atol=0)
    _, tins = ssd_pair(1, 20, 2, 4, 1, 4, seed=3)
    for got, want in zip(tkops.ssd_scan(*tins, return_state=True),
                         plain["ssd_scan"](*tins, return_state=True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    la = -torch.rand(6, 48)
    torch.testing.assert_close(tkops.weighted_scan(x, la),
                               tref.weighted_scan_ref(x, la), rtol=0, atol=0)
    assert tkops.launch_counts() == {k: 0 for k in tkops.KERNELS}
    assert tbuild._lib is None          # nothing built or loaded on the CPU


def test_kernel_registry_names_sources_and_tpu_kernels():
    root = SRC.parent
    for k in tkops.KERNELS.values():
        assert (root / k.source).is_file(), k.source
        path, line = k.replaces.rsplit(":", 1)
        text = (root / path).read_text().splitlines()
        assert "pallas_call" in text[int(line) - 1], k.replaces


def test_gradients_go_through_the_plain_version():
    """The autograd wrappers' backward equals the oracle's gradient."""
    torch.manual_seed(0)
    x = torch.randn(3, 32, requires_grad=True)
    w = (torch.rand(32) + 0.5).requires_grad_()
    out = tkops.rmsnorm(x, w, eps=1e-5)
    gx, gw = torch.autograd.grad((out ** 2).sum(), (x, w))
    rx, rw = torch.autograd.grad(
        (tref.rmsnorm_ref(x, w, eps=1e-5) ** 2).sum(), (x, w))
    torch.testing.assert_close(gx, rx)
    torch.testing.assert_close(gw, rw)
    _, tins = ssd_pair(1, 20, 2, 4, 1, 4, seed=3)
    tins = [t.clone().requires_grad_() for t in tins]
    y, st = tkops.ssd_scan(*tins, return_state=True)
    g = torch.autograd.grad(y.sum() + st.sum(), tins)
    yr, sr = tref.ssd_scan_ref(*tins, return_state=True)
    gr = torch.autograd.grad(yr.sum() + sr.sum(), tins)
    for a, b in zip(g, gr):
        torch.testing.assert_close(a, b)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, torch\n"
        "import repro_torch.ops as ops\n"
        "import repro_torch.launch.serve, repro_torch.serving, "
        "repro_torch.models, repro_torch.configs.mamba2_1_3b\n"
        "import repro_torch.obs, repro_torch.obs.cli, "
        "repro_torch.obs.profiling\n"
        "import repro_torch.launch.train, repro_torch.training, "
        "repro_torch.optim.adafactor, repro_torch.data, "
        "repro_torch.checkpoint\n"
        "ops.reduce(torch.ones(2, 16), policy='tile')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
    obs_modules = {p.name for p in (SRC / "repro_torch" / "obs").glob("*.py")}
    assert {"metrics.py", "events.py", "runtime.py", "profiling.py",
            "cli.py"} <= obs_modules
    for path in (SRC / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for banned in ("import jax", "from jax", "import repro.",
                       "from repro.", "from repro import"):
            assert banned not in text, f"{path}: {banned}"

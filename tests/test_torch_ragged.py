"""Parity of the PyTorch port's ragged ops with the JAX package.

``repro_torch.core.ragged`` against ``repro.core.ragged``, and the port's
``dispatch.ragged_reduce``/``ragged_scan`` on ``tile``, ``fused`` and
``baseline`` against the reference's dispatch (``fused`` for the port's
matmul paths, ``baseline`` for its own), on the same numpy inputs made from
a seed: 1-D and batched ids, ids in any order for the reduce, ids out of
range, f32 and bf16, and ``guard_contiguous`` in its eager and its
capture (NaN) form. Tolerances: the matmul forms against the reference's
matmul forms 1e-6 (f32 on both sides, sums in another order); every path
against a numpy oracle at the tolerances of ``tests/test_dispatch.py``'s
ragged tests (f32: reduce rtol 1e-4 atol 1e-3, scan rtol 1e-3 atol 1e-2;
bf16: rtol 5e-2 atol 5e-1).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import dispatch as jdispatch
from repro.core import ragged as jragged
from repro_torch import obs
from repro_torch import ops as tops
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import ragged as tragged

PATHS = ("tile", "fused", "baseline")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ORACLE_TOL = {("reduce", "float32"): dict(rtol=1e-4, atol=1e-3),
              ("scan", "float32"): dict(rtol=1e-3, atol=1e-2),
              ("reduce", "bfloat16"): dict(rtol=5e-2, atol=5e-1),
              ("scan", "bfloat16"): dict(rtol=5e-2, atol=5e-1)}
MATCH = dict(rtol=1e-6, atol=1e-6)


def case(shape, s, seed, *, ids=None, sort=True):
    """Values rounded to bf16 once, so that both dtypes see the same
    numbers, and ids of shape ``ids`` (default ``shape``) in [0, s), sorted
    along the last axis unless not."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    seg = rng.integers(0, s, shape if ids is None else ids).astype(np.int32)
    if sort:
        seg = np.sort(seg, axis=-1)
    return x.astype(np.float32), seg


def both(x, dtype):
    """The same values in the port's and the reference's ``dtype``."""
    t, j = DTYPES[dtype]
    return torch.from_numpy(x).to(t), jnp.asarray(x).astype(j)


def oracle_reduce(x, seg, s):
    ids = np.broadcast_to(seg, x.shape)
    out = np.zeros(x.shape[:-1] + (s,), np.float64)
    for idx in np.ndindex(x.shape[:-1]):
        for i in range(s):
            out[idx + (i,)] = x[idx][ids[idx] == i].sum()
    return out


def oracle_scan(x, seg):
    ids = np.broadcast_to(seg, x.shape)
    out = np.empty(x.shape, np.float64)
    for idx in np.ndindex(x.shape[:-1]):
        for i in np.unique(ids[idx]):
            m = ids[idx] == i
            out[idx][m] = np.cumsum(x[idx][m])
    return out


def ref_path(path):
    return "baseline" if path == "baseline" else "fused"


# (x shape, n_segments, seed, ids shape): 1-D, batched ids, and one row of
# ids shared by every row of x
SHAPES = {"1d": ((300,), 7, 0, None), "batched": ((3, 64), 5, 1, None),
          "shared_ids": ((4, 96), 9, 2, (96,))}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_core_forms_match_jax(shape, dtype):
    """``tcu_ragged_segment_reduce`` (ids in any order) and
    ``tcu_ragged_segment_scan`` (sorted ids) against the reference's."""
    shp, s, seed, ids = SHAPES[shape]
    for sort in (True, False):
        x, seg = case(shp, s, seed, ids=ids, sort=sort)
        tx, jx = both(x, dtype)
        got = tragged.tcu_ragged_segment_reduce(tx, torch.from_numpy(seg), s)
        want = jragged.tcu_ragged_segment_reduce(jx, jnp.asarray(seg), s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATCH)
    x, seg = case(shp, s, seed, ids=ids)
    tx, jx = both(x, dtype)
    got = tragged.tcu_ragged_segment_scan(tx, torch.from_numpy(seg), s)
    want = jragged.tcu_ragged_segment_scan(jx, jnp.asarray(seg), s)
    assert got.dtype == torch.float32 and got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("path", PATHS)
def test_dispatch_ragged_reduce_matches_jax(path, shape, dtype):
    """Sorted and shuffled ids: the reference's dispatch on the same kind of
    path, and the numpy oracle."""
    shp, s, seed, ids = SHAPES[shape]
    for sort in (True, False):
        x, seg = case(shp, s, seed, ids=ids, sort=sort)
        tx, jx = both(x, dtype)
        got = tdispatch.ragged_reduce(tx, torch.from_numpy(seg), s,
                                      policy=path)
        want = jdispatch.ragged_reduce(jx, jnp.asarray(seg), s,
                                       path=ref_path(path))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATCH)
        np.testing.assert_allclose(got.numpy(), oracle_reduce(x, seg, s),
                                   **ORACLE_TOL["reduce", dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("path", PATHS)
def test_dispatch_ragged_scan_matches_jax(path, shape, dtype):
    shp, s, seed, ids = SHAPES[shape]
    x, seg = case(shp, s, seed, ids=ids)
    tx, jx = both(x, dtype)
    got = tdispatch.ragged_scan(tx, torch.from_numpy(seg), s, policy=path)
    want = jdispatch.ragged_scan(jx, jnp.asarray(seg), s,
                                 path=ref_path(path))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle_scan(x, seg),
                               **ORACLE_TOL["scan", dtype])


@pytest.mark.parametrize("path", PATHS)
def test_ids_out_of_range_match_jax(path):
    """Ids below 0 or at n_segments and beyond: the reduce drops them on
    every path; the scan's matmul form takes no preceding total for them,
    and its baseline gathers as ``take_along_axis`` does (a negative id
    counts from the end, one past the end reads NaN)."""
    rng = np.random.default_rng(4)
    s = 6
    x = rng.standard_normal((2, 40)).astype(np.float32)
    seg = rng.integers(-3, s + 3, (2, 40)).astype(np.int32)
    got = tdispatch.ragged_reduce(torch.from_numpy(x), torch.from_numpy(seg),
                                  s, policy=path)
    want = jdispatch.ragged_reduce(jnp.asarray(x), jnp.asarray(seg), s,
                                   path=ref_path(path))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATCH)
    np.testing.assert_allclose(got.numpy(), oracle_reduce(x, seg, s),
                               **ORACLE_TOL["reduce", "float32"])
    srt = np.sort(seg, axis=-1)
    got = tdispatch.ragged_scan(torch.from_numpy(x), torch.from_numpy(srt),
                                s, policy=path)
    want = np.asarray(jdispatch.ragged_scan(
        jnp.asarray(x), jnp.asarray(srt), s, path=ref_path(path)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want).any() == (path == "baseline")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("path", PATHS)
def test_guard_raises_eagerly_on_unsorted_ids(path):
    """``debug=True`` with ids that can be read: ValueError on every path,
    as the reference raises with concrete ids; sorted ids pass through
    unchanged."""
    x, seg = case((2, 50), 5, 3, sort=False)
    assert (np.diff(seg, axis=-1) < 0).any()
    with pytest.raises(ValueError, match="non-decreasing"):
        jdispatch.ragged_scan(jnp.asarray(x), jnp.asarray(seg), 5,
                              path=ref_path(path), debug=True)
    with pytest.raises(ValueError, match="non-decreasing"):
        tdispatch.ragged_scan(torch.from_numpy(x), torch.from_numpy(seg), 5,
                              policy=path, debug=True)
    srt = torch.from_numpy(np.sort(seg, axis=-1))
    torch.testing.assert_close(
        tdispatch.ragged_scan(torch.from_numpy(x), srt, 5, policy=path,
                              debug=True),
        tdispatch.ragged_scan(torch.from_numpy(x), srt, 5, policy=path),
        rtol=0, atol=0)


@pytest.mark.parametrize("sort", [True, False])
def test_guard_poisons_with_nan_under_capture(monkeypatch, sort):
    """While a CUDA graph is being captured the ids cannot be read: the
    output is poisoned with NaN where the ids are out of order, as the
    reference's traced branch under ``jit``, and never read on the host.
    The capture is stood in for by ``_capturing`` on the CPU; the card's
    capture runs in ``chip_smoke.py``."""
    x, seg = case((2, 50), 5, 3, sort=sort)
    want = np.asarray(jax.jit(
        lambda a, b: jragged.tcu_ragged_segment_scan(a, b, 5, debug=True))(
        jnp.asarray(x), jnp.asarray(seg)))
    monkeypatch.setattr(tragged, "_capturing", lambda ids: True)
    monkeypatch.setattr(torch.Tensor, "__bool__", _no_host_read)
    got = tragged.tcu_ragged_segment_scan(
        torch.from_numpy(x), torch.from_numpy(seg), 5, debug=True).numpy()
    assert np.isnan(got).all() == (not sort) == np.isnan(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def _no_host_read(self):
    raise AssertionError("a device value was read on the host")


def test_ops_facade_exports_the_ragged_ops():
    assert {"ragged_reduce", "ragged_scan"} <= set(tops.__all__)
    x, seg = case((100,), 4, 0)
    got = tops.ragged_reduce(torch.from_numpy(x), torch.from_numpy(seg), 4,
                             policy="ragged_reduce=baseline")
    np.testing.assert_allclose(got.numpy(), oracle_reduce(x, seg, 4),
                               **ORACLE_TOL["reduce", "float32"])
    with pytest.raises(RuntimeError, match="log-depth"):
        tops.ragged_scan(torch.from_numpy(x), torch.from_numpy(seg), 4,
                         policy="tile_logdepth")


@pytest.mark.parametrize("op", ["ragged_reduce", "ragged_scan"])
def test_ragged_resolutions_match_the_reference(op):
    """One dispatch-level resolution per call, with the reference's op, n,
    dtype and band."""
    x, seg = case((3, 40), 5, 0)
    with jobs.using_obs() as jsess:
        getattr(jdispatch, op)(jnp.asarray(x), jnp.asarray(seg), 5,
                               policy="fused")
    with obs.using_obs() as sess:
        getattr(tdispatch, op)(torch.from_numpy(x), torch.from_numpy(seg), 5,
                               policy="fused")
    keys = ("op", "n", "shard_n", "dtype", "band", "level", "chosen_path")
    want = [tuple(e[k] for k in keys)
            for e in jsess.events.events("resolution")]
    got = [tuple(e[k] for k in keys)
           for e in sess.events.events("resolution")]
    assert got == want == [(op, 40, 40, "f32", 5, "dispatch", "fused")]

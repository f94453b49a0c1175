"""The port's op analyser (``repro_torch.launch.op_analysis``) against the
JAX package's HLO analyser (``repro.launch.hlo_analysis``) on the CPU: a
matmul's FLOPs, a loop of layers, the collective conventions on a fake
world of 4, the dispatch ops charged once by formula whatever path runs
them, the memory tracker, and the roofline terms.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyse as janalyse
from repro.launch.hlo_analysis import roofline_terms as jroofline_terms
from repro_torch.core import costs, dispatch
from repro_torch.core.distributed import all_gather, all_reduce_sum, \
    reduce_scatter
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.op_analysis import OpAnalyser, analyse, \
    roofline_terms


def _hlo_flops(fn, *shapes) -> float:
    lowered = jax.jit(fn).lower(
        *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes))
    return janalyse(lowered.compile().as_text())["flops"]


def test_matmul_flops_equal_reference():
    m, k, n = 256, 512, 128
    got = analyse(lambda a, b: a @ b, torch.randn(m, k), torch.randn(k, n))
    assert got["flops"] == _hlo_flops(lambda a, b: a @ b, (m, k), (k, n))
    assert got["flops"] == 2 * m * k * n


def test_loop_of_layers_counts_every_layer():
    """An eager loop of L layers counts L times one layer; the reference's
    scan counts its trip count (its HLO adds the loop counter's adds)."""
    t, d = 8, 64

    def layers(w, x, n):
        for i in range(n):
            x = torch.tanh(x @ w[i])
        return x

    w, x = torch.randn(t, d, d), torch.randn(4, d)
    one = analyse(layers, w, x, 1)["flops"]
    got = analyse(layers, w, x, t)
    assert got["flops"] == t * one == t * (2 * 4 * d * d + 4 * d)
    assert got["unknown_trip_whiles"] == 0

    def jlayers(w, x):
        def body(h, wl):
            return jnp.tanh(h @ wl), None
        return jax.lax.scan(body, x, w)[0]

    want = _hlo_flops(jlayers, (t, d, d), (4, d))
    assert want - t * 4 <= got["flops"] <= want


def test_elementwise_reduction_and_cast_rules():
    """1 an output element for a pointwise op and a cast, |in| for a
    reduction or a scan, nothing and no bytes for a view."""
    x = torch.randn(32, 64)
    assert analyse(lambda x: x * 2.0, x)["flops"] == x.numel()
    assert analyse(lambda x: x.sum(-1), x)["flops"] == x.numel()
    assert analyse(lambda x: torch.cumsum(x, -1), x)["flops"] == x.numel()
    assert analyse(lambda x: x.to(torch.bfloat16), x)["flops"] == x.numel()
    view = analyse(lambda x: x.view(64, 32).t(), x)
    assert view["flops"] == 0 and view["memory_bytes"] == 0
    add = analyse(lambda x: x + x, x)
    assert add["memory_bytes"] == 3 * x.numel() * 4


def test_memory_tracker():
    """Arguments, outputs, and a temporary freed before the peak's end."""
    a, b = torch.randn(256, 512), torch.randn(512, 128)

    def f(a, b):
        t = a * 2.0                  # 512 KiB, freed after the matmul
        return t @ b

    got = analyse(f, a, b)["memory"]
    assert got["argument_bytes"] == (256 * 512 + 512 * 128) * 4
    assert got["output_bytes"] == 256 * 128 * 4
    assert got["temp_bytes"] == 256 * 512 * 4
    assert got["peak_bytes"] == sum(got[k] for k in (
        "argument_bytes", "output_bytes", "temp_bytes"))


def test_collective_conventions_on_a_fake_world():
    """The reference's conventions: all-gather the per-rank result,
    reduce-scatter the operand, all-reduce twice its size."""
    with tmesh.fake_world(4):
        x = torch.randn(8, 16)

        def step(x):
            g = all_gather(x)                # (4, 8, 16)
            s = all_reduce_sum(x)
            r = reduce_scatter(g.reshape(32, 16), 0)
            return g, s, r

        got = analyse(step, x)
    assert not torch.distributed.is_initialized()
    nb = x.numel() * 4
    assert got["collective_bytes"] == {"all-gather": 4 * nb,
                                       "all-reduce": 2 * nb,
                                       "reduce-scatter": 4 * nb}
    assert got["n_collectives"] == 3
    assert got["collective_total"] == 10 * nb


def _op_inputs(op: str, device: str):
    g = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g).to(device)

    if op in ("reduce", "scan"):
        return (rn(4, 256),), {}
    if op == "weighted_scan":
        return (rn(4, 256), -torch.rand(4, 256, generator=g).to(device)), {}
    if op in ("ragged_reduce", "ragged_scan"):
        ids = torch.arange(256).div(32, rounding_mode="floor").to(device)
        return (rn(4, 256), ids, 8), {}
    if op == "rmsnorm":
        return (rn(8, 64), rn(64)), {}
    if op == "attention":
        return (rn(2, 64, 4, 16), rn(2, 64, 2, 16), rn(2, 64, 2, 16)), \
            {"causal": True}
    b, c = rn(2, 128, 1, 16), rn(2, 128, 1, 16)
    return (rn(2, 128, 4, 16), torch.nn.functional.softplus(
        rn(2, 128, 4)), -torch.rand(4, generator=g).to(device), b, c), {}


OPS = ("reduce", "scan", "weighted_scan", "ragged_reduce", "ragged_scan",
       "rmsnorm", "attention", "ssd")
PATHS = ("baseline", "interpret", "fused")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("grad", [False, True])
def test_dispatch_op_charged_once_by_formula(op, grad):
    """The same count under ``baseline``, the kernels' plain versions
    (``interpret``, what ``tile`` runs on the CPU), ``fused``, and on
    ``meta``: the op's formula, its inputs' and outputs' bytes, and with a
    gradient twice the FLOPs for its backward."""
    fn = getattr(dispatch, op)
    # RMSNorm resolves at the kernel level only, where ``fused`` is its
    # plain version; the SSD's oracle loops over its steps, too long on meta
    paths = PATHS[1:] if op == "rmsnorm" else PATHS
    meta = "baseline" if op not in ("rmsnorm", "ssd") else "fused"
    counts = []
    for device, path in [("cpu", p) for p in paths] + [("meta", meta)]:
        if grad and device == "meta":
            continue
        args, kw = _op_inputs(op, device)
        if grad:
            args = tuple(a.requires_grad_() if isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for a in args)

        def run(*args):
            out = fn(*args, path=path, **kw)
            if not grad:
                return out
            out = out[0] if isinstance(out, tuple) else out
            return torch.autograd.grad(out.float().sum(), args[0])[0]

        got = analyse(run, *args)
        rec = got["dispatch_ops"]
        counts.append((got["flops"], got["memory_bytes"],
                       {k: (v["calls"], v["flops"], v["bytes"])
                        for k, v in rec.items()}))
        flops = costs.op_flops(op, args, kw)
        assert rec[op]["flops"] == flops and rec[op]["calls"] == 1
        if grad:
            assert rec[f"{op}.backward"]["flops"] == 2 * flops
    assert all(c == counts[0] for c in counts), counts
    assert costs.ACTIVE is None


def test_inactive_hook_and_nesting():
    """With no analyser the dispatch ops run as before; analysers do not
    nest."""
    x = torch.randn(4, 64)
    assert costs.ACTIVE is None
    torch.testing.assert_close(dispatch.reduce(x, path="baseline"),
                               x.sum(-1))
    with OpAnalyser():
        with pytest.raises(RuntimeError, match="already active"):
            OpAnalyser().__enter__()
    assert costs.ACTIVE is None


@pytest.mark.parametrize("lq,lk,causal,window", [
    (512, 512, True, None), (468, 512, True, None), (100, 1000, True, None),
    (512, 512, False, None), (4096, 4096, True, 1024), (6144, 6144, True,
                                                        4096)])
def test_attention_pairs_closed_form(lq, lk, causal, window):
    """The numpy form equals the row-by-row count it replaced."""
    total = 0
    for i in range(lq):
        qpos = i + lk - lq
        hi = min(lk, qpos + 1) if causal else lk
        lo = max(0, qpos - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    assert costs.attention_pairs(lq, lk, causal, window) == total


@pytest.mark.parametrize("nums", [
    dict(flops=197e12, memory_bytes=819e9 * 2, collective_total=50e9 * 0.5),
    dict(flops=1e15, memory_bytes=3e12, collective_total=1e9),
    dict(flops=1e9, memory_bytes=1e6, collective_total=5e12)])
def test_roofline_terms_equal_reference(nums):
    kw = dict(peak_flops=tmesh.PEAK_FLOPS_BF16, hbm_bw=tmesh.HBM_BW)
    want = jroofline_terms(nums, ici_bw=tmesh.LINK_BW, **kw)
    got = roofline_terms(nums, link_bw=tmesh.LINK_BW, **kw)
    assert got == want


def test_bound_matches_the_kernel_table_formula():
    """``roofline.bound``, the kernel table's: bytes over HBM or ops over
    the dtype's peak, whichever is longer (ms)."""
    from repro_torch.launch.roofline import bound

    assert bound(3.35e9, 1.0, torch.bfloat16) == (1.0, "bytes")
    ms, by = bound(1.0, 989e9, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(1.0)
    assert bound(1.0, 67e9, torch.float32)[0] == pytest.approx(1.0)
    assert np.isclose(costs.ssd_flops(4, 512, 64, 64, 128),
                      4 * 64 * 8 * 2 * (2080 * 128 + 2080 * 64
                                        + 2 * 64 * 128 * 64))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_train_step_counts_alike_on_every_path(arch):
    """A SMOKE train step with every layer checkpointed (remat ``none``,
    the FULL configs' policy): the same FLOPs and bytes under ``baseline``
    and ``interpret`` (the kernels' wrappers on their plain versions, what
    the card's kernel path runs but the kernel), and the step still runs
    (the recompute saves what the forward saved). The recompute charges
    each layer's dispatch ops again."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.common import smoke_batch
    from repro_torch.core.policy import using_policy
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.training import init_train_state, make_train_step

    cfg = dataclasses.replace(configs.get(arch).SMOKE, remat_policy="none")
    bundle = build(cfg)
    state = init_train_state(torch.Generator().manual_seed(0), bundle,
                             OptConfig())
    step = make_train_step(bundle, OptConfig())
    batch = {k: v[:, :32] for k, v in smoke_batch(cfg).items()}
    got = []
    for path in ("baseline", "interpret"):
        with using_policy(path):
            got.append(analyse(step, state, batch))
    assert (got[0]["flops"], got[0]["memory_bytes"]) == \
        (got[1]["flops"], got[1]["memory_bytes"])
    assert got[0]["dispatch_ops"] == got[1]["dispatch_ops"]
    ops = got[0]["dispatch_ops"]
    # two norms a layer (llama's two; mamba's outer and gated inner)
    assert ops["rmsnorm"]["calls"] == ops["rmsnorm.backward"]["calls"] + \
        2 * cfg.n_layers


def test_recompute_started_inside_a_dispatch_op_counts():
    """A checkpointed region that ends in a dispatch op: its recompute
    starts inside that op's backward node, and the region's aten ops count
    again (the matmul and tanh once more), alike on the plain version
    (``fused``) and the wrapper's (``interpret``). The checkpoint stops
    the recompute at the last tensor it needs, inside the dispatch op,
    which is then not charged again on either."""
    from torch.utils.checkpoint import checkpoint

    w, g = torch.randn(64, 64), torch.randn(64)
    got = {}
    for path in ("fused", "interpret"):
        def region(x):
            return dispatch.rmsnorm(torch.tanh(x @ w), g, path=path)

        def train(x, remat):
            y = checkpoint(region, x, use_reentrant=False) if remat \
                else region(x)
            return torch.autograd.grad(y.sum(), x)[0]

        x = torch.randn(16, 64, requires_grad=True)
        plain, remat = analyse(train, x, False), analyse(train, x, True)
        for op in ("aten::mm", "aten::tanh"):
            assert remat["aten_ops"][op]["calls"] == \
                plain["aten_ops"][op]["calls"] + 1, (path, op)
        got[path] = (remat["flops"], remat["memory_bytes"])
    assert got["fused"] == got["interpret"]

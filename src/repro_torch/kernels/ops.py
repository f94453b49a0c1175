"""Wrappers of the Hopper kernels in ``csrc/``: glue, launch counts, autograd.

Each wrapper takes the model layout, does the glue (flatten leading dims,
make the last dim contiguous, allocate the outputs) and launches its kernel
on the current stream. It runs the kernel's plain version, the oracle in
``kernels/ref.py`` listed in :data:`KERNELS`, only because the tensor it was
given lies on the CPU. For a CUDA tensor it launches the kernel or raises:
there is no fallback.

Every wrapper is a ``torch.autograd.Function`` whose backward goes through
the plain version (the counterpart of ``_diff_via_ref`` in
``repro.kernels.ops``): each kernel agrees with its oracle to tolerance, so
the oracle's gradient is the kernel's.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch

from repro_torch import device as devmod
from repro_torch.kernels import build, layout, ref
from repro_torch.kernels.layout import MMA_TILE, WARP
from repro_torch.kernels.matmul_scan import tree_scan, tree_weighted


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, its plain
    version, and how many times its wrapper has launched it."""

    name: str
    source: str          # path in the repository
    replaces: str        # file:line of the TPU kernel's pallas_call
    plain: Callable
    launches: int = 0


KERNELS = {
    "tcu_reduce": Kernel(
        "tcu_reduce", "src/repro_torch/csrc/tcu_reduce.cu",
        "src/repro/kernels/tcu_reduce.py:80", ref.segmented_reduce_ref),
    "tcu_scan": Kernel(
        "tcu_scan", "src/repro_torch/csrc/tcu_scan.cu",
        "src/repro/kernels/tcu_scan.py:82", ref.segmented_scan_ref),
    "ssd_scan": Kernel(
        "ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:116", ref.ssd_scan_ref),
    # the reference runs its weighted scan on the SSD kernel at N = P = 1
    "weighted_scan": Kernel(
        "weighted_scan", "src/repro_torch/csrc/weighted_scan.cu",
        "src/repro/kernels/ssd_scan.py:116", ref.weighted_scan_ref),
    "rmsnorm": Kernel(
        "rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/fused_rmsnorm.py:56", ref.rmsnorm_ref),
    "flash_attention": Kernel(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:124", ref.flash_attention_ref),
    "matmul_local_scan": Kernel(
        "matmul_local_scan", "src/repro_torch/csrc/matmul_scan.cu",
        "src/repro/kernels/matmul_scan.py:211", ref.local_scan_ref),
    "matmul_local_weighted": Kernel(
        "matmul_local_weighted", "src/repro_torch/csrc/matmul_scan.cu",
        "src/repro/kernels/matmul_scan.py:255", ref.local_weighted_ref),
    "matmul_local_ssd": Kernel(
        "matmul_local_ssd", "src/repro_torch/csrc/matmul_scan.cu",
        "src/repro/kernels/matmul_scan.py:325", ref.local_ssd_ref),
}


# launches of each instance of the SSD chunk body, by (kernel, instance):
# "mma" (f16/bf16 on the tensor cores) or "fma" (f32 FMA loops); see
# _ssd_instance
INSTANCES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
    INSTANCES.clear()


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` to the kernels' launch counts. A captured CUDA graph
    replays its kernels without running their wrappers: its owner takes
    back what the wrappers counted while the graph was captured (nothing
    ran then) and adds it again at every replay."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def instance_counts() -> dict[tuple[str, str], int]:
    return dict(INSTANCES)


def _dtype_code(t: torch.Tensor, name: str) -> int:
    code = build.DTYPE_CODE.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: the kernel takes float32, float16 or "
                        f"bfloat16, got {t.dtype}")
    return code


def _library(t: torch.Tensor):
    """The kernels' library, after checking that ``t`` is on a Hopper card."""
    devmod.require_hopper(t.device)
    return build.load()


# ---------------------------------------------------------------------------
# backward through the plain version


class _ViaPlain(torch.autograd.Function):
    """Forward: the kernel (or its plain version on the CPU). Backward: the
    gradient of the plain version at the saved inputs."""

    @staticmethod
    def forward(ctx, fwd, plain, kwargs, *tensors):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*tensors)
        return fwd(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(t.is_floating_point())
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain(*inputs, **ctx.kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None, None,
                *[next(got) if t.requires_grad else None for t in inputs])


def _via_plain(fwd, plain, *tensors, **kwargs):
    return _ViaPlain.apply(fwd, plain, kwargs, *tensors)


# ---------------------------------------------------------------------------
# segmented reduce / scan (tcu_reduce.cu, tcu_scan.cu)


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _reduce_scan_launch(lib, code: int, x: torch.Tensor, out: torch.Tensor,
                        name: str, *, scan: bool) -> None:
    """Launch tcu_reduce.cu or tcu_scan.cu on ``x (rows, n)`` contiguous with
    the plan of ``layout.reduce_scan_plan`` and its workspace."""
    rows, n = x.shape
    plan = layout.reduce_scan_plan(rows, n, x.element_size(),
                                   devmod.sm_count(x.device), scan=scan)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
          if plan.workspace else None)
    fn = lib.tcu_scan_launch if scan else lib.tcu_reduce_launch
    build.check(fn(x.data_ptr(), out.data_ptr(),
                   None if ws is None else ws.data_ptr(), rows, n,
                   plan.pieces, plan.length, plan.blocks,
                   plan.combine_threads, code, build.stream_ptr(x)), name)
    KERNELS[name].launches += 1


def _reduce_fwd(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return ref.segmented_reduce_ref(x)
    lead = x.shape[:-1]
    code = _dtype_code(x, "tcu_reduce")
    lib = _library(x)
    if x.numel() == 0:
        return torch.zeros(lead, dtype=torch.float32, device=x.device)
    flat = _rows_view(x)
    out = torch.empty(flat.shape[0], dtype=torch.float32, device=x.device)
    _reduce_scan_launch(lib, code, flat, out, "tcu_reduce", scan=False)
    return out.reshape(lead)


def segmented_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of ``x (..., n)`` -> f32 ``(...,)``."""
    return _via_plain(_reduce_fwd, ref.segmented_reduce_ref, x)


def _scan_fwd(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return ref.segmented_scan_ref(x)
    code = _dtype_code(x, "tcu_scan")
    lib = _library(x)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    _reduce_scan_launch(lib, code, _rows_view(x), out, "tcu_scan", scan=True)
    return out


def segmented_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis -> f32, same shape."""
    return _via_plain(_scan_fwd, ref.segmented_scan_ref, x)


# ---------------------------------------------------------------------------
# SSD chunk scan (ssd_scan.cu)


def _strides(t: torch.Tensor, dims: int) -> list[int]:
    return list(t.stride()[:dims])


def _ssd_instance(lib, name: str, code: int, q: int, hdim: int, nstate: int,
                  x, b, c):
    """Which instance of the SSD chunk body ``name`` launches, chosen by dtype
    and shape before the launch, as ``ssd_uses_mma`` in ``csrc/`` decides:
    f16/bf16 with ``q <= 64``, ``P <= 64``, ``N <= 128`` and P, N multiples
    of 8 run on the tensor cores ("mma"); f32, mixed dtypes (upcast by the
    caller) and every other shape run the FMA loops ("fma"). The "mma"
    instance reads x, b, c in 16-byte copies, so views whose rows are not
    16-byte aligned are copied first. Returns ``(instance, x, b, c)``."""
    if lib.ssd_uses_mma(code, q, hdim, nstate):
        x, b, c = (t if _tma_ready(t) else t.clone(
            memory_format=torch.contiguous_format) for t in (x, b, c))
        return "mma", x, b, c
    smem = getattr(lib, f"{name}_smem_bytes")(q, hdim, nstate)
    if smem > layout.MAX_SMEM:
        raise ValueError(f"{name}: chunk {q} with P={hdim}, N={nstate} "
                         f"needs {smem} bytes of shared memory, more than "
                         f"the {layout.MAX_SMEM} a block may use")
    return "fma", x, b, c


def _launch_ssd(x, dt, lam, b, c, *, q: int, x_strides, dt_strides,
                lam_strides, b_strides, c_strides, dims):
    """Launch ssd_scan.cu; x, b, c share a dtype. Returns (y, state)."""
    bsz, seqlen, nheads, ngroups, hdim, nstate = dims
    code = _dtype_code(x, "ssd_scan")
    lib = _library(x)
    inst, x, b, c = _ssd_instance(lib, "ssd_scan", code, q, hdim, nstate, x,
                                  b, c)
    if inst == "mma":
        x_strides, b_strides, c_strides = (_strides(t, 3) for t in (x, b, c))
    y = torch.empty((bsz, seqlen, nheads, hdim), dtype=x.dtype,
                    device=x.device)
    state = torch.empty((bsz, nheads, hdim, nstate), dtype=torch.float32,
                        device=x.device)
    build.check(lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), lam.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), state.data_ptr(), code,
        bsz, seqlen, nheads, ngroups, hdim, nstate, q,
        *x_strides, *dt_strides, *lam_strides, *b_strides, *c_strides,
        build.stream_ptr(x)), "ssd_scan")
    KERNELS["ssd_scan"].launches += 1
    INSTANCES["ssd_scan", inst] += 1
    return y, state


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _ssd_fwd(x, dt, a, b, c, *, return_state: bool = True):
    if not x.is_cuda:
        return ref.ssd_scan_ref(x, dt, a, b, c, return_state=True)
    bsz, seqlen, nheads, hdim = x.shape
    ngroups, nstate = b.shape[2], b.shape[3]
    if nheads % ngroups:
        raise ValueError(f"ssd_scan: H={nheads} is not a multiple of "
                         f"G={ngroups}")
    y_dtype = x.dtype               # y comes back in the caller's x dtype
    if not (x.dtype == b.dtype == c.dtype):
        x, b, c = x.float(), b.float(), c.float()
    x, b, c = (_last_contiguous(t) for t in (x, b, c))
    dt = dt.float()
    lam = dt * a.float()                                  # (B, L, H) f32
    q = layout.fit_block(seqlen, layout.HOPPER["ssd"]["q"], MMA_TILE)
    y, state = _launch_ssd(
        x, dt, lam, b, c, q=q, x_strides=_strides(x, 3),
        dt_strides=_strides(dt, 3), lam_strides=_strides(lam, 3),
        b_strides=_strides(b, 3), c_strides=_strides(c, 3),
        dims=(bsz, seqlen, nheads, ngroups, hdim, nstate))
    return y.to(y_dtype), state


def ssd_scan(x, dt, a, b, c, *, return_state: bool = False):
    """Mamba-2 SSD scan: ``x (B, L, H, P)``, ``dt (B, L, H)``, ``a (H,)``,
    ``b``/``c`` ``(B, L, G, N)`` -> ``y (B, L, H, P)`` in x's dtype; with
    ``return_state=True`` also the final state ``(B, H, P, N)`` f32."""
    y, state = _via_plain(_ssd_fwd, ref.ssd_scan_ref, x, dt, a, b, c,
                          return_state=True)
    return (y, state) if return_state else y


# ---------------------------------------------------------------------------
# the weighted scan (weighted_scan.cu)


def _weighted_fwd(x: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return ref.weighted_scan_ref(x, log_a)
    if x.shape != log_a.shape:
        raise ValueError(f"weighted_scan: x {tuple(x.shape)} and log_a "
                         f"{tuple(log_a.shape)} differ")
    lib = _library(x)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    # x is read in its own dtype (another float type goes to f32), log_a in
    # x's dtype or f32
    if x.dtype not in build.DTYPE_CODE:
        x = x.float()
    if log_a.dtype not in (x.dtype, torch.float32):
        log_a = log_a.float()
    xr, la = _rows_view(x), _rows_view(log_a)
    rows, n = xr.shape
    plan = layout.weighted_scan_plan(rows, n, devmod.sm_count(x.device))
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
          if plan.workspace else None)
    build.check(lib.weighted_scan_launch(
        xr.data_ptr(), la.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), rows, n, plan.pieces,
        plan.length, plan.blocks, plan.combine_threads,
        build.DTYPE_CODE[x.dtype], build.DTYPE_CODE[la.dtype],
        build.stream_ptr(x)), "weighted_scan")
    KERNELS["weighted_scan"].launches += 1
    return out


def weighted_scan(x: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    """Decayed scan ``y_i = exp(log_a_i) * y_{i-1} + x_i`` -> f32."""
    return _via_plain(_weighted_fwd, ref.weighted_scan_ref, x, log_a)


# ---------------------------------------------------------------------------
# RMSNorm (rmsnorm.cu)


def _rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    if not x.is_cuda:
        return ref.rmsnorm_ref(x, w, eps=eps)
    code = _dtype_code(x, "rmsnorm")
    lib = _library(x)
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: weight shape {tuple(w.shape)} != ({d},)")
    if x.numel() == 0:
        return torch.empty_like(x)
    if w.dtype != x.dtype:
        w = w.float()
    w = w.contiguous()
    flat = _rows_view(x)
    out = torch.empty_like(flat)
    tpr = layout.rmsnorm_threads(flat.shape[0], d, x.element_size())
    build.check(lib.rmsnorm_launch(
        flat.data_ptr(), w.data_ptr(), out.data_ptr(), flat.shape[0], d,
        code, int(w.dtype != x.dtype), eps, tpr, build.stream_ptr(x)),
        "rmsnorm")
    KERNELS["rmsnorm"].launches += 1
    return out.reshape(x.shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, in x's dtype (differentiable)."""
    return _via_plain(_rmsnorm_fwd, ref.rmsnorm_ref, x, w, eps=eps)


# ---------------------------------------------------------------------------
# flash attention (flash_attention.cu)


def attention_plain(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """The kernel's plain version in the model layout: the oracle on the
    ``(B, H, S, D)`` views of ``q (B, Sq, Hq, D)`` and ``k``/``v``
    ``(B, Sk, Hkv, D)``."""
    def t(a):
        return a.transpose(1, 2)

    return t(ref.flash_attention_ref(t(q), t(k), t(v), causal=causal,
                                     window=window, scale=scale))


def _tma_ready(t: torch.Tensor) -> bool:
    """A TMA tensor map, and the 16-byte cp.async row copies of the
    tensor-core SSD kernels, need a 16-byte aligned base and strides that
    are multiples of 16 bytes (a dimension of extent 1 has no stride to
    check)."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s * es % 16 == 0 for n, s in zip(t.shape[:-1], t.stride()[:-1])
        if n > 1)


def _attention_fwd(q, k, v, *, causal: bool = True,
                   window: int | None = None, scale: float | None = None):
    if not q.is_cuda:
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    bsz, lq, hq, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != bsz or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match as (B, Sq, Hq, D), (B, Sk, Hkv, D)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k, v dtypes differ: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if dh % MMA_TILE or dh > 128:
        raise ValueError(f"flash_attention: head dim {dh} must be a "
                         f"multiple of {MMA_TILE} and at most 128")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    code = _dtype_code(q, "flash_attention")
    lib = _library(q)
    out = torch.empty((bsz, lq, hq, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if lk == 0:                     # nothing to attend: the l > 0 guard
        return out.zero_()
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    if q.element_size() == 2:       # the f16/bf16 kernel reads through TMA
        q, k, v = (t if _tma_ready(t) else t.clone(
            memory_format=torch.contiguous_format) for t in (q, k, v))
    sc = scale if scale is not None else 1.0 / (dh ** 0.5)
    build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
        bsz, lq, lk, hq, hkv, dh, int(causal), window or 0, sc,
        *_strides(q, 3), *_strides(k, 3), *_strides(v, 3),
        build.stream_ptr(q)), "flash_attention")
    KERNELS["flash_attention"].launches += 1
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Attention in the model layout: ``q (B, Sq, Hq, D)``, ``k``/``v``
    ``(B, Sk, Hkv, D)`` -> ``(B, Sq, Hq, D)`` in q's dtype. GQA by head
    index, ends aligned by ``Sk - Sq``; ``scale`` defaults to ``D**-0.5``.
    Any lengths; on a CUDA tensor it raises on a head dim that is not a
    multiple of 16 or above 128 (differentiable)."""
    return _via_plain(_attention_fwd, attention_plain, q, k, v,
                      causal=causal, window=window, scale=scale)


# ---------------------------------------------------------------------------
# the log-depth MatMulScan family (matmul_scan.cu + the tree of
# kernels/matmul_scan.py): carry-free local passes on a fully parallel
# grid, then O(log_radix nblocks) batched matmuls over the block totals.
# On a CPU tensor the local pass is its plain version and the tree the same.

def matmul_local_scan(x: torch.Tensor, block_n: int) -> torch.Tensor:
    """Per-block inclusive scan of ``x (rows, n)`` -> f32, each ``block_n``
    block of a row restarted from zero (matmul_scan.cu's local_scan)."""
    if not x.is_cuda:
        return ref.local_scan_ref(x, block_n)
    code = _dtype_code(x, "matmul_local_scan")
    lib = _library(x)
    rows, n = x.shape
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    x = x.contiguous()
    build.check(lib.matmul_local_scan_launch(
        x.data_ptr(), out.data_ptr(), rows, n, block_n, code,
        build.stream_ptr(x)), "matmul_local_scan")
    KERNELS["matmul_local_scan"].launches += 1
    return out


def _scan_logdepth_fwd(x: torch.Tensor) -> torch.Tensor:
    geo = layout.HOPPER["scan_logdepth"]
    lead, n = x.shape[:-1], x.shape[-1]
    # whole 32-column steps of the streaming loop (f16/bf16; f32: two)
    bn = layout.fit_block(n, geo["block_n"], 2 * MMA_TILE)
    local = matmul_local_scan(x.reshape(-1, n), bn)
    nb = -(-n // bn)
    if nb > 1:
        # only the totals of blocks 0 .. nb-2 carry into a later block, so
        # nothing past n is read: block j >= 1 adds the scan of totals
        # 0 .. j-1
        full = (nb - 1) * bn
        carry = tree_scan(local[:, bn - 1:full:bn], radix=geo["radix"],
                          fan_in=geo["fan_in"])           # (rows, nb - 1)
        local[:, bn:full].unflatten(1, (nb - 2, bn)).add_(
            carry[:, :-1, None])
        local[:, full:].add_(carry[:, -1:])
    return local.reshape(*lead, n)


def segmented_scan_logdepth(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis -> f32, by local block scans
    and a log-depth tree over the block totals (differentiable)."""
    return _via_plain(_scan_logdepth_fwd, ref.segmented_scan_ref, x)


def matmul_local_weighted(x: torch.Tensor, log_a: torch.Tensor,
                          q: int) -> torch.Tensor:
    """Per-block weighted scan of ``x, log_a (rows, n)`` -> f32,
    ``h_t = exp(log_a_t) h_{t-1} + x_t`` restarted at every ``q`` block
    (matmul_scan.cu's local_weighted)."""
    if not x.is_cuda:
        return ref.local_weighted_ref(x, log_a, q)
    if x.shape != log_a.shape:
        raise ValueError(f"matmul_local_weighted: x {tuple(x.shape)} and "
                         f"log_a {tuple(log_a.shape)} differ")
    lib = _library(x)
    rows, n = x.shape
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    xf, la = x.float().contiguous(), log_a.float().contiguous()
    build.check(lib.matmul_local_weighted_launch(
        xf.data_ptr(), la.data_ptr(), out.data_ptr(), rows, n, q,
        build.stream_ptr(x)), "matmul_local_weighted")
    KERNELS["matmul_local_weighted"].launches += 1
    return out


def _weighted_logdepth_fwd(x: torch.Tensor,
                           log_a: torch.Tensor) -> torch.Tensor:
    geo = layout.HOPPER["weighted_scan_logdepth"]
    lead, n = x.shape[:-1], x.shape[-1]
    la = log_a.reshape(-1, n).float()
    q = layout.fit_block(n, geo["q"], WARP)
    local = matmul_local_weighted(x.reshape(-1, n), la, q)
    nb = -(-n // q)
    if nb > 1:
        full = (nb - 1) * q
        lg = ref.pad_blocks(la, q)                        # (rows, nb, q)
        # boundary states H_j = exp(sum lambda_j) H_{j-1} + h_j[last] of
        # blocks 0 .. nb-2; block j >= 1 adds exp(Lambda_j) H_{j-1}
        carry = tree_weighted(lg[:, :-1].sum(-1),
                              local[:, q - 1:full:q, None],
                              radix=geo["radix"], fan_in=geo["fan_in"])
        decay = torch.exp(torch.cumsum(lg[:, 1:], -1))   # (rows, nb-1, q)
        local[:, q:].add_((decay * carry).flatten(1)[:, :n - q])
    return local.reshape(*lead, n)


def weighted_scan_logdepth(x: torch.Tensor,
                           log_a: torch.Tensor) -> torch.Tensor:
    """Decayed scan ``y_i = exp(log_a_i) y_{i-1} + x_i`` -> f32, by local
    block passes and a log-depth weighted tree (differentiable)."""
    return _via_plain(_weighted_logdepth_fwd, ref.weighted_scan_ref, x,
                      log_a)


def matmul_local_ssd(x, dt, a, b, c, q: int):
    """The SSD of every chunk of ``q`` steps on its own (matmul_scan.cu's
    local_ssd): ``x (B, L, H, P)``, ``dt (B, L, H)``, ``a (H,)``,
    ``b``/``c`` ``(B, L, G, N)`` -> ``y_local (B, L, H, P)`` f32 and the
    chunk states ``S (B, H, ceil(L / q), N, P)`` f32."""
    if not x.is_cuda:
        return ref.local_ssd_ref(x, dt, a, b, c, q)
    bsz, seqlen, nheads, hdim = x.shape
    ngroups, nstate = b.shape[2], b.shape[3]
    if nheads % ngroups:
        raise ValueError(f"matmul_local_ssd: H={nheads} is not a multiple "
                         f"of G={ngroups}")
    if not (x.dtype == b.dtype == c.dtype):
        x, b, c = x.float(), b.float(), c.float()
    code = _dtype_code(x, "matmul_local_ssd")
    lib = _library(x)
    x, b, c = (_last_contiguous(t) for t in (x, b, c))
    inst, x, b, c = _ssd_instance(lib, "matmul_local_ssd", code, q, hdim,
                                  nstate, x, b, c)
    nchunks = -(-seqlen // q)
    y = torch.empty((bsz, seqlen, nheads, hdim), dtype=torch.float32,
                    device=x.device)
    s = torch.empty((bsz, nheads, nchunks, nstate, hdim),
                    dtype=torch.float32, device=x.device)
    dt = dt.float()
    lam = dt * a.float()                                  # (B, L, H) f32
    build.check(lib.matmul_local_ssd_launch(
        x.data_ptr(), dt.data_ptr(), lam.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), s.data_ptr(), code,
        bsz, seqlen, nheads, ngroups, hdim, nstate, q,
        *_strides(x, 3), *_strides(dt, 3), *_strides(lam, 3),
        *_strides(b, 3), *_strides(c, 3), build.stream_ptr(x)),
        "matmul_local_ssd")
    KERNELS["matmul_local_ssd"].launches += 1
    INSTANCES["matmul_local_ssd", inst] += 1
    return y, s


def _ssd_logdepth_fwd(x, dt, a, b, c, *, return_state: bool = True):
    geo = layout.HOPPER["ssd_logdepth"]
    bsz, seqlen, nheads, hdim = x.shape
    ngroups, nstate = b.shape[2], b.shape[3]
    q = layout.fit_block(seqlen, geo["q"], MMA_TILE)
    y, s = matmul_local_ssd(x, dt, a, b, c, q)
    lam = (dt.float() * a.float()).transpose(1, 2)        # (B, H, L)
    lg = ref.pad_blocks(lam, q)                           # (B, H, nc, q)
    # chunk states H_j = exp(sum lambda_j) H_{j-1} + S_j, the weighted tree
    # over the flat (N * P) features; a padded tail step is the identity
    h_inc = tree_weighted(lg.sum(-1), s.flatten(-2), radix=geo["radix"],
                          fan_in=geo["fan_in"])           # (B, H, nc, N*P)
    if s.shape[2] > 1:
        # chunk j >= 1 adds exp(Lambda_t) C_t H_{j-1}, C read per group:
        # (B, nc-1, q, G, N) x (B, G, R, nc-1, N, P) -> (B, nc-1, q, G, R, P)
        h_prev = h_inc[:, :, :-1].unflatten(-1, (nstate, hdim))
        inter = torch.einsum(
            "bjqgn,bgrjnp->bjqgrp", ref.pad_chunks(c.float(), q)[:, 1:],
            h_prev.unflatten(1, (ngroups, nheads // ngroups)))
        inter = inter.flatten(3, 4).flatten(1, 2)[:, :seqlen - q]
        decay = torch.exp(torch.cumsum(lg[:, :, 1:], -1)).flatten(-2)
        y[:, q:] += inter * decay[..., :seqlen - q].transpose(1, 2)[..., None]
    state = h_inc[:, :, -1].unflatten(-1, (nstate, hdim)).transpose(-1, -2)
    return y.to(x.dtype), state.contiguous()


def ssd_scan_logdepth(x, dt, a, b, c, *, return_state: bool = False):
    """Mamba-2 SSD scan by carry-free chunk passes and a log-depth tree over
    the chunk states: the arguments and results of :func:`ssd_scan`
    (differentiable)."""
    y, state = _via_plain(_ssd_logdepth_fwd, ref.ssd_scan_ref, x, dt, a, b,
                          c, return_state=True)
    return (y, state) if return_state else y

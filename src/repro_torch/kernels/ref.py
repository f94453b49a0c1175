"""Plain PyTorch oracles for every kernel of this package.

The ground truth each kernel is held against (on the card by
``chip_smoke.py`` and ``tests/test_torch_*``), the version a kernel wrapper
runs for a CPU tensor, and the formulation every kernel's backward goes
through. Keep them boring and obviously correct.
"""
from __future__ import annotations

import torch


def segmented_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, f32 accumulation. x: (..., n) -> (...,)."""
    return torch.sum(x.float(), dim=-1)


def segmented_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-sum over the last axis, f32 accumulation."""
    return torch.cumsum(x.float(), dim=-1)


def weighted_scan_ref(x: torch.Tensor, log_a: torch.Tensor) -> torch.Tensor:
    """Decayed scan ``y_i = exp(log_a_i) * y_{i-1} + x_i`` along the last
    axis, f32 accumulation.

    A log-step (Hillis-Steele) scan of the pairs ``(a, y) = (exp(log_a),
    x)`` under the combine of the JAX oracle's ``associative_scan``,
    ``(a_l, y_l) . (a_r, y_r) = (a_l a_r, y_r + a_r y_l)``: round k combines
    every element with the one ``2^k`` before it, ``ceil(log2 n)`` rounds of
    elementwise ops in all."""
    a = torch.exp(log_a.float())
    y = x.to(torch.float32, copy=True)     # never the caller's tensor
    n, d = y.shape[-1], 1
    while d < n:
        y = torch.cat([y[..., :d], y[..., d:] + a[..., d:] * y[..., :-d]], -1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], -1)
        d *= 2
    return y


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: x * rsqrt(mean(x^2) + eps) * w."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def flash_attention_ref(
    q: torch.Tensor,       # (B, Hq, Lq, D)
    k: torch.Tensor,       # (B, Hkv, Lk, D)
    v: torch.Tensor,       # (B, Hkv, Lk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain softmax attention in kernel layout, f32 math, output in q's
    dtype. GQA by repeating each KV head over its ``Hq / Hkv`` query heads;
    query positions are offset by ``Lk - Lq`` so the sequence ends align;
    masked logits are ``-inf`` (a row with nothing visible is NaN, as in the
    reference oracle)."""
    lq, d = q.shape[2], q.shape[3]
    hkv, lk = k.shape[1], k.shape[2]
    rep = q.shape[1] // hkv
    kf = torch.repeat_interleave(k.float(), rep, dim=1)
    vf = torch.repeat_interleave(v.float(), rep, dim=1)
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * s
    qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    kpos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def ssd_scan_ref(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H)      softplus'd step sizes, > 0
    a: torch.Tensor,       # (H,)           negative decay rates
    b: torch.Tensor,       # (B, L, G, N)
    c: torch.Tensor,       # (B, L, G, N)
    *,
    return_state: bool = False,
):
    """Sequential reference of the Mamba-2 SSD recurrence.

    state_t = exp(a * dt_t) * state_{t-1} + dt_t * x_t b_t^T
    y_t     = state_t . c_t
    Heads within a group share B/C (H % G == 0). With ``return_state=True``
    also returns the final state (B, H, P, N) f32.
    """
    bsz, seqlen, nheads, hdim = x.shape
    ngroups, nstate = b.shape[2], b.shape[3]
    rep = nheads // ngroups
    bf = torch.repeat_interleave(b.float(), rep, dim=2)      # (B, L, H, N)
    cf = torch.repeat_interleave(c.float(), rep, dim=2)
    xf = x.float()
    dtf = dt.float()
    decay = torch.exp(dtf * a.float())                       # (B, L, H)
    state = torch.zeros((bsz, nheads, hdim, nstate), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(seqlen):
        state = decay[:, t, :, None, None] * state + (
            dtf[:, t, :, None, None] * bf[:, t, :, None, :]
            * xf[:, t, :, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, t]))
    if ys:
        y = torch.stack(ys, dim=1).to(x.dtype)               # (B, L, H, P)
    else:
        y = x.clone()
    return (y, state) if return_state else y


# ---------------------------------------------------------------------------
# the log-depth family's local passes: each block restarts from zero


def pad_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x (..., n)`` zero-padded to whole blocks, as ``(..., nb, block)``."""
    n = x.shape[-1]
    pad = -(-n // block) * block - n
    return torch.nn.functional.pad(x, (0, pad)).unflatten(-1, (-1, block))


def pad_chunks(t: torch.Tensor, q: int) -> torch.Tensor:
    """``t (B, L, ...)`` zero-padded to whole chunks, as
    ``(B, nchunks, q, ...)``."""
    pad = -(-t.shape[1] // q) * q - t.shape[1]
    t = torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    return t.unflatten(1, (-1, q))


def local_scan_ref(x: torch.Tensor, block_n: int) -> torch.Tensor:
    """Inclusive prefix sum of every ``block_n`` block of the last axis, each
    block restarted from zero, f32."""
    n = x.shape[-1]
    y = torch.cumsum(pad_blocks(x.float(), block_n), -1)
    return y.flatten(-2)[..., :n]


def local_weighted_ref(x: torch.Tensor, log_a: torch.Tensor,
                       q: int) -> torch.Tensor:
    """:func:`weighted_scan_ref` of every ``q`` block of the last axis, each
    block restarted from zero, f32."""
    n = x.shape[-1]
    y = weighted_scan_ref(pad_blocks(x.float(), q),
                          pad_blocks(log_a.float(), q))
    return y.flatten(-2)[..., :n]


def local_ssd_ref(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H)
    a: torch.Tensor,       # (H,)
    b: torch.Tensor,       # (B, L, G, N)
    c: torch.Tensor,       # (B, L, G, N)
    q: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD of every chunk of ``q`` steps on its own, in matmul form with
    explicit masks. Returns ``y_local (B, L, H, P)`` f32, the intra-chunk
    outputs ``((C B^T) o M) (dt o X)`` with ``M[t, s] = exp(Lambda_t -
    Lambda_s)`` for ``s <= t`` (masked before the exp), and the chunk states
    ``S (B, H, nchunks, N, P)`` f32, ``S = (B o w)^T (dt o X)`` with
    ``w_s = exp(Lambda_last - Lambda_s)``. A ragged last chunk is padded
    with zero steps, which leave both exact."""
    bsz, seqlen, nheads, hdim = x.shape
    ngroups = b.shape[2]
    rep = nheads // ngroups

    dtf = dt.float()
    xdt = pad_chunks(x.float() * dtf[..., None], q)         # (B,nc,q,H,P)
    cum = torch.cumsum(pad_chunks(dtf * a.float(), q), 2)   # (B,nc,q,H)
    bh = torch.repeat_interleave(pad_chunks(b.float(), q), rep, dim=3)
    ch = torch.repeat_interleave(pad_chunks(c.float(), q), rep, dim=3)
    idx = torch.arange(q, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]     # (t, s, 1)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,t,s,H)
    m = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    cb = torch.einsum("bjthn,bjshn->bjtsh", ch, bh)
    y = torch.einsum("bjtsh,bjshp->bjthp", cb * m, xdt)
    w = torch.exp(cum[:, :, -1:] - cum)                     # (B,nc,q,H)
    s = torch.einsum("bjshn,bjshp->bhjnp", bh * w[..., None], xdt)
    return y.flatten(1, 2)[:, :seqlen], s

"""Layer implementations: GQA attention, SwiGLU MLP, the Mamba-2 (SSD)
mixer.

Functional, as in the reference: ``<layer>_pspec(cfg)`` declares one
layer's parameters, ``<layer>_apply`` runs the full sequence,
``<layer>_decode`` steps a cache, ``<layer>_decode_block`` steps the
continuous scheduler's per-slot cache (``<layer>_cache_pspec``) by T tokens
with a valid count per slot, writing it in place and reading no device
value on the host (the step is captured in a CUDA graph). Attention, the
SSD and the norms go
through ``repro_torch.core.dispatch`` under ``ModelConfig.policy`` (None:
the Hopper kernels). Parameter layouts are the reference's, e.g.
``in_proj`` is ``(d, e)`` and ``y = x @ W``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch
from repro_torch.core.ssd import ssd_decode_step
from repro_torch.models.common import PSpec, rmsnorm, rope, swiglu
from repro_torch.models.xla_attention import decode_attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "ssm" and "dense" are ported
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    swa_window: int | None = None
    tie_embeddings: bool = False
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4
    expand: int = 2
    ssd_chunk: int = 128           # chunk of the ``fused`` SSD form
    dtype: torch.dtype = torch.bfloat16
    # path policy for every core op of the model (None: the kernels)
    policy: str | None = None

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


# ---------------------------------------------------------------------------
# attention


def attn_pspec(cfg: ModelConfig):
    """One attention layer's parameters."""
    d, dh, hq, hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": PSpec((d, hq * dh)),
        "wk": PSpec((d, hkv * dh)),
        "wv": PSpec((d, hkv * dh)),
        "wo": PSpec((hq * dh, d)),
    }


def attn_apply(p, cfg: ModelConfig, x, *, positions, causal=True,
               window=None):
    """Self-attention. x (B,S,d), positions (B,S) -> (out (B,S,d), (k, v))
    with k, v (B,S,Hkv,Dh) after rope, for the cache."""
    b, s, _ = x.shape
    dh, hq, hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    q = rope((x @ p["wq"]).reshape(b, s, hq, dh), positions, cfg.rope_theta)
    k = rope((x @ p["wk"]).reshape(b, s, hkv, dh), positions, cfg.rope_theta)
    v = (x @ p["wv"]).reshape(b, s, hkv, dh)
    o = dispatch.attention(q, k, v, causal=causal, window=window,
                           policy=cfg.policy)
    return o.reshape(b, s, hq * dh) @ p["wo"], (k, v)


def attn_decode(p, cfg: ModelConfig, x, cache, *, pos: int):
    """x (B,1,d); cache {k, v: (B,Smax,Hkv,Dh)} -> out (B,1,d).

    Writes this token's k, v at row ``pos`` of the cache in place and
    attends rows ``[0, pos]`` (the reference's scalar-position decode of
    the wave path; the ring is :func:`attn_decode_block`'s)."""
    b = x.shape[0]
    dh, hq, hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = rope((x @ p["wq"]).reshape(b, 1, hq, dh), posv, cfg.rope_theta)
    k = rope((x @ p["wk"]).reshape(b, 1, hkv, dh), posv, cfg.rope_theta)
    v = (x @ p["wv"]).reshape(b, 1, hkv, dh)
    kc, vc = cache["k"], cache["v"]
    kc[:, pos] = k[:, 0].to(kc.dtype)
    vc[:, pos] = v[:, 0].to(vc.dtype)
    o = decode_attention(q, kc, vc, pos + 1)
    return o.reshape(b, 1, hq * dh) @ p["wo"]


def attn_decode_block(p, cfg: ModelConfig, x, cache, *, n_valid):
    """Slot-masked T-token step against a ring KV cache.

    x (B,T,d); cache {k, v: (B,S,Hkv,Dh), pos: (B,)}; ``n_valid`` (B,) in
    [0, T]: token t of slot b is real iff ``t < n_valid[b]``. A real token
    is written at ring row ``(pos[b] + t) % S`` and attends ``min(pos[b] +
    t + 1, S)`` rows; rope takes the absolute positions. The rows are
    written in place by index: the old rows are gathered, replaced where
    the token is real, and scattered back. With ``T <= S`` the T rows of a
    slot are distinct, so the write is exact and order-free. Returns out
    (B,T,d); the caller advances ``pos``."""
    b, t_len = x.shape[:2]
    dh, hq, hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    kc, vc = cache["k"], cache["v"]
    smax = kc.shape[1]
    if t_len > smax:
        raise ValueError(f"a block step of {t_len} tokens needs a ring of at "
                         f"least {t_len} rows, the cache has {smax}")
    steps = torch.arange(t_len, device=x.device)
    posmat = cache["pos"].long()[:, None] + steps[None, :]      # (B, T)
    q = rope((x @ p["wq"]).reshape(b, t_len, hq, dh), posmat, cfg.rope_theta)
    k = rope((x @ p["wk"]).reshape(b, t_len, hkv, dh), posmat,
             cfg.rope_theta)
    v = (x @ p["wv"]).reshape(b, t_len, hkv, dh)
    valid = (steps[None, :] < n_valid[:, None])[..., None, None]
    idx = (posmat % smax)[..., None, None].expand(b, t_len, hkv, dh)
    for c, new in ((kc, k), (vc, v)):
        c.scatter_(1, idx, torch.where(valid, new.to(c.dtype),
                                       c.gather(1, idx)))
    o = decode_attention(q, kc, vc, torch.clamp(posmat + 1, max=smax))
    return o.reshape(b, t_len, hq * dh) @ p["wo"]


def attn_cache_pspec(cfg: ModelConfig, n_layers: int, batch: int, smax: int):
    """The ring KV cache of ``n_layers`` layers: ``min(smax, swa_window)``
    rows a slot."""
    cap = min(smax, cfg.swa_window) if cfg.swa_window else smax
    shp = (n_layers, batch, cap, cfg.n_kv_heads, cfg.dh)
    return {"k": PSpec(shp, "zeros"), "v": PSpec(shp, "zeros"),
            "pos": PSpec((), "zeros", torch.int32)}


# ---------------------------------------------------------------------------
# dense MLP


def mlp_pspec(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_in": PSpec((d, f)), "w_gate": PSpec((d, f)),
            "w_out": PSpec((f, d))}


def mlp_apply(p, cfg: ModelConfig, x):
    return swiglu(x, p["w_in"], p["w_gate"], p["w_out"])


# ---------------------------------------------------------------------------
# Mamba-2 mixer


def mamba_pspec(cfg: ModelConfig):
    """One Mamba-2 layer's parameters."""
    d, di = cfg.d_model, cfg.d_inner
    g, ns, hh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * ns
    return {
        "in_proj": PSpec((d, 2 * di + 2 * g * ns + hh)),
        "conv_w": PSpec((cfg.conv_kernel, conv_dim), "fan_in"),
        "conv_b": PSpec((conv_dim,), "zeros"),
        "dt_bias": PSpec((hh,), "dt_bias", torch.float32),
        "a_log": PSpec((hh,), "a_log", torch.float32),
        "d_skip": PSpec((hh,), "ones", torch.float32),
        "norm_w": PSpec((di,), "ones"),
        "out_proj": PSpec((di, d)),
    }


def _split_inproj(cfg: ModelConfig, zxbcdt):
    di, g, ns, hh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * ns]
    dt = zxbcdt[..., di + di + 2 * g * ns:]
    if dt.shape[-1] != hh:
        raise ValueError(f"in_proj width leaves {dt.shape[-1]} dt columns, "
                         f"expected {hh}")
    return z, xbc, dt


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv. xbc (B,S,C), w (K,C) -> (B,S,C), in f32."""
    k, ch = w.shape
    xp = F.pad(xbc.float().transpose(1, 2), (k - 1, 0))     # (B, C, S+K-1)
    out = F.conv1d(xp, w.float().t().unsqueeze(1), groups=ch)
    return F.silu(out.transpose(1, 2) + bias.float()).to(xbc.dtype)


def mamba_apply(p, cfg: ModelConfig, x, *, collect_cache: bool = False):
    """x (B,S,d) -> (out (B,S,d), cache-or-None). Full-sequence path."""
    b, s, _ = x.shape
    di, g, ns = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    hh, hp = cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xbc_raw, dt_raw = _split_inproj(cfg, zxbcdt)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di].reshape(b, s, hh, hp)
    bmat = xbc[..., di:di + g * ns].reshape(b, s, g, ns)
    cmat = xbc[..., di + g * ns:].reshape(b, s, g, ns)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, state = dispatch.ssd(xs, dt, a, bmat, cmat, chunk=cfg.ssd_chunk,
                            matmul_dtype=cfg.dtype, return_state=True,
                            policy=cfg.policy)
    y = y + p["d_skip"][:, None].float() * xs.float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps, cfg.policy)
    out = y @ p["out_proj"]
    cache = None
    if collect_cache:
        # conv cache = last K-1 *raw* mixer inputs; state (B,H,P,N) from SSD
        cache = {"conv": xbc_raw[:, -(cfg.conv_kernel - 1):].clone(),
                 "state": state}
    return out, cache


def mamba_cache_pspec(cfg: ModelConfig, n_layers: int, batch: int):
    """Conv history (the last K-1 raw mixer inputs) and SSD state of
    ``n_layers`` layers."""
    di, g, ns = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    conv_dim = di + 2 * g * ns
    return {
        "conv": PSpec((n_layers, batch, cfg.conv_kernel - 1, conv_dim),
                      "zeros"),
        "state": PSpec((n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, ns),
                       "zeros", torch.float32),
    }


def mamba_decode(p, cfg: ModelConfig, x, cache):
    """x (B,1,d); cache {conv (B,K-1,C), state (B,H,P,N)} -> (out, cache)."""
    b = x.shape[0]
    di, g, ns = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    hh, hp = cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = _split_inproj(cfg, zxbcdt)
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float())
    xbc_t = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)
    xs = xbc_t[..., :di].reshape(b, hh, hp)
    bmat = xbc_t[..., di:di + g * ns].reshape(b, g, ns)
    cmat = xbc_t[..., di + g * ns:].reshape(b, g, ns)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, state = ssd_decode_step(cache["state"], xs, dt, a, bmat, cmat)
    y = y + p["d_skip"][None, :, None] * xs.float()
    y = y.reshape(b, 1, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps, cfg.policy)
    out = y @ p["out_proj"]
    return out, {"conv": hist[:, 1:], "state": state}


def mamba_decode_block(p, cfg: ModelConfig, x, cache, *, n_valid):
    """Slot-masked T-token recurrent step.

    x (B,T,d); cache {conv (B,K-1,C), state (B,H,P,N)}; slot b consumes its
    first ``n_valid[b]`` tokens. The conv runs VALID over [cached history |
    chunk] in f32; the SSD recurrence is a loop over T of
    :func:`ssd_decode_step` whose new state is kept only where the token is
    real, so a slot's state stops at its own ``n_valid``. The new conv
    history is the K-1 raw inputs before each slot's next token. Returns
    (out (B,T,d), {conv, state}); the outputs of tokens past ``n_valid``
    are junk the caller discards."""
    b, t_len = x.shape[:2]
    di, g, ns = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    hh, hp, kk = cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_kernel
    zxbcdt = x @ p["in_proj"]
    z, xbc_raw, dt_raw = _split_inproj(cfg, zxbcdt)
    conv = cache["conv"]
    hist = torch.cat([conv, xbc_raw.to(conv.dtype)], dim=1)  # (B,K-1+T,C)
    ch = hist.shape[-1]
    conv_out = F.conv1d(hist.float().transpose(1, 2),
                        p["conv_w"].float().t().unsqueeze(1), groups=ch)
    xbc = F.silu(conv_out.transpose(1, 2) + p["conv_b"].float()).to(x.dtype)
    xs = xbc[..., :di].reshape(b, t_len, hh, hp)
    bmat = xbc[..., di:di + g * ns].reshape(b, t_len, g, ns)
    cmat = xbc[..., di + g * ns:].reshape(b, t_len, g, ns)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    steps = torch.arange(t_len, device=x.device)
    upd = (steps[:, None] < n_valid[None, :])[..., None, None, None]
    state, ys = cache["state"], []
    for t in range(t_len):
        y_t, new = ssd_decode_step(state, xs[:, t], dt[:, t], a, bmat[:, t],
                                   cmat[:, t])
        state = torch.where(upd[t], new, state)
        ys.append(y_t)
    y = torch.stack(ys, dim=1).float()                       # (B,T,H,P)
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(b, t_len, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps, cfg.policy)
    out = y @ p["out_proj"]
    rows = n_valid[:, None] + torch.arange(kk - 1, device=x.device)
    new_conv = hist.gather(1, rows[..., None].expand(b, kk - 1, ch))
    return out, {"conv": new_conv, "state": state}

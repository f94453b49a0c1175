"""Layer implementations, SSM part: the Mamba-2 (SSD) mixer.

Functional, as in the reference: ``mamba_pspec(cfg)`` declares one layer's
parameters, ``mamba_apply`` runs the full sequence, ``mamba_decode`` steps a
cache. The SSD and the gated RMSNorm go through ``repro_torch.core.dispatch``
under ``ModelConfig.policy`` (None: the Hopper kernels). Parameter layouts
are the reference's, e.g. ``in_proj`` is ``(d, e)`` and ``y = x @ W``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch
from repro_torch.core.ssd import ssd_decode_step
from repro_torch.models.common import PSpec, rmsnorm


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # only "ssm" is ported
    n_layers: int
    d_model: int
    vocab: int
    norm_eps: float = 1e-5
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
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


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

"""Adafactor (factored second moment) for the ≥300B configs.

Counterpart of ``repro.optim.adafactor``. Memory per param: 4 B (f32
canonical) + 2 B (bf16 momentum, ``state_dtype``) + ~0 (factored v),
against AdamW's 12 B.

Factoring follows Shazeer & Stern: for a leaf (..., n, m) keep row/col
second-moment EMAs (..., n) and (..., m); 0/1-D leaves keep a full v. The
update is RMS-clipped (Adafactor §7) before the momentum.

On a sharded state (``DTensor`` leaves) each rank updates its local shards;
the factored means and the RMS are completed over the mesh dims the leaf is
sharded on (``repro_torch.parallel.sharded_state``), so a factor whose
reduced dim is sharded ends replicated over that dim, as its spec says.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.optim.adamw import (
    OptConfig,
    _device,
    clip_scale,
    global_norm,
    lr_at,
    split_leaves,
)
from repro_torch.parallel.sharded_state import dim_mean, like, local, \
    total_mean


def init_adafactor_state(params, cfg: OptConfig):
    def factor(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    return {
        "m": tree.map_tree(lambda p: torch.zeros(
            p.shape, dtype=cfg.state_dtype, device=p.device), params),
        "v": tree.map_tree(factor, params),
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
    }


@torch.no_grad()
def adafactor_update(grads, opt_state, params, cfg: OptConfig):
    """-> (new_params, new_opt_state, metrics). params/grads f32."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, policy=cfg.policy)
    scale = clip_scale(gnorm, cfg)
    lr = lr_at(cfg, step)
    b2 = cfg.b2

    def upd(p_in, g, m, v_in):
        p, g, m = local(p_in), local(g), local(m)
        v = {k: local(t) for k, t in v_in.items()}
        g = g.float() * scale
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            vr = b2 * v["vr"] + (1 - b2) * dim_mean(g2, -1, p_in)
            vc = b2 * v["vc"] + (1 - b2) * dim_mean(g2, -2, p_in)
            vr_mean = dim_mean(vr, -1, p_in, -2, keepdim=True)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / vr_mean[..., None] + cfg.eps)
            v_new = {"vr": like(vr, v_in["vr"]), "vc": like(vc, v_in["vc"])}
        else:
            vfull = b2 * v["v"] + (1 - b2) * g2
            denom = torch.sqrt(vfull) + cfg.eps
            v_new = {"v": like(vfull, v_in["v"])}
        u = g / denom
        # RMS update clipping (Adafactor §7), then the momentum
        rms = torch.sqrt(total_mean(u * u, p_in) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * u
        p_new = p - lr * (m_new + cfg.weight_decay * p)
        return (like(p_new, p_in), like(m_new.to(cfg.state_dtype), p_in),
                v_new)

    out = tree.map_tree(upd, params, grads, opt_state["m"], opt_state["v"])
    new_p, new_m, new_v = split_leaves(params, out, 3)
    return (new_p, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})

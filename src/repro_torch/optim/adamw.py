"""AdamW with configurable moment dtypes + warmup-cosine schedule.

Counterpart of ``repro.optim.adamw``. Master params are f32; the moments
are kept in ``OptConfig.state_dtype`` (bf16 for the largest models). The
global-norm clip reduces each leaf's Σx² through
``repro_torch.core.dispatch.reduce`` under ``OptConfig.policy``: on the
card the default ``auto`` runs ``csrc/tcu_reduce.cu``, one launch a leaf,
each leaf one ``(1, n)`` row (``torch.sum`` on ``baseline``).

The update is functional, as the reference's: it returns new params and
moments and leaves its arguments as they were. A sharded state (``DTensor``
leaves, ``repro_torch.parallel.sharded_state``) updates each rank's local
shards: each leaf's local Σg² goes through the same kernel, and is then
summed over the mesh dims that leaf is sharded on, and only those.
Everything here runs under ``torch.no_grad()`` and reads no device value on
the host: ``step``, the learning rate and the norm stay tensors on the
params' device. The update records two spans (``obs.profiling``), each
waiting for the device at its ends while a profiler records:
``train/clip`` (the global norm and the clip factor) and ``train/update``
(the per-leaf pass).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree
from repro_torch.core import dispatch
from repro_torch.core import policy as kpolicy
from repro_torch.core.policy import KernelPolicy
from repro_torch.obs import profiling as _prof
from repro_torch.parallel.sharded_state import like, local, sharded_sums


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32   # m/v dtype (bf16 for ≥100B)
    # explicit KernelPolicy of the global-norm reduction (None: the active
    # policy); strings coerce
    policy: KernelPolicy | None = None
    # deprecated spelling of ``policy`` (a bare path label); warns once
    kernel_path: dataclasses.InitVar[str | None] = None

    def __post_init__(self, kernel_path):
        object.__setattr__(self, "policy", kpolicy.coerce_config_policy(
            self.policy, kernel_path, "OptConfig"))


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr_ratio * peak_lr`` at ``decay_steps``; f32, on
    ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _device(params) -> torch.device:
    return tree.leaves(params)[0].device


def init_opt_state(params, cfg: OptConfig):
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    return {
        "m": tree.map_tree(zeros, params),
        "v": tree.map_tree(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
    }


def global_norm(grads, *, policy=None) -> torch.Tensor:
    """sqrt(Σ Σx²) with each leaf's Σx² through the dispatch switch (the
    ``tcu_reduce`` kernel on ``tile``, the matmul form on ``fused``,
    ``torch.sum`` on ``baseline``), summed over the leaves in the
    reference's order. A ``DTensor`` leaf's reduce takes its local shard,
    and its sum is completed over the mesh dims it is sharded on."""
    leaves = tree.leaves(grads)
    sq = [dispatch.reduce(torch.square(local(g).float()).reshape(1, -1),
                          policy=policy)[0]
          for g in leaves]
    return torch.sqrt(torch.sum(torch.stack(sharded_sums(leaves, sq))))


def clip_scale(gnorm: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """The factor that scales the gradients to a global norm of at most
    ``clip_norm``."""
    return torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)


def split_leaves(params, out, n: int) -> list:
    """``out``, a tree of n-tuples on ``params``' structure -> n trees."""
    return [tree.map_tree(lambda _, o, i=i: o[i], params, out)
            for i in range(n)]


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig):
    """-> (new_params, new_opt_state, metrics). params/grads f32."""
    device = local(tree.leaves(params)[0]).device
    with _prof.span("train/clip", wait=device):
        gnorm = global_norm(grads, policy=cfg.policy)
        scale = clip_scale(gnorm, cfg)
    b1, b2 = cfg.b1, cfg.b2

    def upd(p_in, g, m, v):
        p, g, m, v = local(p_in), local(g), local(m), local(v)
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p_new = p - lr * (update + cfg.weight_decay * p)
        return (like(p_new, p_in), like(m_new.to(cfg.state_dtype), p_in),
                like(v_new.to(cfg.state_dtype), p_in))

    with _prof.span("train/update", wait=device):
        step = opt_state["step"] + 1
        lr = lr_at(cfg, step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        out = tree.map_tree(upd, params, grads, opt_state["m"],
                            opt_state["v"])
        new_p, new_m, new_v = split_leaves(params, out, 3)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics

"""Decoder-only LM assembly, ssm family (Mamba-2).

Counterpart of ``repro.models.lm`` for the families ported so far. The
reference scans a stacked layer axis with ``lax.scan``; here the layers are
a list and the loop is a Python loop. The decode cache keeps the
reference's stacked layout, ``conv (n_layers, B, K-1, C)`` and
``state (n_layers, B, H, P, N)``, and :func:`lm_decode` updates it in place
(one layer's slice at a time) instead of rebuilding it every token.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import (
    PSpec,
    count_params,
    embed_tokens,
    rmsnorm,
    unembed,
)


def _require_ported(cfg: L.ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to PyTorch yet; "
            "see ROADMAP.md for the order of the remaining families")


@dataclasses.dataclass(frozen=True)
class Bundle:
    """Everything the server needs for one architecture."""

    cfg: L.ModelConfig
    params_pspec: Any
    prefill_last: Callable   # (params, batch) -> (last logits, cache)
    decode: Callable         # (params, cache, batch) -> (logits, cache)
    n_params: int = 0


def lm_pspec(cfg: L.ModelConfig):
    _require_ported(cfg)
    d, v = cfg.d_model, cfg.vocab
    p: dict[str, Any] = {
        "embed": PSpec((v, d), "normal"),
        "final_norm": PSpec((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        p["head"] = PSpec((v, d), "normal")
    p["blocks"] = [{"ln": PSpec((d,), "ones"), "mamba": L.mamba_pspec(cfg)}
                   for _ in range(cfg.n_layers)]
    return p


def _head(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def lm_apply(params, cfg: L.ModelConfig, batch, *, collect_cache=False,
             last_only=False):
    """Full-sequence forward. Returns (logits, aux, cache-or-None).

    ``last_only`` unembeds just the final position (serving prefill), which
    avoids the (B, S, vocab) logits tensor. ``aux`` is the MoE auxiliary
    loss of the reference, zero for this family."""
    _require_ported(cfg)
    h = embed_tokens(params["embed"], batch["tokens"])
    b, s, _ = h.shape
    caches = []
    for lp in params["blocks"]:
        m_in = rmsnorm(h, lp["ln"], cfg.norm_eps, cfg.policy)
        out, cache = L.mamba_apply(lp["mamba"], cfg, m_in,
                                   collect_cache=collect_cache)
        h = h + out
        caches.append(cache)
    if last_only:
        h = h[:, -1:]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    logits = unembed(h, _head(params, cfg))
    cache = None
    if collect_cache:
        cache = {"pos": s, "mamba": {
            "conv": torch.stack([c["conv"] for c in caches]),
            "state": torch.stack([c["state"] for c in caches])}}
    return logits, torch.zeros((), device=h.device), cache


def lm_decode(params, cfg: L.ModelConfig, cache, batch):
    """One decode step. batch {"tokens": (B, 1)} -> (logits, cache); the
    cache's conv/state tensors are updated in place."""
    _require_ported(cfg)
    h = embed_tokens(params["embed"], batch["tokens"])       # (B, 1, d)
    conv, state = cache["mamba"]["conv"], cache["mamba"]["state"]
    for i, lp in enumerate(params["blocks"]):
        m_in = rmsnorm(h, lp["ln"], cfg.norm_eps, cfg.policy)
        out, c = L.mamba_decode(lp["mamba"], cfg, m_in,
                                {"conv": conv[i], "state": state[i]})
        conv[i].copy_(c["conv"])
        state[i].copy_(c["state"])
        h = h + out
    cache["pos"] = cache["pos"] + 1
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    return unembed(h, _head(params, cfg)), cache


def build_lm(cfg: L.ModelConfig) -> Bundle:
    pspec = lm_pspec(cfg)

    def prefill_last(params, batch):
        logits, _, cache = lm_apply(params, cfg, batch, collect_cache=True,
                                    last_only=True)
        return logits, cache

    def decode(params, cache, batch):
        return lm_decode(params, cfg, cache, batch)

    return Bundle(cfg=cfg, params_pspec=pspec, prefill_last=prefill_last,
                  decode=decode, n_params=count_params(pspec))

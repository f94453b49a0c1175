"""Decoder-only LM assembly: the dense (llama) and ssm (Mamba-2) families.

Counterpart of ``repro.models.lm`` for the families ported so far. The
reference scans a stacked layer axis with ``lax.scan``; here the layers are
a list and the loop is a Python loop. The decode cache keeps the
reference's stacked layout, ``attn.k``/``attn.v`` ``(n_layers, B, S, Hkv,
Dh)`` for dense and ``mamba.conv (n_layers, B, K-1, C)``/``mamba.state
(n_layers, B, H, P, N)`` for ssm, and :func:`lm_decode` updates it in place
(one layer's slice at a time) instead of rebuilding it every token. The
prefill cache holds exactly the prompt's positions; a server grows its
sequence axis with :func:`pad_cache_seq` before decoding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.common import (
    PSpec,
    count_params,
    embed_tokens,
    rmsnorm,
    unembed,
)


FAMILIES = ("dense", "ssm")


def _require_ported(cfg: L.ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to PyTorch yet; "
            "see ROADMAP.md for the order of the remaining families")
    if cfg.swa_window is not None:
        raise NotImplementedError(
            "the sliding-window (ring) KV cache is not ported to PyTorch "
            "yet; see ROADMAP.md")


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
    if cfg.family == "dense":
        p["blocks"] = [{"ln1": PSpec((d,), "ones"), "attn": L.attn_pspec(cfg),
                        "ln2": PSpec((d,), "ones"), "mlp": L.mlp_pspec(cfg)}
                       for _ in range(cfg.n_layers)]
    else:
        p["blocks"] = [{"ln": PSpec((d,), "ones"),
                        "mamba": L.mamba_pspec(cfg)}
                       for _ in range(cfg.n_layers)]
    return p


def _head(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def lm_apply(params, cfg: L.ModelConfig, batch, *, collect_cache=False,
             last_only=False):
    """Full-sequence forward. Returns (logits, aux, cache-or-None).

    ``last_only`` unembeds just the final position (serving prefill), which
    avoids the (B, S, vocab) logits tensor. ``aux`` is the MoE auxiliary
    loss of the reference, zero for these families."""
    _require_ported(cfg)
    h = embed_tokens(params["embed"], batch["tokens"])
    b, s, _ = h.shape
    caches = []
    if cfg.family == "dense":
        # positions from 0 in every row, left padding included, as in the
        # reference
        positions = torch.arange(s, device=h.device).expand(b, s)
        for lp in params["blocks"]:
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            a_out, kv = L.attn_apply(lp["attn"], cfg, a_in,
                                     positions=positions)
            h = h + a_out
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            h = h + L.mlp_apply(lp["mlp"], cfg, m_in)
            if collect_cache:
                caches.append(kv)
    else:
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
        cache = {"pos": s}
        if cfg.family == "dense":
            cache["attn"] = {"k": torch.stack([k for k, _ in caches]),
                             "v": torch.stack([v for _, v in caches])}
        else:
            cache["mamba"] = {
                "conv": torch.stack([c["conv"] for c in caches]),
                "state": torch.stack([c["state"] for c in caches])}
    return logits, torch.zeros((), device=h.device), cache


def pad_cache_seq(cache, extra: int):
    """Grow the sequence axis of the KV cache by ``extra`` zero rows (the
    reference's ``serving.engine._pad_cache_seq``); a cache without one
    (ssm) is returned as it is."""
    if "attn" in cache and extra > 0:
        cache["attn"] = {n: F.pad(t, (0, 0, 0, 0, 0, extra))
                         for n, t in cache["attn"].items()}
    return cache


def lm_decode(params, cfg: L.ModelConfig, cache, batch):
    """One decode step. batch {"tokens": (B, 1)} -> (logits, cache); the
    cache's tensors are updated in place (dense: the new token's k, v at
    row ``pos``)."""
    _require_ported(cfg)
    h = embed_tokens(params["embed"], batch["tokens"])       # (B, 1, d)
    pos = cache["pos"]
    if cfg.family == "dense":
        k, v = cache["attn"]["k"], cache["attn"]["v"]
        if pos >= k.shape[2]:
            raise ValueError(f"KV cache of {k.shape[2]} positions is full at "
                             f"position {pos}; grow it with pad_cache_seq")
        for i, lp in enumerate(params["blocks"]):
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            h = h + L.attn_decode(lp["attn"], cfg, a_in,
                                  {"k": k[i], "v": v[i]}, pos=pos)
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            h = h + L.mlp_apply(lp["mlp"], cfg, m_in)
    else:
        conv, state = cache["mamba"]["conv"], cache["mamba"]["state"]
        for i, lp in enumerate(params["blocks"]):
            m_in = rmsnorm(h, lp["ln"], cfg.norm_eps, cfg.policy)
            out, c = L.mamba_decode(lp["mamba"], cfg, m_in,
                                    {"conv": conv[i], "state": state[i]})
            conv[i].copy_(c["conv"])
            state[i].copy_(c["state"])
            h = h + out
    cache["pos"] = pos + 1
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

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

The continuous scheduler's cache (:func:`lm_cache_pspec` with
``per_slot_pos=True``) is a ring of ``min(capacity, swa_window)`` rows a
slot with a position per slot, stepped by :func:`lm_decode_block`. That
step takes the sliding window; the wave path (:func:`lm_apply`,
:func:`lm_decode`) does not yet.
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


def _require_unwindowed(cfg: L.ModelConfig) -> None:
    if cfg.swa_window is not None:
        raise NotImplementedError(
            "the wave path (lm_apply, lm_decode) does not take a sliding "
            "window in PyTorch yet; serve a windowed model with the "
            "continuous scheduler (see ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class Bundle:
    """Everything the server needs for one architecture."""

    cfg: L.ModelConfig
    params_pspec: Any
    prefill_last: Callable   # (params, batch) -> (last logits, cache)
    decode: Callable         # (params, cache, batch) -> (logits, cache)
    n_params: int = 0
    # (batch, smax, per_slot_pos=False, kind="ring") -> PSpec tree
    cache_pspec: Callable = None
    # continuous-batching slot step: (params, cache, {tokens (B, T)}, *,
    # n_valid (B,), reset_mask (B,)) -> (logits (B, vocab), cache), the
    # cache updated in place
    decode_block: Callable = None


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
    _require_unwindowed(cfg)
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
    _require_unwindowed(cfg)
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


def lm_cache_pspec(cfg: L.ModelConfig, batch: int, smax: int,
                   per_slot_pos: bool = False, *, kind: str = "ring"):
    """Decode-cache declaration. ``per_slot_pos=True`` declares the
    continuous-batching layout: ``pos`` is a (batch,) vector, one position
    per slot. Dense: a KV ring of ``min(smax, swa_window)`` rows a slot;
    ssm: conv history and state. Only the ring kind is ported."""
    _require_ported(cfg)
    if kind != "ring":
        raise NotImplementedError(
            f"cache kind {kind!r} is not ported to PyTorch yet (the paged KV "
            "pool is queue 1 of ROADMAP.md); use kind='ring'")
    cache: dict[str, Any] = {
        "pos": PSpec((batch,) if per_slot_pos else (), "zeros", torch.int32)}
    if cfg.family == "dense":
        cache["attn"] = L.attn_cache_pspec(cfg, cfg.n_layers, batch, smax)
        del cache["attn"]["pos"]
    else:
        cache["mamba"] = L.mamba_cache_pspec(cfg, cfg.n_layers, batch)
    return cache


def lm_decode_block(params, cfg: L.ModelConfig, cache, batch, *,
                    n_valid, reset_mask):
    """Slot-masked T-token step: the continuous-batching workhorse.

    batch {"tokens": (B, T)}; slot b consumes its first ``n_valid[b]`` in
    [0, T] tokens (0: the slot is untouched); ``reset_mask`` (B,) clears a
    slot's sequence state first (pos -> 0, conv and state -> 0), as on
    admission of a new request; stale KV rows need no clearing, the
    per-slot lengths hide them. One call serves chunked prefill and
    single-token decode across slots.

    The cache's tensors are updated in place, and nothing here reads a
    device value on the host, so the step can be captured in a CUDA graph
    and replayed. Returns (logits (B, vocab) after each slot's last valid
    token, cache); an idle slot's row is junk the caller ignores."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    b, t_len = tokens.shape
    dev = tokens.device
    n_valid = torch.as_tensor(n_valid, device=dev).long()
    reset = torch.as_tensor(reset_mask, device=dev).bool()
    pos = torch.where(reset, 0, cache["pos"])
    h = embed_tokens(params["embed"], tokens)                # (B, T, d)
    if cfg.family == "dense":
        k, v = cache["attn"]["k"], cache["attn"]["v"]
        for i, lp in enumerate(params["blocks"]):
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            h = h + L.attn_decode_block(
                lp["attn"], cfg, a_in, {"k": k[i], "v": v[i], "pos": pos},
                n_valid=n_valid)
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            h = h + L.mlp_apply(lp["mlp"], cfg, m_in)
    else:
        conv, state = cache["mamba"]["conv"], cache["mamba"]["state"]
        for i, lp in enumerate(params["blocks"]):
            m_in = rmsnorm(h, lp["ln"], cfg.norm_eps, cfg.policy)
            out, c = L.mamba_decode_block(
                lp["mamba"], cfg, m_in,
                {"conv": torch.where(reset[:, None, None], 0, conv[i]),
                 "state": torch.where(reset[:, None, None, None], 0,
                                      state[i])},
                n_valid=n_valid)
            conv[i].copy_(c["conv"])
            state[i].copy_(c["state"])
            h = h + out
    cache["pos"].copy_(pos + n_valid)
    last = torch.clamp(n_valid - 1, min=0)
    h_last = h.gather(1, last[:, None, None].expand(b, 1, h.shape[-1]))
    h_last = rmsnorm(h_last, params["final_norm"], cfg.norm_eps, cfg.policy)
    return unembed(h_last, _head(params, cfg))[:, 0], cache


def build_lm(cfg: L.ModelConfig) -> Bundle:
    pspec = lm_pspec(cfg)

    def prefill_last(params, batch):
        logits, _, cache = lm_apply(params, cfg, batch, collect_cache=True,
                                    last_only=True)
        return logits, cache

    def decode(params, cache, batch):
        return lm_decode(params, cfg, cache, batch)

    def decode_block(params, cache, batch, *, n_valid, reset_mask):
        return lm_decode_block(params, cfg, cache, batch, n_valid=n_valid,
                               reset_mask=reset_mask)

    def cache_pspec(batch: int, smax: int, per_slot_pos: bool = False,
                    **kind_kwargs):
        return lm_cache_pspec(cfg, batch, smax, per_slot_pos=per_slot_pos,
                              **kind_kwargs)

    return Bundle(cfg=cfg, params_pspec=pspec, prefill_last=prefill_last,
                  decode=decode, n_params=count_params(pspec),
                  cache_pspec=cache_pspec, decode_block=decode_block)

"""Encoder-decoder LM (the seamless-m4t backbone).

Counterpart of ``repro.models.encdec``. The audio frontend is a stub, as in
the reference: ``batch["frames"]`` (B, S_enc, d) holds precomputed frame
embeddings, the frontend's output, and the transformer backbone is modelled
whole: a bidirectional encoder (flash attention without a causal mask, rope
from position 0) and a causal decoder whose every layer attends the
encoder's memory after its self-attention (cross-attention: K and V from
the memory, no rope, no mask). The layers are lists, ``enc`` and ``dec``,
as the decoder-only models' ``blocks``; the train state stacks them
(:func:`~repro_torch.models.common.stack_pspec`).

Decode keeps the reference's cache: ``self_k``/``self_v`` ``(dec layers, B,
S, Hkv, Dh)``, written in place at ``pos`` as in
:func:`~repro_torch.models.lm.lm_decode`, and the cross-attention's
``cross_k``/``cross_v`` over the memory, computed once at the prefill. The
prefill's self cache holds exactly the prompt's positions; a server grows it
with :func:`~repro_torch.models.lm.pad_cache_seq`, and a decode step at a
position past it raises (the reference clamps the write onto the last row
and attends a wrong cache). There is no block step: the continuous
scheduler falls back to the wave, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import (
    PSpec,
    count_params,
    cross_entropy,
    embed_tokens,
    rmsnorm,
    unembed,
    unstack_blocks,
)
from repro_torch.models.lm import Bundle, _remat
from repro_torch.models.xla_attention import decode_attention


def encdec_pspec(cfg: L.ModelConfig):
    d, v = cfg.d_model, cfg.vocab
    return {
        "embed": PSpec((v, d), "normal", logical=("vocab", "embed")),
        "head": PSpec((v, d), "normal", logical=("vocab", "embed")),
        "enc": [{"ln1": PSpec((d,), "ones", logical=("embed",)),
                 "attn": L.attn_pspec(cfg),
                 "ln2": PSpec((d,), "ones", logical=("embed",)),
                 "mlp": L.mlp_pspec(cfg)}
                for _ in range(cfg.enc_layers)],
        "enc_norm": PSpec((d,), "ones", logical=("embed",)),
        "dec": [{"ln1": PSpec((d,), "ones", logical=("embed",)),
                 "attn": L.attn_pspec(cfg),
                 "lnx": PSpec((d,), "ones", logical=("embed",)),
                 "xattn": L.attn_pspec(cfg),
                 "ln2": PSpec((d,), "ones", logical=("embed",)),
                 "mlp": L.mlp_pspec(cfg)}
                for _ in range(cfg.n_layers)],
        "final_norm": PSpec((d,), "ones", logical=("embed",)),
    }


def _frames(cfg: L.ModelConfig, batch) -> torch.Tensor:
    if "frames" not in batch:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its batch needs 'frames' of "
            f"shape (B, S_enc, {cfg.d_model}), the speech frontend's frame "
            "embeddings; none was given")
    return batch["frames"]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _layers(cfg: L.ModelConfig, layer):
    """``layer`` under ``cfg.remat_policy`` when gradients are on."""
    return _remat(layer, cfg.remat_policy) if torch.is_grad_enabled() \
        else layer


def encode(params, cfg: L.ModelConfig, frames) -> torch.Tensor:
    """frames (B, S_enc, d) -> the encoder's memory (B, S_enc, d)."""
    h = frames.to(cfg.dtype)
    positions = _positions(h.shape[0], h.shape[1], h.device)

    def layer(h, lp):
        a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
        a_out, _ = L.attn_apply(lp["attn"], cfg, a_in, positions=positions,
                                causal=False)
        h = h + a_out
        m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
        return h + L.mlp_apply(lp["mlp"], cfg, m_in)

    layer = _layers(cfg, layer)
    for lp in params["enc"]:
        h = layer(h, lp)
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps, cfg.policy)


def decode_train(params, cfg: L.ModelConfig, tokens, memory, *,
                 collect_cache=False, last_only=False):
    """The decoder over ``tokens`` (B, S) against ``memory``: (logits, each
    layer's ((k, v), (cross k, cross v)) with ``collect_cache``, else
    None). ``last_only`` unembeds the final position only."""
    h = embed_tokens(params["embed"], tokens)
    positions = _positions(h.shape[0], h.shape[1], h.device)

    def layer(h, lp):
        a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
        a_out, kv = L.attn_apply(lp["attn"], cfg, a_in, positions=positions)
        h = h + a_out
        x_in = rmsnorm(h, lp["lnx"], cfg.norm_eps, cfg.policy)
        x_out, xkv = L.attn_apply(lp["xattn"], cfg, x_in, kv=memory)
        h = h + x_out
        m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
        return h + L.mlp_apply(lp["mlp"], cfg, m_in), \
            (kv, xkv) if collect_cache else None

    layer = _layers(cfg, layer)
    caches = []
    for lp in params["dec"]:
        h, c = layer(h, lp)
        caches.append(c)
    if last_only:
        h = h[:, -1:]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    return unembed(h, params["head"]), caches if collect_cache else None


def encdec_loss(params, cfg: L.ModelConfig, batch) -> torch.Tensor:
    """Mean token cross-entropy of the decoder on ``batch`` {frames,
    tokens, labels}."""
    memory = encode(params, cfg, _frames(cfg, batch))
    logits, _ = decode_train(params, cfg, batch["tokens"], memory)
    return cross_entropy(logits, batch["labels"])


def encdec_cache_pspec(cfg: L.ModelConfig, batch: int, smax: int):
    """The decode cache, ``smax`` split evenly between the encoder's memory
    (the cross K/V) and the decoder's self cache, as in the reference."""
    s_enc = s_dec = smax // 2
    nd, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.dh
    log = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {
        "self_k": PSpec((nd, batch, s_dec, hkv, dh), "zeros", logical=log),
        "self_v": PSpec((nd, batch, s_dec, hkv, dh), "zeros", logical=log),
        "cross_k": PSpec((nd, batch, s_enc, hkv, dh), "zeros", logical=log),
        "cross_v": PSpec((nd, batch, s_enc, hkv, dh), "zeros", logical=log),
        "pos": PSpec((), "zeros", torch.int32),
    }


def encdec_prefill(params, cfg: L.ModelConfig, batch, *, last_only=False):
    """The encoder over ``batch["frames"]``, then the decoder over
    ``batch["tokens"]``: (logits, cache), the logits of every position or,
    with ``last_only``, of the last."""
    frames = _frames(cfg, batch)
    memory = encode(params, cfg, frames)
    logits, caches = decode_train(params, cfg, batch["tokens"], memory,
                                  collect_cache=True, last_only=last_only)
    cache = {name: torch.stack([c[i][j] for c in caches])
             for name, i, j in (("self_k", 0, 0), ("self_v", 0, 1),
                                ("cross_k", 1, 0), ("cross_v", 1, 1))}
    cache["pos"] = batch["tokens"].shape[1]
    return logits, cache


def encdec_decode(params, cfg: L.ModelConfig, cache, batch):
    """One decode step. batch {"tokens": (B, 1)} -> (logits, cache): the
    token's self-attention k, v written at row ``pos`` of the self cache in
    place, then cross-attention over every row of the memory's K/V."""
    h = embed_tokens(params["embed"], batch["tokens"])       # (B, 1, d)
    pos = cache["pos"]
    rows = cache["self_k"].shape[2]
    if pos >= rows:
        raise ValueError(f"self-attention cache of {rows} positions is full "
                         f"at position {pos}; grow it with pad_cache_seq")
    b = h.shape[0]
    dh, hq = cfg.dh, cfg.n_heads
    s_enc = cache["cross_k"].shape[2]
    for i, lp in enumerate(params["dec"]):
        a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
        h = h + L.attn_decode(lp["attn"], cfg, a_in,
                              {"k": cache["self_k"][i],
                               "v": cache["self_v"][i]}, pos=pos)
        x_in = rmsnorm(h, lp["lnx"], cfg.norm_eps, cfg.policy)
        q = (x_in @ lp["xattn"]["wq"]).reshape(b, 1, hq, dh)
        o = decode_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                             s_enc)
        h = h + o.reshape(b, 1, hq * dh) @ lp["xattn"]["wo"]
        m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
        h = h + L.mlp_apply(lp["mlp"], cfg, m_in)
    cache["pos"] = pos + 1
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    return unembed(h, params["head"]), cache


def build_encdec(cfg: L.ModelConfig) -> Bundle:
    if cfg.enc_layers < 1 or cfg.n_layers < 1:
        raise ValueError(f"an encoder-decoder needs enc_layers "
                         f"({cfg.enc_layers}) and n_layers ({cfg.n_layers}) "
                         ">= 1")
    pspec = encdec_pspec(cfg)

    def loss(params, batch):
        return encdec_loss(unstack_blocks(params, cfg), cfg, batch)

    def prefill_last(params, batch):
        return encdec_prefill(params, cfg, batch, last_only=True)

    def decode(params, cache, batch):
        return encdec_decode(params, cfg, cache, batch)

    def cache_pspec(batch: int, smax: int, per_slot_pos: bool = False, *,
                    kind: str = "ring", **_):
        if kind == "paged":
            raise ValueError(f"no paged cache for family {cfg.family!r}")
        if per_slot_pos:
            raise ValueError("the encoder-decoder has no continuous-batching "
                             "cache (no block step; the engine falls back "
                             "to the wave scheduler)")
        return encdec_cache_pspec(cfg, batch, smax)

    n = count_params(pspec)
    return Bundle(cfg=cfg, params_pspec=pspec, loss=loss,
                  prefill_last=prefill_last, decode=decode, n_params=n,
                  n_active_params=n, cache_pspec=cache_pspec)

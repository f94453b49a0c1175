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

Tensor parallelism (:func:`encdec_tp_loss`, ``Bundle.tp_loss``) splits the
encoder's and the decoder's layers as the decoder-only families' (the
reference's rules: ``heads``, ``kv_heads``, ``ff`` and ``vocab`` over
``model``): each rank attends its heads in the encoder's self-attention,
the decoder's self-attention and its cross-attention (``xattn``, whose K and
V the rank projects from the whole memory), runs its ``ff`` columns, and
holds the embedding and head's vocab rows where ``model`` divides the
vocab; each layer gathers its weights over the mesh's other dims inside
itself (``models.lm.split_layer``). A serving step under a mesh
(``training.make_serve_step(bundle, mesh_ctx=)``) runs the same split on
its rows of the batch (``frames`` and ``tokens``); its prefill computes each
rank's heads' ``cross_k`` and ``cross_v`` from the memory, and under the
rules' ``seq_shard`` the self and cross caches' rows go over the ``kv_seq``
rule's mesh dims, every KV head a rank (``models.lm._kv_layout``), which
the decode attends range by range and merges by log-sum-exp
(:func:`~repro_torch.models.layers.cross_decode`), never gathering a
cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import (
    PSpec,
    count_params,
    cross_entropy,
    embed_tokens,
    rmsnorm,
    unstack_blocks,
)
from repro_torch.models.lm import Bundle, _kv_layout, _logits, _remat, \
    param_takes, split_layer, tp_params
from repro_torch.parallel import tensor_parallel as tpar


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


def _layers(cfg: L.ModelConfig, layer, stack: str):
    """``layer`` of the stack ``stack`` (``enc`` or ``dec``): split over the
    active tensor-parallel context's ``model`` dim, each layer gathering its
    weights (``models.lm.split_layer``), and under ``cfg.remat_policy``
    when gradients are on."""
    tp = tpar.current()
    if tp is not None:
        layer = split_layer(layer, tp, param_takes(cfg, tp)[1][stack])
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

    layer = _layers(cfg, layer, "enc")
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

    layer = _layers(cfg, layer, "dec")
    caches = []
    for lp in params["dec"]:
        h, c = layer(h, lp)
        caches.append(c)
    if last_only:
        h = h[:, -1:]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    return _logits(params, cfg, h), caches if collect_cache else None


def encdec_loss(params, cfg: L.ModelConfig, batch) -> torch.Tensor:
    """Mean token cross-entropy of the decoder on ``batch`` {frames,
    tokens, labels}."""
    memory = encode(params, cfg, _frames(cfg, batch))
    logits, _ = decode_train(params, cfg, batch["tokens"], memory)
    return cross_entropy(logits, batch["labels"])


def encdec_tp_loss(shards, cfg: L.ModelConfig, batch) -> torch.Tensor:
    """:func:`encdec_loss` split over the model dim of the active
    :class:`~repro_torch.parallel.tensor_parallel.TensorParallel`:
    ``shards`` is the train state's stacked parameter tree as this rank's
    :class:`~repro_torch.parallel.tensor_parallel.Shard` leaves; each
    encoder and decoder layer gathers its own weights inside the layer and
    computes its share of the heads and ``ff`` columns, the loss its share
    of the vocab (``models.lm.param_takes``)."""
    tp = tpar.current()
    if tp is None:
        raise ValueError("encdec_tp_loss runs under an active "
                         "TensorParallel (tensor_parallel.active)")
    return encdec_loss(tp_params(shards, cfg, tp), cfg, batch)


def encdec_cache_pspec(cfg: L.ModelConfig, batch: int, smax: int,
                       cross_rows: int | None = None):
    """The decode cache, ``smax`` split evenly between the encoder's memory
    (the cross K/V) and the decoder's self cache, as in the reference; or,
    given ``cross_rows`` (a sharded prefill's layout), ``smax`` self rows
    and ``cross_rows`` cross rows."""
    s_enc = s_dec = smax // 2
    if cross_rows is not None:
        s_dec, s_enc = smax, cross_rows
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
    tp = tpar.current()
    if tp is not None and tp.inference:
        cache = _serving_layout(cache, cfg, tp)
    cache["pos"] = batch["tokens"].shape[1]
    return logits, cache


def _serving_layout(cache, cfg: L.ModelConfig, tp) -> dict:
    """A sharded prefill's self and cross caches (this rank's heads, every
    row) -> this rank's part in the serving layout
    (``models.lm._kv_layout``): the self cache padded to the step's
    ``tp.kv_rows``, and where the rows are split over ``seq_axes`` the
    rank's range of them; the cross cache alike at the memory's rows, which
    must divide as the self cache's do."""
    s_enc = cache["cross_k"].shape[2]
    if tp.seq_axes and s_enc % tp.seq_parts():
        raise ValueError(f"the cross cache's {s_enc} rows (the frames) do "
                         f"not divide over the {tp.seq_parts()} ranks that "
                         "split the self cache's rows")
    out = {}
    for names, rows in ((("self_k", "self_v"), tp.kv_rows),
                        (("cross_k", "cross_v"), s_enc)):
        both = _kv_layout(torch.stack([cache[n] for n in names]), cfg,
                          dataclasses.replace(tp, kv_rows=rows))
        out.update(zip(names, both.unbind(0)))
    return out


def encdec_decode(params, cfg: L.ModelConfig, cache, batch):
    """One decode step. batch {"tokens": (B, 1)} -> (logits, cache): the
    token's self-attention k, v written at row ``pos`` of the self cache in
    place, then cross-attention over every row of the memory's K/V."""
    h = embed_tokens(params["embed"], batch["tokens"])       # (B, 1, d)
    pos = cache["pos"]
    tp = tpar.current()
    # the self cache's global rows (a serving step may hold a range)
    rows = tp.kv_rows if tp is not None and tp.seq_axes \
        else cache["self_k"].shape[2]
    if pos >= rows:
        raise ValueError(f"self-attention cache of {rows} positions is full "
                         f"at position {pos}; grow it with pad_cache_seq")
    for i, lp in enumerate(params["dec"]):
        a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
        h = h + L.attn_decode(lp["attn"], cfg, a_in,
                              {"k": cache["self_k"][i],
                               "v": cache["self_v"][i]}, pos=pos)
        x_in = rmsnorm(h, lp["lnx"], cfg.norm_eps, cfg.policy)
        h = h + L.cross_decode(lp["xattn"], cfg, x_in, cache["cross_k"][i],
                               cache["cross_v"][i])
        m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
        h = h + L.mlp_apply(lp["mlp"], cfg, m_in)
    cache["pos"] = pos + 1
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    return _logits(params, cfg, h), cache


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
                    kind: str = "ring", cross_rows: int | None = None, **_):
        if kind == "paged":
            raise ValueError(f"no paged cache for family {cfg.family!r}")
        if per_slot_pos:
            raise ValueError("the encoder-decoder has no continuous-batching "
                             "cache (no block step; the engine falls back "
                             "to the wave scheduler)")
        return encdec_cache_pspec(cfg, batch, smax, cross_rows)

    def tp_loss(shards, batch):
        return encdec_tp_loss(shards, cfg, batch)

    n = count_params(pspec)
    return Bundle(cfg=cfg, params_pspec=pspec, loss=loss,
                  prefill_last=prefill_last, decode=decode, n_params=n,
                  n_active_params=n, cache_pspec=cache_pspec,
                  tp_loss=tp_loss)

"""Decoder-only LM assembly: the dense (llama), vlm (internvl2), moe
(qwen3-moe, grok-1), ssm (Mamba-2) and hybrid (Zamba2) families.

Counterpart of ``repro.models.lm``; the encoder-decoder is
:mod:`repro_torch.models.encdec`, and :func:`repro_torch.models.build`
picks between the two. The reference scans a
stacked layer axis with ``lax.scan``; here the layers are a list and the
loop is a Python loop. A moe layer is a dense layer with
:func:`~repro_torch.models.layers.moe_apply` in place of the MLP, and
:func:`lm_apply` sums its auxiliary load-balance loss over the layers. A
vlm is the dense family with a stub prefix: ``batch["stub"]`` (B,
stub_tokens, stub_dim), the frontend's patch embeddings, projected by
``stub_proj`` and put before the tokens (:func:`_embed_input`); its loss
covers the text tail, and its decode steps embed tokens only, as the
reference's do. The hybrid is the ssm family's Mamba layers in groups of
``shared_attn_every``, each group followed by one shared attention + MLP
block (one parameter tree, ``params["shared"]``) over ``concat(h, emb)``,
emb the input's embeddings (:func:`_shared_block`).

The decode cache keeps the reference's stacked layout, ``attn.k``/``attn.v``
``(kv layers, B, S, Hkv, Dh)`` (a layer a block, or the hybrid's a group)
and ``mamba.conv (n_layers, B, K-1, C)``/``mamba.state (n_layers, B, H, P,
N)``, and :func:`lm_decode` updates it in place (one layer's slice at a
time) instead of rebuilding it every token. The prefill cache holds exactly
the prompt's positions; a server grows its sequence axis with
:func:`pad_cache_seq` before decoding. With a sliding window the attention
layers attend the last ``swa_window`` keys in the prefill, and a prompt
longer than the window leaves a ring of ``swa_window`` rows, position p at
row ``p % swa_window``, which :func:`lm_decode` writes and attends as a
ring; it refuses a cache grown past the window, whose zero rows it would
attend.

The continuous scheduler's cache (:func:`lm_cache_pspec` with
``per_slot_pos=True``) is a ring of ``min(capacity, swa_window)`` rows a
slot with a position per slot, stepped by :func:`lm_decode_block`, or the
paged pool (``kind="paged"``) stepped by :func:`lm_decode_block_paged`.
As in the reference, the MoE layers route
every token of a block step, the ones past a slot's ``n_valid`` too, and
those take capacity like the rest.

Training: :func:`lm_loss` is the mean token cross-entropy of
:func:`lm_apply` plus ``MOE_AUX_WEIGHT`` times its auxiliary loss;
``Bundle.loss`` takes the train state's stacked parameters. With gradients
on, each layer of the forward runs under ``cfg.remat_policy``
(:func:`_remat`): its activations are recomputed in backward, the layer's
kernels launched again. The hybrid's shared block is not recomputed, as in
the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models.common import (
    PSpec,
    count_params,
    cross_entropy,
    embed_tokens,
    rmsnorm,
    stack_lens,
    unembed,
    unstack_blocks,
)
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.parallel.tensor_parallel import Take


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
ATTN_FAMILIES = ("dense", "vlm", "moe")   # an attention layer in every block
STATE_FAMILIES = ("ssm", "hybrid")        # Mamba layers: conv and state
KV_FAMILIES = ATTN_FAMILIES + ("hybrid",)   # a KV cache
# the families whose train and serve steps split over the mesh's model dim
# (:func:`lm_tp_loss`, ``encdec.encdec_tp_loss``): every family
TP_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
MOE_AUX_WEIGHT = 0.01
# the reference's dots_with_no_batch_dims_saveable: a matmul without batch
# dims is an mm (``x @ W`` folds its leading dims into rows) or an addmm
_SAVED_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` (one layer) under an activation-checkpoint policy: ``off``
    keeps every activation; ``none`` keeps the layer's inputs only and
    runs the layer again in backward; ``dots`` keeps the outputs of the
    matmuls without batch dims as well (selective checkpointing)."""
    if policy == "off":
        return fn
    if policy == "none":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(policy)


def serves_split(cfg: L.ModelConfig, mesh_ctx) -> bool:
    """Whether serving ``cfg`` on ``mesh_ctx`` takes the split steps: a mesh
    that splits a dim (``tensor_parallel.splits``). Every family of
    ``TP_FAMILIES`` is served so; another raises
    ``NotImplementedError``."""
    if not tpar.splits(mesh_ctx):
        return False
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"sharded serving of {cfg.name} ({cfg.family}) on mesh "
            f"{mesh_ctx.label()}: the family has no split steps "
            f"({', '.join(TP_FAMILIES)} do); serve it unsharded")
    return True


def _require_ported(cfg: L.ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not a decoder-only family of "
            f"the port ({', '.join(FAMILIES)}); the encoder-decoder "
            "('encdec') is built by repro_torch.models.build")
    every = cfg.shared_attn_every
    if cfg.family == "hybrid" and (every < 1 or cfg.n_layers % every):
        raise ValueError(f"a hybrid needs n_layers ({cfg.n_layers}) to be a "
                         f"multiple of shared_attn_every ({every})")


@dataclasses.dataclass(frozen=True)
class Bundle:
    """Everything the trainer and the server need for one architecture."""

    cfg: L.ModelConfig
    params_pspec: Any
    # (stacked params, {tokens, labels}) -> scalar mean cross-entropy
    loss: Callable
    prefill_last: Callable   # (params, batch) -> (last logits, cache)
    decode: Callable         # (params, cache, batch) -> (logits, cache)
    n_params: int = 0
    # parameters a token meets: every expert's share of the MoE blocks
    # replaced by k experts' (the reference's count, router included)
    n_active_params: int = 0
    # (batch, smax, per_slot_pos=False, kind="ring", pool_pages=0,
    # page_rows=0, state_pages=0) -> PSpec tree
    cache_pspec: Callable = None
    # continuous-batching slot step: (params, cache, {tokens (B, T)}, *,
    # n_valid (B,), reset_mask (B,)) -> (logits (B, vocab), cache), the
    # cache updated in place
    decode_block: Callable = None
    # its paged twin: the same and page= (the manager's plan of the tick)
    decode_block_paged: Callable = None
    # the tensor-parallel loss: (stacked tree of tensor_parallel.Shard,
    # batch) -> the loss under an active TensorParallel
    tp_loss: Callable = None


def lm_pspec(cfg: L.ModelConfig):
    _require_ported(cfg)
    d, v = cfg.d_model, cfg.vocab
    p: dict[str, Any] = {
        "embed": PSpec((v, d), "normal", logical=("vocab", "embed")),
        "final_norm": PSpec((d,), "ones", logical=("embed",)),
    }
    if not cfg.tie_embeddings:
        p["head"] = PSpec((v, d), "normal", logical=("vocab", "embed"))
    if cfg.stub_tokens:
        p["stub_proj"] = PSpec((cfg.stub_dim, d), logical=(None, "embed"))
    if cfg.family in ATTN_FAMILIES:
        ffn = "moe" if cfg.family == "moe" else "mlp"
        ffn_pspec = L.moe_pspec if cfg.family == "moe" else L.mlp_pspec
        p["blocks"] = [{"ln1": PSpec((d,), "ones", logical=("embed",)),
                        "attn": L.attn_pspec(cfg),
                        "ln2": PSpec((d,), "ones", logical=("embed",)),
                        ffn: ffn_pspec(cfg)}
                       for _ in range(cfg.n_layers)]
    if cfg.family in STATE_FAMILIES:
        p["blocks"] = [{"ln": PSpec((d,), "ones", logical=("embed",)),
                        "mamba": L.mamba_pspec(cfg)}
                       for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        # Zamba2's shared transformer block over concat(h, embeddings): one
        # tree, not stacked, used after every group
        p["shared"] = {"ln_in": PSpec((2 * d,), "ones", logical=("embed",)),
                       "attn": L.attn_pspec(cfg, d_in=2 * d),
                       "ln_mlp": PSpec((d,), "ones", logical=("embed",)),
                       "mlp": L.mlp_pspec(cfg)}
    return p


def _head(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _ffn(lp, cfg: L.ModelConfig, m_in):
    """The feed-forward half of an attention layer: (out, MoE aux or
    None)."""
    if "moe" in lp:
        return L.moe_apply(lp["moe"], cfg, m_in)
    return L.mlp_apply(lp["mlp"], cfg, m_in), None


def n_groups(cfg: L.ModelConfig) -> int:
    """The hybrid's groups of ``shared_attn_every`` Mamba layers, each
    followed by the shared block: its KV cache's layers (0 elsewhere)."""
    return (cfg.n_layers // cfg.shared_attn_every
            if cfg.family == "hybrid" else 0)


def _kv_layers(cfg: L.ModelConfig) -> int:
    return n_groups(cfg) if cfg.family == "hybrid" else cfg.n_layers


def _group_end(cfg: L.ModelConfig, i: int) -> int | None:
    """The group that Mamba layer ``i`` closes in the hybrid, whose shared
    block runs next; None elsewhere."""
    if cfg.family != "hybrid" or (i + 1) % cfg.shared_attn_every:
        return None
    return (i + 1) // cfg.shared_attn_every - 1


def _shared_block(sp, cfg: L.ModelConfig, h, emb0, attend):
    """Zamba2's shared attention + MLP block: attention over the norm of
    ``concat(h, emb0)`` (B, S, 2d), ``attend(p, x)`` being the path's
    attention, which returns (out, what the path keeps); then the SwiGLU MLP.
    Returns (h, what ``attend`` kept)."""
    a_in = rmsnorm(torch.cat([h, emb0], dim=-1), sp["ln_in"], cfg.norm_eps,
                   cfg.policy)
    a_out, kept = attend(sp["attn"], a_in)
    h = h + a_out
    m_in = rmsnorm(h, sp["ln_mlp"], cfg.norm_eps, cfg.policy)
    return h + L.mlp_apply(sp["mlp"], cfg, m_in), kept


def _block_takes(cfg: L.ModelConfig, tp) -> dict:
    """What a tensor-parallel rank takes of one layer (the norms whole)."""
    if cfg.family in STATE_FAMILIES:
        return {"mamba": L.mamba_takes(cfg, tp)}
    if cfg.family == "moe":
        return {"attn": L.attn_takes(cfg, tp), "moe": L.moe_takes(cfg, tp)}
    return {"attn": L.attn_takes(cfg, tp), "mlp": L.mlp_takes(cfg, tp)}


def param_takes(cfg: L.ModelConfig, tp) -> tuple[dict, dict]:
    """(what a tensor-parallel rank takes of the parameters outside the
    layer stacks, of one layer of each stack by its name): the embedding
    and head as this rank's vocab rows where ``tp`` splits the vocab (else
    whole, the logits replicated, as the reference's spec leaves them), the
    hybrid's shared block as its heads and ``ff`` columns; each block by
    :func:`_block_takes`, or the encoder-decoder's encoder layers' and
    decoder layers' attention (self and cross) by their heads and MLPs by
    their ``ff`` columns."""
    vocab = Take(0, (tp.span(cfg.vocab),)) if tp.vocab_split else None
    top = {"embed": vocab, "head": vocab}
    if cfg.family == "hybrid":
        top["shared"] = {"attn": L.attn_takes(cfg, tp),
                         "mlp": L.mlp_takes(cfg, tp)}
    if cfg.family == "encdec":
        attn, mlp = L.attn_takes(cfg, tp), L.mlp_takes(cfg, tp)
        return top, {"enc": {"attn": attn, "mlp": mlp},
                     "dec": {"attn": attn, "xattn": attn, "mlp": mlp}}
    return top, {"blocks": _block_takes(cfg, tp)}


def tp_params(shards, cfg: L.ModelConfig, tp):
    """The stacked tree of :class:`~repro_torch.parallel.tensor_parallel.
    Shard` -> the forward's: each layer stack a list of per-layer trees of
    shards, which each layer gathers itself (:func:`lm_apply`, the
    encoder-decoder's ``encode`` and ``decode_train``), the rest gathered
    here (:func:`param_takes`)."""
    top, stacks = param_takes(cfg, tp)
    out = {k: tp.views(v, top.get(k)) for k, v in shards.items()
           if k not in stacks}
    lens = stack_lens(cfg)
    for key, takes in stacks.items():
        out[key] = tp.layers(shards[key], takes, lens[key])
    return out


def split_layer(layer, tp, takes, rows=None):
    """``layer`` under tensor parallelism ``tp``: it gathers its weights
    (each a :class:`~repro_torch.parallel.tensor_parallel.Shard`, ``takes``
    its part) and runs with ``tp`` active, in the forward and again where
    the remat policy recomputes it (in the backward, on autograd's device
    thread, which the step's context does not reach). With ``tp`` None and
    a batch layout ``rows`` (the gather-whole step's), the layer runs with
    that layout active, likewise."""
    if tp is None:
        if rows is None:
            return layer

        def laid_out(h, lp):
            with tpar.rows_active(rows):
                return layer(h, lp)
        return laid_out

    def split(h, lp):
        with tpar.active(tp):
            return layer(h, tp.views(lp, takes))
    return split


def _embed_input(params, cfg: L.ModelConfig, batch):
    """tokens, after the projected stub prefix where the model takes one
    (vlm): (B, P + S, d)."""
    if cfg.stub_tokens and "stub" not in batch:
        raise ValueError(
            f"{cfg.name} takes a stub prefix: batch['stub'] of shape (B, "
            f"{cfg.stub_tokens}, {cfg.stub_dim}), the frontend's patch "
            "embeddings; none was given")
    h = embed_tokens(params["embed"], batch["tokens"])
    if cfg.stub_tokens:
        prefix = batch["stub"].to(h.dtype) @ params["stub_proj"]
        h = torch.cat([prefix, h], dim=1)
    return h


def lm_apply(params, cfg: L.ModelConfig, batch, *, collect_cache=False,
             last_only=False):
    """Full-sequence forward. Returns (logits, aux, cache-or-None).

    ``last_only`` unembeds just the final position (serving prefill), which
    avoids the (B, S, vocab) logits tensor. ``aux`` is the MoE auxiliary
    loss summed over the layers, an f32 scalar (zero without MoE layers).
    A vlm's ``batch`` carries ``stub`` (B, stub_tokens, stub_dim), whose
    projection comes before the tokens; the logits cover both."""
    _require_ported(cfg)
    h = _embed_input(params, cfg, batch)
    b, s, _ = h.shape
    emb0 = h
    tp = tpar.current()
    # positions from 0 in every row, left padding included, as in the
    # reference
    positions = torch.arange(s, device=h.device).expand(b, s)

    def attend(p, x):
        return L.attn_apply(p, cfg, x, positions=positions)

    if cfg.family in ATTN_FAMILIES:
        def layer(h, lp):
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            # the sliding window in the attention layers, not in the
            # hybrid's shared block, as in the reference
            a_out, kv = L.attn_apply(lp["attn"], cfg, a_in,
                                     positions=positions,
                                     window=cfg.swa_window)
            h = h + a_out
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            m_out, aux = _ffn(lp, cfg, m_in)
            return h + m_out, aux, kv if collect_cache else None
    elif cfg.family in STATE_FAMILIES:
        def layer(h, lp):
            m_in = rmsnorm(h, lp["ln"], cfg.norm_eps, cfg.policy)
            out, cache = L.mamba_apply(lp["mamba"], cfg, m_in,
                                       collect_cache=collect_cache)
            return h + out, None, cache
    layer = split_layer(layer, tp, None if tp is None
                        else _block_takes(cfg, tp), tpar.batch_layout())
    if torch.is_grad_enabled():
        # the layers only: the hybrid's shared block is not recomputed, as
        # in the reference
        layer = _remat(layer, cfg.remat_policy)
    caches, kvs = [], []
    aux_total = torch.zeros((), device=h.device)
    for i, lp in enumerate(params["blocks"]):
        h, aux, cache = layer(h, lp)
        if aux is not None:
            aux_total = aux_total + aux
        caches.append(cache)
        if _group_end(cfg, i) is not None:
            h, kv = _shared_block(params["shared"], cfg, h, emb0, attend)
            kvs.append(kv)
    if last_only:
        h = h[:, -1:]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    logits = _logits(params, cfg, h)
    cache = None
    if collect_cache:
        cache = {"pos": s}
        if cfg.family in ATTN_FAMILIES:
            kvs = caches
        if cfg.family in STATE_FAMILIES:
            cache["mamba"] = {
                "conv": torch.stack([c["conv"] for c in caches]),
                "state": torch.stack([c["state"] for c in caches])}
        if cfg.family in KV_FAMILIES:
            k, v = (_ring_order(cfg, torch.stack([kv[j] for kv in kvs]), s)
                    for j in range(2))
            if tp is not None and tp.inference:
                k, v = _kv_layout(torch.stack([k, v]), cfg, tp)
            cache["attn"] = {"k": k, "v": v}
    return logits, aux_total, cache


def _ring_order(cfg: L.ModelConfig, t: torch.Tensor, s: int) -> torch.Tensor:
    """A prefill's stacked K or V ``(layers, B, s, Hkv, Dh)`` as the decode
    cache holds it: as it is, or past a sliding window the ring of its last
    ``window`` rows, position p at row ``p % window`` (the reference's
    ``_build_cache_from_kv``)."""
    w = cfg.swa_window
    if not w or w >= s:
        return t
    return torch.roll(t[:, :, -w:], s % w, dims=2)


def _kv_layout(t: torch.Tensor, cfg: L.ModelConfig, tp) -> torch.Tensor:
    """A sharded prefill's K and V ``(2, layers, B, S, H, Dh)``, H the KV
    heads this rank computed, over every row -> this rank's part of the
    cache in the serving layout (:func:`local_cache_pspec`): the rows
    padded with zeros to the cache's ``tp.kv_rows``; where the serving
    context splits them (``seq_axes``), the rank's range of them, and where
    that split takes ``model``, the range's rows of every KV head, by one
    all-to-all over ``model`` (each rank sends each other one its heads of
    that one's rows). A token's row never moves after this: the prefill
    writes the capacity the decode steps fill."""
    rows = tp.kv_rows
    if t.shape[3] > rows:
        raise ValueError(f"a prefill of {t.shape[3]} cache rows into a "
                         f"cache of {rows}")
    t = F.pad(t, (0, 0, 0, 0, 0, rows - t.shape[3]))
    if not tp.seq_axes:
        return t
    idx, parts = tp.index_in(tp.seq_axes)
    local = rows // parts
    if tpar.MODEL_AXIS not in tp.seq_axes or tp.size == 1:
        return t.narrow(3, idx * local, local).contiguous()
    m = tp.size
    # the rows of the rank's block over the other mesh dims, one range a
    # model rank; the ranks of those dims computed the same rows
    t = t.narrow(3, idx // m * m * local, m * local)
    got = tp.exchange(t.unflatten(3, (m, local)).movedim(3, 0))
    got = got.movedim(0, 4).flatten(4, 5)          # (2, L, B, local, m*H, Dh)
    if got.shape[4] != cfg.n_kv_heads:             # ranks shared a KV head
        got = got[:, :, :, :, ::m // cfg.n_kv_heads]
    return got.contiguous()


def _logits(params, cfg: L.ModelConfig, h) -> torch.Tensor:
    """The head over ``h``; under a serving ``TensorParallel`` that splits
    the vocab, every rank's columns gathered over ``model`` (the whole
    vocab, for sampling)."""
    logits = unembed(h, _head(params, cfg))
    tp = tpar.current()
    if tp is not None and tp.inference and tp.vocab_split:
        logits = tp.all_model(logits, -1)
    return logits


def lm_loss(params, cfg: L.ModelConfig, batch) -> torch.Tensor:
    """Mean token cross-entropy of :func:`lm_apply` on ``batch`` {tokens,
    labels (B, S)} plus ``MOE_AUX_WEIGHT`` times its MoE auxiliary loss; a
    vlm's over the text tail only (the logits after the stub prefix)."""
    logits, aux, _ = lm_apply(params, cfg, batch)
    labels = batch["labels"]
    if cfg.stub_tokens:
        logits = logits[:, -labels.shape[1]:]
    return cross_entropy(logits, labels) + MOE_AUX_WEIGHT * aux


def lm_tp_loss(shards, cfg: L.ModelConfig, batch) -> torch.Tensor:
    """:func:`lm_loss` split over the model dim of the active
    :class:`~repro_torch.parallel.tensor_parallel.TensorParallel`:
    ``shards`` is the train state's stacked parameter tree as this rank's
    :class:`~repro_torch.parallel.tensor_parallel.Shard` leaves; each
    layer gathers its own weights over the mesh's other dims inside the
    layer (so ``cfg.remat_policy`` gathers them again in backward rather
    than keep every layer's), and computes its share of the heads, ``ff``
    columns, SSM heads and vocab."""
    tp = tpar.current()
    if tp is None:
        raise ValueError("lm_tp_loss runs under an active TensorParallel "
                         "(tensor_parallel.active)")
    return lm_loss(tp_params(shards, cfg, tp), cfg, batch)


def pad_cache_seq(cache, extra: int):
    """Grow the sequence axis of the KV cache, and of an encoder-decoder's
    self-attention cache, by ``extra`` zero rows (the reference's
    ``serving.engine._pad_cache_seq``); a cache without one (ssm) is
    returned as it is. A sliding window's ring must not grow: its decode
    would attend the zero rows."""
    if extra <= 0:
        return cache
    if "attn" in cache:
        cache["attn"] = {n: F.pad(t, (0, 0, 0, 0, 0, extra))
                         for n, t in cache["attn"].items()}
    for n in ("self_k", "self_v"):
        if n in cache:
            cache[n] = F.pad(cache[n], (0, 0, 0, 0, 0, extra))
    return cache


def _step_layers(params, cfg: L.ModelConfig, cache, h, attend, mix,
                 mamba_in):
    """The layers of a decode step over ``h`` (the tokens' embeddings).

    Attention families: every layer attends through ``attend(p, x, i)``
    (KV layer ``i``), then its FFN. State families: every Mamba layer runs
    ``mix(p, x, {conv, state})`` from ``mamba_in(i)``, its layer's state at
    the step's start, and its new conv history and state are written into
    the cache in place; the hybrid runs the shared block after each group,
    attending through the group's KV layer, over ``concat(h, emb)``."""
    emb0 = h
    for i, lp in enumerate(params["blocks"]):
        if cfg.family in ATTN_FAMILIES:
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            h = h + attend(lp["attn"], a_in, i)
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            h = h + _ffn(lp, cfg, m_in)[0]
        elif cfg.family in STATE_FAMILIES:
            m_in = rmsnorm(h, lp["ln"], cfg.norm_eps, cfg.policy)
            out, c = mix(lp["mamba"], m_in, mamba_in(i))
            cache["mamba"]["conv"][i].copy_(c["conv"])
            cache["mamba"]["state"][i].copy_(c["state"])
            h = h + out
        g = _group_end(cfg, i)
        if g is not None:
            h = _shared_block(params["shared"], cfg, h, emb0,
                              lambda p, x, g=g: (attend(p, x, g), None))[0]
    return h


def lm_decode(params, cfg: L.ModelConfig, cache, batch):
    """One decode step. batch {"tokens": (B, 1)} -> (logits, cache); the
    cache's tensors are updated in place (the new token's k, v at row
    ``pos``; conv history and state). The tokens alone are embedded: a
    vlm's stub went in with the prefill."""
    _require_ported(cfg)
    h = embed_tokens(params["embed"], batch["tokens"])       # (B, 1, d)
    pos = cache["pos"]
    kv = cache.get("attn")
    # the attention layers' window makes their cache a ring; the hybrid's
    # shared block takes none, as in the reference
    window = cfg.swa_window if cfg.family in ATTN_FAMILIES else None
    tp = tpar.current()
    if kv is not None:
        # the cache's global rows (a serving step may hold a range of them)
        rows = tp.kv_rows if tp is not None and tp.seq_axes \
            else kv["k"].shape[2]
        if window is not None and rows > window:
            raise ValueError(
                f"a KV cache of {rows} rows under a sliding window of "
                f"{window}: a ring grown past the window would attend rows "
                "outside it; grow a prefill's cache only up to the window")
        if rows != window and pos >= rows:
            raise ValueError(f"KV cache of {rows} positions is full at "
                             f"position {pos}; grow it with pad_cache_seq")

    def attend(p, x, i):
        return L.attn_decode(p, cfg, x, {"k": kv["k"][i], "v": kv["v"][i]},
                             pos=pos, window=window)

    def mix(p, x, c):
        return L.mamba_decode(p, cfg, x, c)

    def mamba_in(i):
        return {"conv": cache["mamba"]["conv"][i],
                "state": cache["mamba"]["state"][i]}

    h = _step_layers(params, cfg, cache, h, attend, mix, mamba_in)
    cache["pos"] = pos + 1
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    return _logits(params, cfg, h), cache


def lm_cache_pspec(cfg: L.ModelConfig, batch: int, smax: int,
                   per_slot_pos: bool = False, *, kind: str = "ring",
                   pool_pages: int = 0, page_rows: int = 0,
                   state_pages: int = 0):
    """Decode-cache declaration. ``per_slot_pos=True`` declares the
    continuous-batching layout: ``pos`` is a (batch,) vector, one position
    per slot. Attention layers (dense, vlm, moe; the hybrid's shared block,
    one KV layer a group): a KV ring of ``min(smax, swa_window)`` rows a
    slot; Mamba layers (ssm, hybrid): conv history and state.

    ``kind="paged"`` swaps the per-slot KV rings for one pool of
    ``pool_pages`` pages of ``page_rows`` rows shared by every slot (block
    tables map slots to pages, ``serving/kvpool.py``); the Mamba layers keep
    their live per-slot conv and state and add a pool of ``state_pages``
    snapshots for prompt-boundary prefix sharing."""
    if kind == "paged" and not per_slot_pos:
        raise ValueError("the paged cache is continuous-batching only "
                         "(per_slot_pos=True)")
    if kind not in ("ring", "paged"):
        raise ValueError(f"cache kind must be 'ring' or 'paged', got {kind!r}")
    _require_ported(cfg)
    cache: dict[str, Any] = {
        "pos": PSpec((batch,) if per_slot_pos else (), "zeros", torch.int32,
                     logical=("batch",) if per_slot_pos else ())}
    if cfg.family in STATE_FAMILIES:
        cache["mamba"] = L.mamba_cache_pspec(cfg, cfg.n_layers, batch)
        if kind == "paged":
            cache["snap"] = L.mamba_snap_pspec(cfg, cfg.n_layers, state_pages)
    if cfg.family in KV_FAMILIES:
        if kind == "paged":
            cache["attn"] = L.attn_page_cache_pspec(cfg, _kv_layers(cfg),
                                                    pool_pages, page_rows)
        else:
            cache["attn"] = L.attn_cache_pspec(cfg, _kv_layers(cfg), batch,
                                               smax)
            del cache["attn"]["pos"]
    return cache


def local_cache_pspec(cfg: L.ModelConfig, pspec, tp):
    """The cache declaration ``pspec`` (global shapes) cut to this rank's
    part under the serving context ``tp``: the slots split over the batch's
    mesh dims (``tp.batch_axes``) and the ring's rows over ``tp.seq_axes``,
    as the rules' specs split them; the KV heads those the rank computes
    (:func:`~repro_torch.models.layers.attn_takes`: ``n_kv_heads / model``,
    or the one of its GQA group where they do not divide ``model``, a
    layout the specs do not express), but every KV head where the rows are
    split over ``model``; the SSM heads and conv channels those of
    :func:`~repro_torch.models.layers.mamba_takes` (its heads' x channels
    and the B and C groups they read, another layout the specs do not
    express). The paged pools' pages are whole on every rank. An
    encoder-decoder's self and cross caches are cut alike."""
    cut = {"batch": lambda n: n // tp.row_parts(),
           "kv_seq": lambda n: n // tp.seq_parts()}
    if cfg.family in KV_FAMILIES or cfg.family == "encdec":
        heads = (cfg.n_kv_heads if tpar.MODEL_AXIS in tp.seq_axes else
                 _width(L.attn_takes(cfg, tp)["wk"]) // cfg.dh)
        cut["kv_heads"] = lambda n: heads
    if cfg.family in STATE_FAMILIES:
        took = L.mamba_takes(cfg, tp)
        cut["ssm_heads"] = lambda n: _width(took["dt_bias"])
        cut["inner_all"] = lambda n: _width(took["conv_b"])

    def local(ps):
        shape = tuple(cut[name](n) if name in cut else n
                      for n, name in zip(ps.shape, ps.logical))
        return dataclasses.replace(ps, shape=shape)

    return tree.map_tree(local, pspec)


def kv_leaf(cache):
    """The KV cache's K in a cache or a cache declaration (an
    encoder-decoder's: its decoder's self cache), None without one."""
    if "attn" in cache:
        return cache["attn"]["k"]
    return cache.get("self_k")


def _width(take: Take) -> int:
    return sum(b - a for a, b in take.ranges)


def _last_logits(params, cfg: L.ModelConfig, h, n_valid):
    """Logits (B, vocab) after each slot's last valid token (an idle slot's
    row is junk the caller ignores)."""
    last = torch.clamp(n_valid - 1, min=0)
    h_last = h.gather(1, last[:, None, None].expand(h.shape[0], 1,
                                                    h.shape[-1]))
    h_last = rmsnorm(h_last, params["final_norm"], cfg.norm_eps, cfg.policy)
    return _logits(params, cfg, h_last)[:, 0]


def lm_decode_block(params, cfg: L.ModelConfig, cache, batch, *,
                    n_valid, reset_mask):
    """Slot-masked T-token step: the continuous-batching workhorse.

    batch {"tokens": (B, T)}; slot b consumes its first ``n_valid[b]`` in
    [0, T] tokens (0: the slot is untouched); ``reset_mask`` (B,) clears a
    slot's sequence state first (pos -> 0, conv and state -> 0), as on
    admission of a new request; stale KV rows need no clearing, the
    per-slot lengths hide them. One call serves chunked prefill and
    single-token decode across slots. The tokens alone are embedded, as in
    the reference (a vlm is served text-only here).

    The cache's tensors are updated in place, and nothing here reads a
    device value on the host, so the step can be captured in a CUDA graph
    and replayed. Returns (logits (B, vocab) after each slot's last valid
    token, cache); an idle slot's row is junk the caller ignores."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    dev = tokens.device
    n_valid = torch.as_tensor(n_valid, device=dev).long()
    reset = torch.as_tensor(reset_mask, device=dev).bool()
    pos = torch.where(reset, 0, cache["pos"])
    h = embed_tokens(params["embed"], tokens)                # (B, T, d)
    kv = cache.get("attn")

    def attend(p, x, i):
        return L.attn_decode_block(
            p, cfg, x, {"k": kv["k"][i], "v": kv["v"][i], "pos": pos},
            n_valid=n_valid)

    def mix(p, x, c):
        return L.mamba_decode_block(p, cfg, x, c, n_valid=n_valid)

    def mamba_in(i):
        m = cache["mamba"]
        return {"conv": torch.where(reset[:, None, None], 0, m["conv"][i]),
                "state": torch.where(reset[:, None, None, None], 0,
                                     m["state"][i])}

    h = _step_layers(params, cfg, cache, h, attend, mix, mamba_in)
    cache["pos"].copy_(pos + n_valid)
    return _last_logits(params, cfg, h, n_valid), cache


def _snap_plan(reset: torch.Tensor, load: torch.Tensor,
               save: torch.Tensor, tp=None) -> dict:
    """The tick's snapshot plan as fixed-shape indices, made once for every
    layer. Loads: ``use`` marks the reset slots that start from snapshot
    ``page`` instead of zeros. Saves: each slot's pre-tick state goes to a
    page as a (``src`` slot, ``dst`` page) pair: a slot with ``save >= 0``
    its own state into page ``save``; every other slot repeats the first
    saver's pair, or, when no slot saves, page 0 takes its own content back
    (``keep``). Writes to one page then carry one value.

    Sharded serving (``tp``): ``reset`` and ``load`` are this rank's slots,
    ``save`` every slot's (the snapshot pool is replicated over the
    batch's mesh dims, so every rank writes every save): the saved states
    are gathered over those dims (``gather``), and on a tick that saves
    nothing the pool is left alone (``skip``, read on the host: the sharded
    step runs eagerly)."""
    b = save.shape[0]
    saves = save >= 0
    first = saves.to(torch.uint8).argmax().view(1)
    keep = ~saves.any()
    gather = tp is not None and tp.rows_split()
    return {
        "gather": tp if gather else None,
        "skip": gather and bool(keep),
        "reset": reset, "use": reset & (load >= 0),
        "page": load.clamp(min=0), "keep": keep,
        "src": torch.where(saves, torch.arange(b, device=save.device),
                           first),
        "dst": torch.where(saves, save,
                           torch.where(keep, 0, save.index_select(0, first)))}


def _snap_io(live, snap, plan, dim=0):
    """A live tensor at tick start, and the snapshots taken of it.

    ``live`` and ``snap`` hold slots and snapshot pages on axis ``dim``. A
    reset slot starts from zeros, or from its snapshot where the ``plan``
    (:func:`_snap_plan`) loads one; the tick's initial value of each slot
    the plan saves is written into its snapshot page, in place by index.
    Save destinations are freshly allocated pages, never a page loaded this
    tick, so the loads read before any save lands."""
    shape = [1] * live.dim()
    shape[dim] = -1
    loaded = snap.index_select(dim, plan["page"]).to(live.dtype)
    init = torch.where(plan["reset"].view(shape),
                       torch.where(plan["use"].view(shape), loaded, 0), live)
    if plan["skip"]:
        return init
    every = init if plan["gather"] is None \
        else plan["gather"].gather_rows(init, dim)
    dst = plan["dst"]
    snap.index_copy_(dim, dst, torch.where(
        plan["keep"], snap.index_select(dim, dst),
        every.index_select(dim, plan["src"]).to(snap.dtype)))
    return init


def lm_decode_block_paged(params, cfg: L.ModelConfig, cache, batch, *,
                          n_valid, reset_mask, page):
    """Paged-pool twin of :func:`lm_decode_block`.

    ``page`` carries the host manager's plan of the tick
    (``serving/kvpool.py``): ``reset_pos`` (B,), the start position of each
    reset slot (> 0 when a shared prefix is skipped). A KV pool (dense, vlm,
    moe, hybrid) adds ``tables`` (B, MP), the block tables, and ``kv_src``,
    ``kv_dst``: the copy-on-write page copies
    (:func:`repro_torch.serving.kvpool.cow_pairs`), applied to every KV
    layer's pool in place before the layers. Where the reference gathers
    the whole pool through its ``kv_copy`` (identity but where a fresh page
    reads its source), the pairs copy only those pages; the result is the
    same. Mamba layers (ssm, hybrid) add ``snap_save`` and ``snap_load``
    (B,): snapshot pages to save the slot's pre-tick state into, and to
    load a reset slot's state from (-1: none), planned once for every
    layer before the layers. The cache is updated in place; returns (logits
    (B, vocab) after each slot's last valid token, cache).

    Sharded serving (a serving ``TensorParallel``): ``tokens``, ``n_valid``,
    ``reset_mask``, ``reset_pos`` and ``snap_load`` are this rank's slots;
    ``tables``, the copy pairs and ``snap_save`` every slot's, since the KV
    and snapshot pools are replicated over the batch's mesh dims."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    dev = tokens.device
    n_valid = torch.as_tensor(n_valid, device=dev).long()
    reset = torch.as_tensor(reset_mask, device=dev).bool()
    pos = torch.where(reset, torch.as_tensor(page["reset_pos"], device=dev),
                      cache["pos"])
    h = embed_tokens(params["embed"], tokens)                # (B, T, d)
    kv, tables, conv0, plan = cache.get("attn"), None, None, None
    if kv is not None:
        src = torch.as_tensor(page["kv_src"], device=dev).long().reshape(-1)
        dst = torch.as_tensor(page["kv_dst"], device=dev).long().reshape(-1)
        for c in kv.values():
            c.index_copy_(1, dst, c.index_select(1, src))
        tables = torch.as_tensor(page["tables"], device=dev).long()
    if cfg.family in STATE_FAMILIES:
        plan = _snap_plan(
            reset, torch.as_tensor(page["snap_load"], device=dev).long(),
            torch.as_tensor(page["snap_save"], device=dev).long(),
            tpar.current())
        # the conv histories are small: every layer's at once; the states
        # layer by layer, where one layer's stays in L2
        conv0 = _snap_io(cache["mamba"]["conv"], cache["snap"]["conv"], plan,
                         dim=1)

    def attend(p, x, i):
        return L.attn_decode_paged(
            p, cfg, x, {"k": kv["k"][i], "v": kv["v"][i], "pos": pos},
            n_valid=n_valid, tables=tables)

    def mix(p, x, c):
        return L.mamba_decode_block(p, cfg, x, c, n_valid=n_valid)

    def mamba_in(i):
        return {"conv": conv0[i],
                "state": _snap_io(cache["mamba"]["state"][i],
                                  cache["snap"]["state"][i], plan)}

    h = _step_layers(params, cfg, cache, h, attend, mix, mamba_in)
    cache["pos"].copy_(pos + n_valid)
    return _last_logits(params, cfg, h, n_valid), cache


def build_lm(cfg: L.ModelConfig) -> Bundle:
    pspec = lm_pspec(cfg)

    def loss(params, batch):
        return lm_loss(unstack_blocks(params, cfg), cfg, batch)

    def prefill_last(params, batch):
        logits, _, cache = lm_apply(params, cfg, batch, collect_cache=True,
                                    last_only=True)
        return logits, cache

    def decode(params, cache, batch):
        return lm_decode(params, cfg, cache, batch)

    def decode_block(params, cache, batch, *, n_valid, reset_mask):
        return lm_decode_block(params, cfg, cache, batch, n_valid=n_valid,
                               reset_mask=reset_mask)

    def decode_block_paged(params, cache, batch, *, n_valid, reset_mask,
                           page):
        return lm_decode_block_paged(params, cfg, cache, batch,
                                     n_valid=n_valid, reset_mask=reset_mask,
                                     page=page)

    def cache_pspec(batch: int, smax: int, per_slot_pos: bool = False,
                    **kind_kwargs):
        return lm_cache_pspec(cfg, batch, smax, per_slot_pos=per_slot_pos,
                              **kind_kwargs)

    n = count_params(pspec)
    n_active = n
    if cfg.family == "moe":
        moe = [blk["moe"] for blk in pspec["blocks"]]
        moe_total = count_params(moe)
        n_active = (n - moe_total + moe_total // cfg.n_experts
                    * cfg.experts_per_tok
                    + count_params([m["router"] for m in moe]))

    def tp_loss(shards, batch):
        return lm_tp_loss(shards, cfg, batch)

    return Bundle(cfg=cfg, params_pspec=pspec, loss=loss,
                  prefill_last=prefill_last,
                  decode=decode, n_params=n, n_active_params=n_active,
                  cache_pspec=cache_pspec, decode_block=decode_block,
                  decode_block_paged=decode_block_paged, tp_loss=tp_loss)

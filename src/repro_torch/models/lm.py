"""Decoder-only LM assembly: the dense (llama), moe (qwen3-moe, grok-1) and
ssm (Mamba-2) families.

Counterpart of ``repro.models.lm`` for the families ported so far. The
reference scans a stacked layer axis with ``lax.scan``; here the layers are
a list and the loop is a Python loop. A moe layer is a dense layer with
:func:`~repro_torch.models.layers.moe_apply` in place of the MLP, and
:func:`lm_apply` sums its auxiliary load-balance loss over the layers. The
decode cache keeps the reference's stacked layout, ``attn.k``/``attn.v``
``(n_layers, B, S, Hkv, Dh)`` for dense and moe and ``mamba.conv (n_layers,
B, K-1, C)``/``mamba.state (n_layers, B, H, P, N)`` for ssm, and
:func:`lm_decode` updates it in place (one layer's slice at a time) instead
of rebuilding it every token. The prefill cache holds exactly the prompt's
positions; a server grows its sequence axis with :func:`pad_cache_seq`
before decoding.

The continuous scheduler's cache (:func:`lm_cache_pspec` with
``per_slot_pos=True``) is a ring of ``min(capacity, swa_window)`` rows a
slot with a position per slot, stepped by :func:`lm_decode_block`, or the
paged pool (``kind="paged"``) stepped by :func:`lm_decode_block_paged`.
Those steps take the sliding window; the wave path (:func:`lm_apply`,
:func:`lm_decode`) does not yet. As in the reference, the MoE layers route
every token of a block step, the ones past a slot's ``n_valid`` too, and
those take capacity like the rest.

Training: :func:`lm_loss` is the mean token cross-entropy of
:func:`lm_apply` plus ``MOE_AUX_WEIGHT`` times its auxiliary loss;
``Bundle.loss`` takes the train state's stacked parameters. With gradients
on, each layer of the forward runs under ``cfg.remat_policy``
(:func:`_remat`): its activations are recomputed in backward, the layer's
kernels launched again.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

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


FAMILIES = ("dense", "moe", "ssm")
ATTN_FAMILIES = ("dense", "moe")     # attention layers and a KV cache
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


def lm_pspec(cfg: L.ModelConfig):
    _require_ported(cfg)
    d, v = cfg.d_model, cfg.vocab
    p: dict[str, Any] = {
        "embed": PSpec((v, d), "normal"),
        "final_norm": PSpec((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        p["head"] = PSpec((v, d), "normal")
    if cfg.family in ATTN_FAMILIES:
        ffn = "moe" if cfg.family == "moe" else "mlp"
        ffn_pspec = L.moe_pspec if cfg.family == "moe" else L.mlp_pspec
        p["blocks"] = [{"ln1": PSpec((d,), "ones"), "attn": L.attn_pspec(cfg),
                        "ln2": PSpec((d,), "ones"), ffn: ffn_pspec(cfg)}
                       for _ in range(cfg.n_layers)]
    else:
        p["blocks"] = [{"ln": PSpec((d,), "ones"),
                        "mamba": L.mamba_pspec(cfg)}
                       for _ in range(cfg.n_layers)]
    return p


def _head(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _ffn(lp, cfg: L.ModelConfig, m_in):
    """The feed-forward half of an attention layer: (out, MoE aux or
    None)."""
    if "moe" in lp:
        return L.moe_apply(lp["moe"], cfg, m_in)
    return L.mlp_apply(lp["mlp"], cfg, m_in), None


def lm_apply(params, cfg: L.ModelConfig, batch, *, collect_cache=False,
             last_only=False):
    """Full-sequence forward. Returns (logits, aux, cache-or-None).

    ``last_only`` unembeds just the final position (serving prefill), which
    avoids the (B, S, vocab) logits tensor. ``aux`` is the MoE auxiliary
    loss summed over the layers, an f32 scalar (zero without MoE layers)."""
    _require_ported(cfg)
    _require_unwindowed(cfg)
    h = embed_tokens(params["embed"], batch["tokens"])
    b, s, _ = h.shape
    if cfg.family in ATTN_FAMILIES:
        # positions from 0 in every row, left padding included, as in the
        # reference
        positions = torch.arange(s, device=h.device).expand(b, s)

        def layer(h, lp):
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            a_out, kv = L.attn_apply(lp["attn"], cfg, a_in,
                                     positions=positions)
            h = h + a_out
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            m_out, aux = _ffn(lp, cfg, m_in)
            return h + m_out, aux, kv if collect_cache else None
    else:
        def layer(h, lp):
            m_in = rmsnorm(h, lp["ln"], cfg.norm_eps, cfg.policy)
            out, cache = L.mamba_apply(lp["mamba"], cfg, m_in,
                                       collect_cache=collect_cache)
            return h + out, None, cache
    if torch.is_grad_enabled():
        layer = _remat(layer, cfg.remat_policy)
    caches = []
    aux_total = torch.zeros((), device=h.device)
    for lp in params["blocks"]:
        h, aux, cache = layer(h, lp)
        if aux is not None:
            aux_total = aux_total + aux
        caches.append(cache)
    if last_only:
        h = h[:, -1:]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps, cfg.policy)
    logits = unembed(h, _head(params, cfg))
    cache = None
    if collect_cache:
        cache = {"pos": s}
        if cfg.family in ATTN_FAMILIES:
            cache["attn"] = {"k": torch.stack([k for k, _ in caches]),
                             "v": torch.stack([v for _, v in caches])}
        else:
            cache["mamba"] = {
                "conv": torch.stack([c["conv"] for c in caches]),
                "state": torch.stack([c["state"] for c in caches])}
    return logits, aux_total, cache


def lm_loss(params, cfg: L.ModelConfig, batch) -> torch.Tensor:
    """Mean token cross-entropy of :func:`lm_apply` on ``batch`` {tokens,
    labels (B, S)} plus ``MOE_AUX_WEIGHT`` times its MoE auxiliary loss."""
    logits, aux, _ = lm_apply(params, cfg, batch)
    return cross_entropy(logits, batch["labels"]) + MOE_AUX_WEIGHT * aux


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
    if cfg.family in ATTN_FAMILIES:
        k, v = cache["attn"]["k"], cache["attn"]["v"]
        if pos >= k.shape[2]:
            raise ValueError(f"KV cache of {k.shape[2]} positions is full at "
                             f"position {pos}; grow it with pad_cache_seq")
        for i, lp in enumerate(params["blocks"]):
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            h = h + L.attn_decode(lp["attn"], cfg, a_in,
                                  {"k": k[i], "v": v[i]}, pos=pos)
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            h = h + _ffn(lp, cfg, m_in)[0]
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
                   per_slot_pos: bool = False, *, kind: str = "ring",
                   pool_pages: int = 0, page_rows: int = 0,
                   state_pages: int = 0):
    """Decode-cache declaration. ``per_slot_pos=True`` declares the
    continuous-batching layout: ``pos`` is a (batch,) vector, one position
    per slot. Dense and moe: a KV ring of ``min(smax, swa_window)`` rows a
    slot; ssm: conv history and state.

    ``kind="paged"`` swaps the attention families' per-slot rings for one
    pool of
    ``pool_pages`` pages of ``page_rows`` rows shared by every slot (block
    tables map slots to pages, ``serving/kvpool.py``); the ssm family keeps
    its live per-slot conv and state and adds a pool of ``state_pages``
    snapshots for prompt-boundary prefix sharing."""
    _require_ported(cfg)
    if kind == "paged" and not per_slot_pos:
        raise ValueError("the paged cache is continuous-batching only "
                         "(per_slot_pos=True)")
    if kind not in ("ring", "paged"):
        raise ValueError(f"cache kind must be 'ring' or 'paged', got {kind!r}")
    cache: dict[str, Any] = {
        "pos": PSpec((batch,) if per_slot_pos else (), "zeros", torch.int32)}
    if cfg.family in ATTN_FAMILIES:
        if kind == "paged":
            cache["attn"] = L.attn_page_cache_pspec(cfg, cfg.n_layers,
                                                    pool_pages, page_rows)
        else:
            cache["attn"] = L.attn_cache_pspec(cfg, cfg.n_layers, batch, smax)
            del cache["attn"]["pos"]
    else:
        cache["mamba"] = L.mamba_cache_pspec(cfg, cfg.n_layers, batch)
        if kind == "paged":
            cache["snap"] = L.mamba_snap_pspec(cfg, cfg.n_layers, state_pages)
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
    if cfg.family in ATTN_FAMILIES:
        k, v = cache["attn"]["k"], cache["attn"]["v"]
        for i, lp in enumerate(params["blocks"]):
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            h = h + L.attn_decode_block(
                lp["attn"], cfg, a_in, {"k": k[i], "v": v[i], "pos": pos},
                n_valid=n_valid)
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            h = h + _ffn(lp, cfg, m_in)[0]
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


def _snap_plan(reset: torch.Tensor, load: torch.Tensor,
               save: torch.Tensor) -> dict:
    """The tick's snapshot plan as fixed-shape indices, made once for every
    layer. Loads: ``use`` marks the reset slots that start from snapshot
    ``page`` instead of zeros. Saves: each slot's pre-tick state goes to a
    page as a (``src`` slot, ``dst`` page) pair: a slot with ``save >= 0``
    its own state into page ``save``; every other slot repeats the first
    saver's pair, or, when no slot saves, page 0 takes its own content back
    (``keep``). Writes to one page then carry one value."""
    b = save.shape[0]
    saves = save >= 0
    first = saves.to(torch.uint8).argmax().view(1)
    keep = ~saves.any()
    return {
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
    dst = plan["dst"]
    snap.index_copy_(dim, dst, torch.where(
        plan["keep"], snap.index_select(dim, dst),
        init.index_select(dim, plan["src"]).to(snap.dtype)))
    return init


def lm_decode_block_paged(params, cfg: L.ModelConfig, cache, batch, *,
                          n_valid, reset_mask, page):
    """Paged-pool twin of :func:`lm_decode_block`.

    ``page`` carries the host manager's plan of the tick
    (``serving/kvpool.py``): ``reset_pos`` (B,), the start position of each
    reset slot (> 0 when a shared prefix is skipped). Dense and moe add
    ``tables``
    (B, MP), the block tables, and ``kv_src``, ``kv_dst``: the copy-on-write
    page copies (:func:`repro_torch.serving.kvpool.cow_pairs`), applied to
    every layer's pool in place before the layers. Where the reference
    gathers the whole pool through its ``kv_copy`` (identity but where a
    fresh page reads its source), the pairs copy only those pages; the
    result is the same. Ssm adds ``snap_save`` and ``snap_load`` (B,):
    snapshot pages to save the slot's pre-tick state into, and to load a
    reset slot's state from (-1: none). The cache is updated in place;
    returns (logits (B, vocab) after each slot's last valid token, cache)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    b, t_len = tokens.shape
    dev = tokens.device
    n_valid = torch.as_tensor(n_valid, device=dev).long()
    reset = torch.as_tensor(reset_mask, device=dev).bool()
    pos = torch.where(reset, torch.as_tensor(page["reset_pos"], device=dev),
                      cache["pos"])
    h = embed_tokens(params["embed"], tokens)                # (B, T, d)
    if cfg.family in ATTN_FAMILIES:
        k, v = cache["attn"]["k"], cache["attn"]["v"]
        src = torch.as_tensor(page["kv_src"], device=dev).long().reshape(-1)
        dst = torch.as_tensor(page["kv_dst"], device=dev).long().reshape(-1)
        for c in (k, v):
            c.index_copy_(1, dst, c.index_select(1, src))
        tables = torch.as_tensor(page["tables"], device=dev).long()
        for i, lp in enumerate(params["blocks"]):
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.policy)
            h = h + L.attn_decode_paged(
                lp["attn"], cfg, a_in, {"k": k[i], "v": v[i], "pos": pos},
                n_valid=n_valid, tables=tables)
            m_in = rmsnorm(h, lp["ln2"], cfg.norm_eps, cfg.policy)
            h = h + _ffn(lp, cfg, m_in)[0]
    else:
        conv, state = cache["mamba"]["conv"], cache["mamba"]["state"]
        snap = cache["snap"]
        plan = _snap_plan(
            reset, torch.as_tensor(page["snap_load"], device=dev).long(),
            torch.as_tensor(page["snap_save"], device=dev).long())
        # the conv histories are small: every layer's at once; the states
        # layer by layer, where one layer's stays in L2
        conv0 = _snap_io(conv, snap["conv"], plan, dim=1)
        for i, lp in enumerate(params["blocks"]):
            m_in = rmsnorm(h, lp["ln"], cfg.norm_eps, cfg.policy)
            out, c = L.mamba_decode_block(
                lp["mamba"], cfg, m_in,
                {"conv": conv0[i],
                 "state": _snap_io(state[i], snap["state"][i], plan)},
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
    return Bundle(cfg=cfg, params_pspec=pspec, loss=loss,
                  prefill_last=prefill_last,
                  decode=decode, n_params=n, n_active_params=n_active,
                  cache_pspec=cache_pspec, decode_block=decode_block,
                  decode_block_paged=decode_block_paged)

"""Layer implementations: GQA attention, SwiGLU MLP, token-choice MoE, the
Mamba-2 (SSD) mixer.

Functional, as in the reference: ``<layer>_pspec(cfg)`` declares one
layer's parameters, ``<layer>_apply`` runs the full sequence,
``<layer>_decode`` steps a cache, ``<layer>_decode_block`` steps the
continuous scheduler's per-slot cache (``<layer>_cache_pspec``) by T tokens
with a valid count per slot, writing it in place and reading no device
value on the host (the step is captured in a CUDA graph);
:func:`attn_decode_paged` does the same over the paged KV pool. Attention, the
SSD and the norms go
through ``repro_torch.core.dispatch`` under ``ModelConfig.policy`` (None:
the active policy, whose ``auto`` runs the Hopper kernels on the card), and
so do the MoE router's counts (a ragged reduce) and
capacity offsets (an exclusive scan, ``tcu_scan.cu`` on the card). Parameter
layouts are the reference's, e.g.
``in_proj`` is ``(d, e)`` and ``y = x @ W``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch
from repro_torch.core import policy as kpolicy
from repro_torch.core.policy import KernelPolicy
from repro_torch.core.ssd import ssd_decode_step
from repro_torch.models.common import PSpec, rmsnorm, rope, swiglu
from repro_torch.models.xla_attention import decode_attention, \
    decode_attention_part
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.parallel.tensor_parallel import Take, merged


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    swa_window: int | None = None
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # routing granularity: "grouped" routes and dispatches within
    # ``gcd(tokens, moe_groups)`` contiguous token groups (the reference's
    # default); "global" sorts the whole batch at once
    moe_impl: str = "grouped"
    moe_groups: int = 32
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4
    expand: int = 2
    ssd_chunk: int = 128           # chunk of the ``fused`` SSD form
    # hybrid (Zamba2-style): one shared attention block after every
    # ``shared_attn_every`` Mamba layers
    shared_attn_every: int = 0
    # enc-dec: the encoder's layers (``n_layers`` is the decoder's)
    enc_layers: int = 0
    # modality stub (vlm): ``stub_tokens`` prefix embeddings of width
    # ``stub_dim``, fed past the frontend and projected to d_model
    stub_tokens: int = 0
    stub_dim: int = 0
    dtype: torch.dtype = torch.bfloat16
    # activation checkpointing of each layer in training: none (recompute
    # the layer in backward) | dots (keep the matmul outputs) | off
    remat_policy: str = "none"
    # explicit KernelPolicy for every core op of the model (attention, the
    # SSD, the norms, the MoE counts and offsets); strings coerce; None: the
    # active policy at call time
    policy: KernelPolicy | None = None
    # deprecated spelling of ``policy`` (a bare path label); warns once
    kernel_path: dataclasses.InitVar[str | None] = None

    def __post_init__(self, kernel_path):
        object.__setattr__(self, "policy", kpolicy.coerce_config_policy(
            self.policy, kernel_path, "ModelConfig"))

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


# ---------------------------------------------------------------------------
# attention


def attn_pspec(cfg: ModelConfig, d_in: int | None = None):
    """One attention layer's parameters; q, k and v project from ``d_in``
    (None: d_model)."""
    d = d_in or cfg.d_model
    dh, hq, hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": PSpec((d, hq * dh), logical=("embed", "heads")),
        "wk": PSpec((d, hkv * dh), logical=("embed", "kv_heads")),
        "wv": PSpec((d, hkv * dh), logical=("embed", "kv_heads")),
        # wo always projects back to the residual width (Zamba2's shared
        # block reads concat(h, embeddings) of width 2 d_model)
        "wo": PSpec((hq * dh, cfg.d_model), logical=("heads", "embed")),
    }


def attn_takes(cfg: ModelConfig, tp) -> dict:
    """The columns of one attention layer a tensor-parallel rank takes: its
    ``n_heads / model`` query heads (rows of ``wo``) and the KV heads they
    read, ``n_kv_heads / model`` of them where that divides, else the one
    KV head of their GQA group (the model ranks sharing it each take it)."""
    dh, hq, hkv, m = cfg.dh, cfg.n_heads, cfg.n_kv_heads, tp.size
    q0, q1 = tp.span(hq, "query heads")
    q = Take(1, ((q0 * dh, q1 * dh),))
    if hkv % m == 0:
        k0, k1 = tp.span(hkv, "KV heads")
    elif m % hkv == 0:
        k0 = tp.index // (m // hkv)
        k1 = k0 + 1
    else:
        raise ValueError(f"tensor parallelism over {m} ranks needs the KV "
                         f"heads ({hkv}) to divide it or divide by it")
    kv = Take(1, ((k0 * dh, k1 * dh),))
    return {"wq": q, "wk": kv, "wv": kv, "wo": Take(0, q.ranges)}


def attn_apply(p, cfg: ModelConfig, x, *, positions=None, causal=True,
               window=None, kv=None):
    """Attention over x (B,S,d) -> (out (B,S,d), (k, v)), k, v (B,Sk,Hkv,Dh)
    for the cache. Self-attention by default: rope at ``positions`` (B,S)
    on q and k. ``kv`` (B,Sk,d) makes it cross-attention: k and v project
    from ``kv``, no rope and no causal mask, as in the reference.

    Under tensor parallelism (``tensor_parallel.current()``) ``p`` holds
    this rank's heads (:func:`attn_takes`): the rank attends them, and its
    part of ``wo``'s product is summed across ranks; a cross-attention's
    ``kv`` gradient, partial on each rank too, is summed as x's is."""
    b, s, _ = x.shape
    tp = tpar.current()
    if tp is not None:
        x = tp.copy_in(x)
        kv = None if kv is None else tp.copy_in(kv)
    dh = cfg.dh
    hq, hkv = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    src = x if kv is None else kv
    sk = src.shape[1]
    q = (x @ p["wq"]).reshape(b, s, hq, dh)
    k = (src @ p["wk"]).reshape(b, sk, hkv, dh)
    v = (src @ p["wv"]).reshape(b, sk, hkv, dh)
    if positions is not None and kv is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = dispatch.attention(q, k, v, causal=causal and kv is None,
                           window=window, policy=cfg.policy)
    out = o.reshape(b, s, hq * dh) @ p["wo"]
    return (out if tp is None else tp.reduce_out(out)), (k, v)


def _project(p, cfg: ModelConfig, x, positions):
    """q ``(B, T, hq, Dh)``, k and v ``(B, T, hkv, Dh)`` of the heads whose
    columns ``p`` holds (every head, or a tensor-parallel rank's), rope on
    q and k at ``positions`` (B, T)."""
    b, t = x.shape[:2]
    dh = cfg.dh
    hq, hkv = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    q = rope((x @ p["wq"]).reshape(b, t, hq, dh), positions, cfg.rope_theta)
    k = rope((x @ p["wk"]).reshape(b, t, hkv, dh), positions, cfg.rope_theta)
    v = (x @ p["wv"]).reshape(b, t, hkv, dh)
    return q, k, v


def _cache_rows(tp, local: int) -> tuple[int, int]:
    """(the KV cache's global rows, the first of this rank's ``local``):
    all of them but where a serving step splits them over mesh dims
    (``seq_axes``)."""
    if tp is None or not tp.seq_axes:
        return local, 0
    return tp.kv_rows, tp.seq_start()


def _cache_heads(cfg: ModelConfig, q, k, v, held: int, tp):
    """q, k and v of the heads a cache of ``held`` KV heads holds, and this
    rank's query heads among them (None: all of them). Where the cache
    holds every KV head but the rank computes a part (a serving step whose
    cache rows are split over ``model``), the new tokens' q, k and v are
    gathered over ``model`` in one all-gather; ranks that share a KV head
    (the KV heads do not divide ``model``) each give a copy, one is kept."""
    hq, hkv = q.shape[2], k.shape[2]
    if hkv == held:
        return q, k, v, None
    b, t, _, dh = q.shape
    parts = tp.all_model(torch.cat([q, k, v], dim=2)[None], 0)
    q = parts[..., :hq, :].permute(1, 2, 0, 3, 4).reshape(b, t, -1, dh)
    k, v = (parts[..., hq + i * hkv:hq + (i + 1) * hkv, :]
            .permute(1, 2, 0, 3, 4).reshape(b, t, -1, dh) for i in range(2))
    if k.shape[2] != held:
        k, v = k[:, :, ::tp.size // held], v[:, :, ::tp.size // held]
    return q, k, v, (tp.index * hq, (tp.index + 1) * hq)


def _attend(q, kc, vc, lens, start: int, tp):
    """Attention of q over the cache rows ``kc``/``vc`` at global positions
    ``[start, start + rows)``, in q's dtype: the whole cache, or where a
    serving step splits its rows (``seq_axes``) this rank's range, merged
    across the ranks that hold the others."""
    if tp is None or not tp.seq_axes:
        return decode_attention(q, kc, vc, lens)
    o, m, l = decode_attention_part(q, kc, vc, lens, start=start)
    return tp.merge_attention(o, m, l).to(q.dtype)


def _attn_out(o, p, tp, heads):
    """``wo`` over the heads' outputs ``(B, T, H, Dh)`` (this rank's
    ``heads`` of them where given): row-parallel under tensor parallelism,
    the partial products summed over ``model``."""
    if heads is not None:
        o = o[:, :, heads[0]:heads[1]]
    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return out if tp is None else tp.reduce_out(out)


def attn_decode(p, cfg: ModelConfig, x, cache, *, pos: int, window=None):
    """x (B,1,d); cache {k, v: (B,Smax,Hkv,Dh)} -> out (B,1,d).

    The reference's scalar-position decode of the wave path. Without a
    window this token's k, v go to row ``pos`` of the cache, in place, and
    it attends rows ``[0, pos]`` (the callers raise first where ``pos`` is
    past the cache, which the reference clamps onto its last row). With a
    sliding window the cache is a ring: the token goes to row ``pos %
    Smax`` and attends ``min(pos + 1, Smax)`` rows; rope takes the absolute
    position, so the storage order does not change the softmax.

    Under a serving ``TensorParallel`` ``p`` holds this rank's heads
    (:func:`attn_takes`) and ``wo`` is row-parallel. Where the cache's rows
    are split across ranks (``seq_axes``; ``Smax`` then is the rank's
    range, every KV head), the token is written by the rank that holds its
    row, and each rank attends its range, the parts merged by log-sum-exp;
    the cache is never gathered."""
    b = x.shape[0]
    tp = tpar.current()
    kc, vc = cache["k"], cache["v"]
    local = kc.shape[1]
    cap, s0 = _cache_rows(tp, local)
    posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project(p, cfg, x, posv)
    q, k, v, heads = _cache_heads(cfg, q, k, v, kc.shape[2], tp)
    row = (pos % cap if window is not None else pos) - s0
    if 0 <= row < local:
        kc[:, row] = k[:, 0].to(kc.dtype)
        vc[:, row] = v[:, 0].to(vc.dtype)
    o = _attend(q, kc, vc, min(pos + 1, cap), s0, tp)
    return _attn_out(o, p, tp, heads)


def cross_decode(p, cfg: ModelConfig, x, kc, vc):
    """Cross-attention of x (B,1,d) over the memory's K and V ``kc``/``vc``
    (B,S_enc,Hkv,Dh), computed once at the prefill: every row valid, no
    rope, no mask -> out (B,1,d).

    Under a serving ``TensorParallel`` ``p`` holds this rank's heads
    (:func:`attn_takes`) and ``wo`` is row-parallel. The cache holds the KV
    heads the rank computes, or, where its rows are split across ranks
    (``seq_axes``), the rank's range of the memory's rows with every KV
    head: then the token's queries are gathered over ``model``, each rank
    attends its range and the parts are merged by log-sum-exp; the cache is
    never gathered."""
    b = x.shape[0]
    tp = tpar.current()
    dh = cfg.dh
    hq = p["wq"].shape[-1] // dh
    q = (x @ p["wq"]).reshape(b, 1, hq, dh)
    heads = None
    if kc.shape[2] != p["wk"].shape[-1] // dh:   # every KV head, rows split
        q = tp.all_model(q, 2)
        heads = (tp.index * hq, (tp.index + 1) * hq)
    start, rows = 0, kc.shape[1]
    if tp is not None and tp.seq_axes:
        idx, parts = tp.index_in(tp.seq_axes)
        start, rows = idx * rows, rows * parts
    o = _attend(q, kc, vc, rows, start, tp)
    return _attn_out(o, p, tp, heads)


def attn_decode_block(p, cfg: ModelConfig, x, cache, *, n_valid):
    """Slot-masked T-token step against a ring KV cache.

    x (B,T,d); cache {k, v: (B,S,Hkv,Dh), pos: (B,)}; ``n_valid`` (B,) in
    [0, T]: token t of slot b is real iff ``t < n_valid[b]``. A real token
    is written at ring row ``(pos[b] + t) % S`` and attends ``min(pos[b] +
    t + 1, S)`` rows; rope takes the absolute positions. The rows are
    written in place by index: the old rows are gathered, replaced where
    the token is real, and scattered back. With ``T <= S`` the T rows of a
    slot are distinct, so the write is exact and order-free. Returns out
    (B,T,d); the caller advances ``pos``.

    Sharded serving (a serving ``TensorParallel``): the slots are this
    rank's, ``p`` holds its heads (:func:`attn_takes`) and ``wo`` is
    row-parallel; the cache holds the KV heads the rank computes, or, where
    its rows are split across ranks (``seq_axes``), the rank's range of the
    ring (``S`` its rows; T must not pass them) with every KV head: a token
    is written by the rank that holds its row, each rank attends its range
    and the parts are merged by log-sum-exp. The cache is never
    gathered."""
    b, t_len = x.shape[:2]
    tp = tpar.current()
    kc, vc = cache["k"], cache["v"]
    local = kc.shape[1]
    cap, s0 = _cache_rows(tp, local)
    if t_len > local:
        raise ValueError(f"a block step of {t_len} tokens needs a ring of at "
                         f"least {t_len} rows, the cache has {local}")
    steps = torch.arange(t_len, device=x.device)
    posmat = cache["pos"].long()[:, None] + steps[None, :]      # (B, T)
    q, k, v = _project(p, cfg, x, posmat)
    q, k, v, heads = _cache_heads(cfg, q, k, v, kc.shape[2], tp)
    hkv, dh = k.shape[2], k.shape[3]
    row = posmat % cap
    valid = steps[None, :] < n_valid[:, None]
    if cap != local:            # this rank's range of the ring's rows
        row = row - s0
        valid = valid & (row >= 0) & (row < local)
        # T consecutive positions have distinct rows mod the rank's rows
        row = row % local
    valid = valid[..., None, None]
    idx = row[..., None, None].expand(b, t_len, hkv, dh)
    for c, new in ((kc, k), (vc, v)):
        c.scatter_(1, idx, torch.where(valid, new.to(c.dtype),
                                       c.gather(1, idx)))
    o = _attend(q, kc, vc, torch.clamp(posmat + 1, max=cap), s0, tp)
    return _attn_out(o, p, tp, heads)


def attn_decode_paged(p, cfg: ModelConfig, x, cache, *, n_valid, tables):
    """Block-table twin of :func:`attn_decode_block` for the paged KV pool
    (``serving/kvpool.py``).

    x (B,T,d); cache {k, v: (P, R, Hkv, Dh), the pool shared by every slot,
    pos: (B,)}; ``tables`` (B, MP) maps slot b's logical page ``(p // R) %
    MP`` to a pool page, so real token t lands at pool row ``tables[b, (p //
    R) % MP] * R + p % R`` (p its absolute position). The host manager
    makes the rows real tokens write distinct across slots (copy-on-write
    comes before any write to a shared page), but a token past ``n_valid``
    may name a row that a real token writes. So every token writes, in
    place by index: a real token its own k, v; another token the value of
    the real token writing the same row, if any, else the row's old value.
    Writes to one row then carry one value, and the scatter is exact and
    order-free. Attention gathers the slot's pages back into ring order:
    for position p the gathered row is ``((p // R) % MP) * R + p % R == p
    % (MP * R)``, the ring row of a capacity-``MP * R`` cache, so the
    result equals the ring path's, sliding window included. Returns out
    (B,T,d); the caller advances ``pos``.

    Sharded serving: x, ``n_valid`` and ``pos`` are this rank's slots and
    ``tables`` every slot's; the pool holds the KV heads the rank computes
    and is replicated over the batch's mesh dims, so the new rows (and
    their pool rows) of every rank's slots are gathered over them before
    the write, which every rank then makes alike."""
    b, t_len = x.shape[:2]
    tp = tpar.current()
    kc, vc = cache["k"], cache["v"]
    n_pages, r = kc.shape[:2]
    mp = tables.shape[1]
    cap = mp * r                                   # the ring it stands for
    if t_len > cap:
        raise ValueError(f"a block step of {t_len} tokens needs at least "
                         f"{t_len} rows a slot, the block table maps {cap}")
    mine = tables if tp is None else tables.narrow(0, tp.row_start(b), b)
    steps = torch.arange(t_len, device=x.device)
    posmat = cache["pos"].long()[:, None] + steps[None, :]      # (B, T)
    q, k, v = _project(p, cfg, x, posmat)
    hkv, dh = k.shape[2], k.shape[3]
    phys = mine.gather(1, (posmat // r) % mp)                   # (B, T)
    rows = (phys * r + posmat % r).reshape(-1)                  # (B*T,)
    valid = (steps[None, :] < n_valid[:, None]).reshape(-1)
    k, v = k.reshape(b * t_len, hkv, dh), v.reshape(b * t_len, hkv, dh)
    if tp is not None and tp.rows_split():     # every rank's slots' rows
        rows, valid = tp.gather_rows(torch.stack([rows, valid.long()]), 1)
        valid = valid.bool()
        k, v = tp.gather_rows(torch.stack([k, v], dim=1)).unbind(1)
    # writer[i, j]: real token j writes token i's row (at most one j a row)
    writer = (rows[:, None] == rows[None, :]) & valid[None, :]
    written = writer.any(dim=1)[:, None, None]
    src = writer.to(torch.uint8).argmax(dim=1)
    for c, new in ((kc, k), (vc, v)):
        flat = c.view(n_pages * r, hkv, dh)
        new = new.to(c.dtype)
        flat.index_copy_(0, rows, torch.where(
            written, new.index_select(0, src), flat.index_select(0, rows)))
    # each slot's pages back in ring order: (B, MP*R, Hkv, Dh)
    pages = mine.reshape(-1)
    k_seq = kc.index_select(0, pages).view(b, cap, hkv, dh)
    v_seq = vc.index_select(0, pages).view(b, cap, hkv, dh)
    o = _attend(q, k_seq, v_seq, torch.clamp(posmat + 1, max=cap), 0, None)
    return _attn_out(o, p, tp, None)


def attn_cache_pspec(cfg: ModelConfig, n_layers: int, batch: int, smax: int):
    """The ring KV cache of ``n_layers`` layers: ``min(smax, swa_window)``
    rows a slot."""
    cap = min(smax, cfg.swa_window) if cfg.swa_window else smax
    shp = (n_layers, batch, cap, cfg.n_kv_heads, cfg.dh)
    log = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"k": PSpec(shp, "zeros", logical=log),
            "v": PSpec(shp, "zeros", logical=log),
            "pos": PSpec((), "zeros", torch.int32)}


def attn_page_cache_pspec(cfg: ModelConfig, n_layers: int, pages: int,
                          page_rows: int):
    """The paged KV pool of ``n_layers`` layers: ``pages`` pages of
    ``page_rows`` rows shared by every slot (block tables map slots to
    pages)."""
    shp = (n_layers, pages, page_rows, cfg.n_kv_heads, cfg.dh)
    log = ("layers", None, None, "kv_heads", None)
    return {"k": PSpec(shp, "zeros", logical=log),
            "v": PSpec(shp, "zeros", logical=log)}


# ---------------------------------------------------------------------------
# dense MLP


def mlp_pspec(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_in": PSpec((d, f), logical=("embed", "ff")),
            "w_gate": PSpec((d, f), logical=("embed", "ff")),
            "w_out": PSpec((f, d), logical=("ff", "embed"))}


def mlp_takes(cfg: ModelConfig, tp) -> dict:
    """The ``ff`` columns (rows of ``w_out``) a tensor-parallel rank
    takes."""
    cols = (tp.span(cfg.d_ff, "ff"),)
    return {"w_in": Take(1, cols), "w_gate": Take(1, cols),
            "w_out": Take(0, cols)}


def mlp_apply(p, cfg: ModelConfig, x):
    return swiglu(x, p["w_in"], p["w_gate"], p["w_out"])


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, sort-based capacity dispatch)


def moe_pspec(cfg: ModelConfig):
    """One MoE layer's parameters: the router and each expert's SwiGLU."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {"router": PSpec((d, e), "normal", logical=("embed", None)),
            "w_in": PSpec((e, d, f), logical=("experts", "embed", "e_ff")),
            "w_gate": PSpec((e, d, f),
                            logical=("experts", "embed", "e_ff")),
            "w_out": PSpec((e, f, d),
                           logical=("experts", "e_ff", "embed"))}


def moe_takes(cfg: ModelConfig, tp) -> dict:
    """What a tensor-parallel rank takes of one MoE layer, as the reference's
    rules shard it (``experts`` and then ``e_ff`` over ``model``): its
    ``n_experts / model`` experts where ``model`` divides them, else every
    expert's ``moe_d_ff / model`` columns (rows of ``w_out``). The router
    is taken whole, as a take of every column, so that its gradient is
    summed over ``model``: the combine's part of it is partial on each
    rank."""
    e, f = cfg.n_experts, cfg.moe_d_ff
    router = Take(1, ((0, e),))
    if e % tp.size == 0:
        ex = Take(0, (tp.span(e, "experts"),))
        return {"router": router, "w_in": ex, "w_gate": ex, "w_out": ex}
    cols = (tp.span(f, "e_ff"),)
    return {"router": router, "w_in": Take(2, cols),
            "w_gate": Take(2, cols), "w_out": Take(1, cols)}


def moe_apply(p, cfg: ModelConfig, x):
    """Token-choice top-k with capacity; the counts and offsets are the
    paper's ragged reduce and exclusive scan. Returns (y, aux_loss)."""
    if cfg.moe_impl == "grouped":
        return moe_apply_grouped(p, cfg, x)
    return moe_apply_global(p, cfg, x)


def moe_apply_grouped(p, cfg: ModelConfig, x):
    """Group-local token-choice top-k MoE (the reference's default): the
    ``B * S`` tokens of the whole batch, row-major, split into ``gcd(B * S,
    moe_groups)`` contiguous groups, each routed, sorted and given its own
    capacity; silu in the native dtype. ``B`` counts every rank's rows
    where the step's batch is split (:func:`_moe_split`)."""
    return _moe_split(p, cfg, x, cfg.moe_groups, native_silu=True)


def moe_apply_global(p, cfg: ModelConfig, x):
    """Whole-batch sort dispatch (the reference's measured baseline): one
    group of every token of the whole batch; silu in f32."""
    return _moe_split(p, cfg, x, 1, native_silu=False)


def _moe_split(p, cfg: ModelConfig, x, groups: int, *, native_silu: bool):
    """:func:`_moe` over ``gcd(tokens, groups)`` groups of the whole batch's
    tokens, as the reference's one program over the whole batch lays them
    out (``moe_groups`` over the batch's mesh dims).

    Where the step's rows lie across ranks (``tensor_parallel.
    batch_layout``: a data-parallel, tensor-parallel or sharded serving
    step), a rank holding ``1/parts`` of the rows runs its ``g / parts``
    contiguous groups; where ``parts`` does not divide ``g`` it gathers the
    rows (their gradients summed back over the ranks), routes every group
    and keeps its rows' outputs, as GSPMD does where a constraint does not
    divide. Under tensor parallelism (``tensor_parallel.current()``) ``p``
    holds the rank's experts or ``e_ff`` columns (:func:`moe_takes`): the
    rank routes every token over every expert (the same on every ``model``
    rank), runs its part of the expert products, and the partial outputs
    are summed over ``model``; the aux loss, alike on every ``model`` rank,
    takes its gradient once (``TensorParallel.once``)."""
    tp, lay = tpar.current(), tpar.batch_layout()
    b, s, _ = x.shape
    parts = 1 if lay is None else lay.row_parts()
    g = math.gcd(b * s * parts, groups)
    if tp is not None:
        x = tp.copy_in(x)
    if g % parts == 0:
        out, aux = _moe(p, cfg, x, g // parts, native_silu=native_silu,
                        tp=tp)
    else:
        out, aux = _moe(p, cfg, lay.gather_rows(x), g,
                        native_silu=native_silu, tp=tp)
        out = out.narrow(0, lay.row_start(b), b)
    if tp is None:
        return out, aux
    return tp.reduce_out(out), tp.once(aux)


def _moe(p, cfg: ModelConfig, x, g: int, *, native_silu: bool, tp=None):
    """The reference's sort-based dispatch over ``g`` groups of ``tg``
    tokens, ``n = tg * k`` routed slots a group. Each group's slots are
    sorted by expert (stable, as ``jnp.argsort``); an expert takes its first
    ``cap`` slots and drops the rest. The capacity buffer is laid out
    expert-major, ``(e, g * cap, d)``, so that every expert's rows are one
    matrix of a batched product without a copy; the k weighted outputs of
    each token are summed over k in a fixed order (the reference's
    scatter-add, without atomics). Returns ((b, s, d), aux).

    Where ``p`` holds a tensor-parallel rank's ``el`` of the ``e`` experts
    (:func:`moe_takes`), the buffer holds their slots only, and a slot of
    another rank's expert adds nothing to the combine; where it holds every
    expert's ``e_ff`` columns, every slot runs on them. Either way the
    output is the rank's partial sum."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    t = b * s
    tg, dev = t // g, x.device
    n = tg * k
    xg = x.reshape(g, tg, d)
    probs = torch.softmax((xg @ p["router"]).float(), dim=-1)  # (g, tg, e)
    top_w, top_i = torch.topk(probs, k, dim=-1)               # (g, tg, k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    e_flat = top_i.reshape(g, n)
    order = torch.argsort(e_flat, dim=-1, stable=True)        # per group
    inv = torch.empty_like(order).scatter_(                   # slot -> sorted
        1, order, torch.arange(n, device=dev).expand(g, n))
    group = torch.arange(g, device=dev)[:, None]

    # per-(group, expert) counts: a ragged reduce of ones over the
    # assignment; the capacity offsets: an exclusive scan over the experts
    counts = dispatch.ragged_reduce(
        torch.ones(g, n, device=dev), e_flat, e, policy=cfg.policy)  # (g, e)
    offsets = dispatch.scan(counts, exclusive=True, policy=cfg.policy)
    start = offsets.long()               # whole numbers, exact below 2^24
    rank = inv - start.gather(1, e_flat)          # rank within its expert
    cap = max(8, int(cfg.capacity_factor * n / e + 127) // 128 * 128)
    keep = rank < cap
    # this rank's experts [e0, e0 + el): every one, or a tensor-parallel
    # rank's share
    el = p["w_in"].shape[0]
    e0 = 0 if el == e else tp.index * el
    if el != e:
        keep = keep & (e_flat >= e0) & (e_flat < e0 + el)

    # dispatch as a slot -> token gather: slot (expert, group, c) holds the
    # group's sorted position start + c while c < min(count, cap); an empty
    # slot reads row t, a row of zeros after the tokens
    slots = torch.arange(cap, device=dev)
    pos = (start[..., None] + slots).clamp(max=n - 1)         # (g, e, cap)
    valid = slots < counts.clamp(max=cap)[..., None]
    tok = order.gather(1, pos.reshape(g, e * cap)) // k
    rows = tok + group * tg
    rows = torch.where(valid.reshape(g, e * cap), rows, t).view(g, e, cap)
    if el != e:
        rows = rows[:, e0:e0 + el]
    rows = rows.transpose(0, 1).reshape(-1)                   # expert-major
    h = torch.cat([x.reshape(t, d), x.new_zeros(1, d)]).index_select(0, rows)
    h = h.view(el, g * cap, d)
    up = torch.bmm(h, p["w_in"])
    gate = torch.bmm(h, p["w_gate"])
    act = (F.silu(gate) if native_silu
           else F.silu(gate.float()).to(up.dtype)) * up
    y = torch.bmm(act, p["w_out"]).view(el * g * cap, d)

    # combine: each routed slot reads its output row, weighted, or nothing
    # when its expert was full (or is another rank's)
    at = ((e_flat - e0) * g + group) * cap + rank
    y_tok = y.index_select(0, torch.where(keep, at, 0).reshape(-1))
    w = (top_w.reshape(g, n) * keep).reshape(-1, 1).to(y.dtype)
    out = (y_tok * w).view(t, k, d).sum(1).to(x.dtype)

    # switch-style load-balance aux: E * <f_e, p_e>, the mean over groups
    frac = counts / counts.sum(-1, keepdim=True).clamp(min=1.0)
    aux = e * torch.mean(torch.sum(frac * probs.mean(1), dim=-1))
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Mamba-2 mixer


def mamba_pspec(cfg: ModelConfig):
    """One Mamba-2 layer's parameters."""
    d, di = cfg.d_model, cfg.d_inner
    g, ns, hh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * ns
    return {
        "in_proj": PSpec((d, 2 * di + 2 * g * ns + hh),
                         logical=("embed", "inner_all")),
        "conv_w": PSpec((cfg.conv_kernel, conv_dim), "fan_in",
                        logical=(None, "inner_all")),
        "conv_b": PSpec((conv_dim,), "zeros", logical=("inner_all",)),
        "dt_bias": PSpec((hh,), "dt_bias", torch.float32,
                         logical=("ssm_heads",)),
        "a_log": PSpec((hh,), "a_log", torch.float32,
                       logical=("ssm_heads",)),
        "d_skip": PSpec((hh,), "ones", torch.float32,
                        logical=("ssm_heads",)),
        "norm_w": PSpec((di,), "ones", logical=("inner",)),
        "out_proj": PSpec((di, d), logical=("inner", "embed")),
    }


def _split_inproj(cfg: ModelConfig, zxbcdt, hh: int | None = None):
    """``in_proj``'s output -> (z, x|B|C, dt) of ``hh`` SSM heads (None:
    every head; a tensor-parallel rank's own, whose B and C groups are
    what the width leaves)."""
    hh = cfg.ssm_heads if hh is None else hh
    di = hh * cfg.ssm_head_dim
    gns = (zxbcdt.shape[-1] - 2 * di - hh) // 2
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gns]
    dt = zxbcdt[..., di + di + 2 * gns:]
    if dt.shape[-1] != hh or gns % cfg.ssm_state:
        raise ValueError(f"in_proj width {zxbcdt.shape[-1]} does not hold "
                         f"{hh} heads of {cfg.ssm_head_dim} and whole groups "
                         f"of B and C")
    return z, xbc, dt


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv. xbc (B,S,C), w (K,C) -> (B,S,C), in f32."""
    k, ch = w.shape
    xp = F.pad(xbc.float().transpose(1, 2), (k - 1, 0))     # (B, C, S+K-1)
    out = F.conv1d(xp, w.float().t().unsqueeze(1), groups=ch)
    return F.silu(out.transpose(1, 2) + bias.float()).to(xbc.dtype)


def mamba_takes(cfg: ModelConfig, tp) -> dict:
    """What a tensor-parallel rank of one Mamba layer takes: its
    ``ssm_heads / model`` heads' z, x and dt columns of ``in_proj`` and
    their conv channels, the B and C groups those heads read (whole at
    ``ssm_groups = 1``), its heads' ``dt_bias``, ``a_log``, ``d_skip``, its
    ``d_inner`` columns of ``norm_w`` and rows of ``out_proj``."""
    di, g, ns, hp = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, \
        cfg.ssm_head_dim
    h0, h1 = tp.span(cfg.ssm_heads, "SSM heads")
    per = cfg.ssm_heads // g                       # heads a group
    g0, g1 = h0 // per, (h1 - 1) // per + 1
    if (h1 - h0) % (g1 - g0) or (h1 - h0) // (g1 - g0) not in (per, h1 - h0):
        raise ValueError(f"tensor parallelism over {tp.size} ranks splits "
                         f"the SSM heads ({cfg.ssm_heads}) across their "
                         f"{g} B/C groups unevenly")
    x = (h0 * hp, h1 * hp)
    bc = ((di + g0 * ns, di + g1 * ns),
          (di + (g + g0) * ns, di + (g + g1) * ns))
    conv = merged((x,) + bc)                       # of [x | B | C]
    dt0 = 2 * di + 2 * g * ns                      # of [z | x | B | C | dt]
    ins = merged((x,) + tuple((a + di, b + di) for a, b in conv)
                 + ((dt0 + h0, dt0 + h1),))
    heads = Take(0, ((h0, h1),))
    return {"in_proj": Take(1, ins), "conv_w": Take(1, conv),
            "conv_b": Take(0, conv), "dt_bias": heads, "a_log": heads,
            "d_skip": heads, "norm_w": Take(0, (x,)),
            "out_proj": Take(0, (x,))}


def _gated_out(y, z, p, cfg: ModelConfig, tp):
    """``out_proj`` of the gated norm of the SSD output ``y`` (B, T, di) in
    x's dtype, gate ``z``: under tensor parallelism over this rank's
    ``d_inner`` columns, the norm's sums completed across ranks
    (``split_rmsnorm``) and ``out_proj``'s partial product summed."""
    y = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        y = rmsnorm(y, p["norm_w"], cfg.norm_eps, cfg.policy)
    else:
        y = tpar.split_rmsnorm(y, p["norm_w"], cfg.norm_eps, cfg.d_inner, tp,
                               cfg.policy)
    out = y @ p["out_proj"]
    return out if tp is None else tp.reduce_out(out)


def _mixer_in(p, cfg: ModelConfig, x):
    """(z, raw x|B|C, raw dt, heads, groups) of ``in_proj`` over x, for
    the SSM heads whose columns ``p`` holds (every head, or a
    tensor-parallel rank's)."""
    hh = p["dt_bias"].shape[-1]
    z, xbc, dt_raw = _split_inproj(cfg, x @ p["in_proj"], hh)
    g = (xbc.shape[-1] - hh * cfg.ssm_head_dim) // (2 * cfg.ssm_state)
    return z, xbc, dt_raw, hh, g


def mamba_apply(p, cfg: ModelConfig, x, *, collect_cache: bool = False):
    """x (B,S,d) -> (out (B,S,d), cache-or-None). Full-sequence path.

    Under tensor parallelism (``tensor_parallel.current()``) ``p`` holds
    this rank's SSM heads (:func:`mamba_takes`): the SSD runs on them, the
    gated norm over ``d_inner`` completes its sums across ranks
    (``split_rmsnorm``) and ``out_proj``'s partial product is summed."""
    b, s, _ = x.shape
    tp = tpar.current()
    if tp is not None:
        x = tp.copy_in(x)
    ns, hp = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc_raw, dt_raw, hh, g = _mixer_in(p, cfg, x)
    di = hh * hp
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
    out = _gated_out(y.reshape(b, s, di).to(x.dtype), z, p, cfg, tp)
    cache = None
    if collect_cache:
        # conv cache = last K-1 *raw* mixer inputs; state (B,H,P,N) from SSD
        cache = {"conv": xbc_raw[:, -(cfg.conv_kernel - 1):].clone(),
                 "state": state}
    return out, cache


def mamba_cache_pspec(cfg: ModelConfig, n_layers: int, batch: int,
                      batch_axis: str | None = "batch"):
    """Conv history (the last K-1 raw mixer inputs) and SSD state of
    ``n_layers`` layers, ``batch`` of each, that dim named
    ``batch_axis``."""
    di, g, ns = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    conv_dim = di + 2 * g * ns
    return {
        "conv": PSpec((n_layers, batch, cfg.conv_kernel - 1, conv_dim),
                      "zeros",
                      logical=("layers", batch_axis, None, "inner_all")),
        "state": PSpec((n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, ns),
                       "zeros", torch.float32,
                       logical=("layers", batch_axis, "ssm_heads", None,
                                None)),
    }


def mamba_snap_pspec(cfg: ModelConfig, n_layers: int, pages: int):
    """The paged cache's snapshot pool: ``pages`` (conv history, state)
    pairs, each captured at a prompt boundary so that a later request
    extending that exact prompt skips its prefill. The live per-slot state
    stays in :func:`mamba_cache_pspec`; a page has its layout, the page dim
    unsharded (a pooled resource, not a batch dim)."""
    return mamba_cache_pspec(cfg, n_layers, pages, batch_axis=None)


def mamba_decode(p, cfg: ModelConfig, x, cache):
    """x (B,1,d); cache {conv (B,K-1,C), state (B,H,P,N)} -> (out, cache).
    Under a serving ``TensorParallel`` ``p``, the conv history and the state
    are this rank's SSM heads' (:func:`mamba_takes`, ``C`` their conv
    channels)."""
    b = x.shape[0]
    tp = tpar.current()
    ns, hp = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt_raw, hh, g = _mixer_in(p, cfg, x)
    di = hh * hp
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
    out = _gated_out(y.reshape(b, 1, di).to(x.dtype), z, p, cfg, tp)
    return out, {"conv": hist[:, 1:], "state": state}


def mamba_decode_block(p, cfg: ModelConfig, x, cache, *, n_valid):
    """Slot-masked T-token recurrent step.

    x (B,T,d); cache {conv (B,K-1,C), state (B,H,P,N)}; slot b consumes its
    first ``n_valid[b]`` tokens. The conv runs VALID over [cached history |
    chunk] in f32; the SSD recurrence is a loop over T of
    :func:`ssd_decode_step` whose new state is kept only where the token is
    real, so a slot's state stops at its own ``n_valid``. The new conv
    history is the K-1 raw inputs before each slot's next token. Returns
    (out (B,T,d), {conv, state}); the outputs of tokens past ``n_valid``
    are junk the caller discards. Sharded as :func:`mamba_decode`: this
    rank's slots and SSM heads."""
    b, t_len = x.shape[:2]
    tp = tpar.current()
    ns, hp, kk = cfg.ssm_state, cfg.ssm_head_dim, cfg.conv_kernel
    z, xbc_raw, dt_raw, hh, g = _mixer_in(p, cfg, x)
    di = hh * hp
    conv = cache["conv"]
    hist = torch.cat([conv, xbc_raw.to(conv.dtype)], dim=1)  # (B,K-1+T,C)
    ch = hist.shape[-1]
    conv_out = F.conv1d(hist.float().transpose(1, 2),
                        p["conv_w"].float().t().unsqueeze(1), groups=ch)
    xbc = F.silu(conv_out.transpose(1, 2) + p["conv_b"].float()).to(x.dtype)
    xs = xbc[..., :di].reshape(b, t_len, hh, hp)
    bmat = xbc[..., di:di + g * ns].reshape(b, t_len, g, ns)
    cmat = xbc[..., di + g * ns:].reshape(b, t_len, g, ns)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    steps = torch.arange(t_len, device=x.device)
    upd = (steps[:, None] < n_valid[None, :])[..., None, None, None]
    state, ys = cache["state"], []
    for t in range(t_len):
        y_t, new = ssd_decode_step(state, xs[:, t], dt[:, t], a, bmat[:, t],
                                   cmat[:, t])
        state = torch.where(upd[t], new, state)
        ys.append(y_t)
    y = torch.stack(ys, dim=1).float()                       # (B,T,H,P)
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    out = _gated_out(y.reshape(b, t_len, di).to(x.dtype), z, p, cfg, tp)
    rows = n_valid[:, None] + torch.arange(kk - 1, device=x.device)
    new_conv = hist.gather(1, rows[..., None].expand(b, kk - 1, ch))
    return out, {"conv": new_conv, "state": state}

"""Memory-bounded attention in plain torch: the ``fused`` path and decode.

Counterpart of ``repro.models.xla_attention``. :func:`chunked_attention` is
the same blocked online-softmax computation as the flash kernel, a loop over
query chunks and (outside the sliding window) KV chunks, in the grouped
layout ``(B, Hkv, rep, ...)`` so that no repeated K/V is materialised; with a
window shorter than the keys it slices the KV window per query chunk. It
takes exactly the shapes the reference takes and raises ``ValueError`` on
the others: the reference reshapes the queries into ``min(256, Sq)``-row
chunks, so ``Sq > 256`` must be a multiple of 256.

:func:`decode_attention` attends query tokens against a KV cache with a
valid length per call, slot or query; the reference runs it outside any
Pallas kernel, so it stays plain torch here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = float(-1e30)
Q_CHUNK = 256        # query rows per chunk, the reference's default
KV_CHUNK = 1024      # about this many key rows per chunk outside a window


def _check_chunks(sq: int, sk: int, hq: int, hkv: int, swa: bool) -> None:
    if hq % hkv:
        raise ValueError(f"chunked_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    qc = min(Q_CHUNK, sq)
    if sq % qc:
        raise ValueError(
            f"chunked_attention: Sq={sq} is neither <= {Q_CHUNK} nor a "
            f"multiple of it; the reference's fused path reshapes the "
            f"queries into {qc}-row chunks and cannot take it (use the "
            f"'tile' or 'baseline' attention path)")
    if swa:
        if sq > sk:
            raise ValueError(
                f"chunked_attention: Sq={sq} > Sk={sk} with a sliding "
                f"window; the reference's window slice would start before "
                f"the keys")
        return
    nk = max(sk // KV_CHUNK, 1)
    if sk % nk:
        raise ValueError(
            f"chunked_attention: Sk={sk} does not split into {nk} equal "
            f"KV chunks of about {KV_CHUNK}, as the reference requires")


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """``q (B, Sq, Hq, D)``, ``k``/``v`` ``(B, Sk, Hkv, D)`` ->
    ``(B, Sq, Hq, D)`` in q's dtype; f32 math, ends aligned by ``Sk - Sq``.
    The sliding-window branch is causal whatever ``causal`` says, as in the
    reference."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    swa = window is not None and window < sk
    _check_chunks(sq, sk, hq, hkv, swa)
    rep = hq // hkv
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    offs = sk - sq
    qc = min(Q_CHUNK, sq)
    qg = q.reshape(b, sq, hkv, rep, d).float()
    kf, vf = k.float(), v.float()
    dev = q.device
    outs = []
    if swa:
        wlen = window + qc
        kp = F.pad(kf, (0, 0, 0, 0, window, 0))
        vp = F.pad(vf, (0, 0, 0, 0, window, 0))
        for iq in range(sq // qc):
            qi = qg[:, iq * qc:(iq + 1) * qc]             # (B,Cq,Hkv,rep,D)
            qlo = iq * qc + offs
            ks, vs = kp[:, qlo:qlo + wlen], vp[:, qlo:qlo + wlen]
            s = torch.einsum("bqhrd,bkhd->bhrqk", qi, ks) * sc
            qpos = qlo + torch.arange(qc, device=dev)[:, None]
            kpos = qlo - window + torch.arange(wlen, device=dev)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window) & (kpos >= 0)
            p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
            outs.append(torch.einsum("bhrqk,bkhd->bqhrd", p, vs))
    else:
        nk = max(sk // KV_CHUNK, 1)
        ck = sk // nk
        ones = torch.ones(ck, device=dev)
        for iq in range(sq // qc):
            qi = qg[:, iq * qc:(iq + 1) * qc]
            qpos = iq * qc + offs + torch.arange(qc, device=dev)[:, None]
            m = torch.full((b, hkv, rep, qc), NEG_INF, device=dev)
            l = torch.zeros((b, hkv, rep, qc), device=dev)
            acc = torch.zeros((b, hkv, rep, qc, d), device=dev)
            for jk in range(nk):
                ks = kf[:, jk * ck:(jk + 1) * ck]
                vs = vf[:, jk * ck:(jk + 1) * ck]
                s = torch.einsum("bqhrd,bkhd->bhrqk", qi, ks) * sc
                if causal:
                    kpos = jk * ck + torch.arange(ck, device=dev)[None, :]
                    s = s.masked_fill(kpos > qpos, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                # rowsum(p) in matmul form (p @ 1), the paper's P-matrix
                # reduction, as in the reference
                l = corr * l + p @ ones
                acc = corr[..., None] * acc + torch.einsum(
                    "bhrqk,bkhd->bhrqd", p, vs)
                m = m_new
            l = torch.where(l > 0, l, torch.ones_like(l))
            o = acc / l[..., None]                        # (B,Hkv,rep,Cq,D)
            outs.append(o.permute(0, 3, 1, 2, 4))         # (B,Cq,Hkv,rep,D)
    return torch.cat(outs, dim=1).reshape(b, sq, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len, *,
                     window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """``q (B, T, Hq, D)`` against ``k_cache``/``v_cache`` ``(B, S, Hkv,
    D)``: query token t of slot b sees the cache rows below
    ``cur_len[b, t]`` (and, with a window, not below ``cur_len - window``).
    ``cur_len`` is an int, a ``(B,)`` or a ``(B, T)`` tensor."""
    b, s, hkv, d = k_cache.shape
    tq, hq = q.shape[1], q.shape[2]
    rep = hq // hkv
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, tq, hkv, rep, d).float()
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_cache.float()) * sc
    if isinstance(cur_len, int):   # a fill on the device: no host copy,
        # which would wait for the stream at every layer of every step
        cl = torch.full((), cur_len, dtype=torch.int64, device=q.device)
    else:
        cl = torch.as_tensor(cur_len, dtype=torch.int64, device=q.device)
    if cl.ndim == 0:
        cl = cl[None, None]
    elif cl.ndim == 1:
        cl = cl[:, None]
    lens = cl.expand(b, tq)[..., None]                    # (B, T, 1)
    kpos = torch.arange(s, device=q.device)[None, None, :]
    valid = kpos < lens                                   # (B, T, S)
    if window is not None:
        valid = valid & (kpos >= lens - window)
    logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", p, v_cache.float())
    return o.reshape(b, tq, hq, d).to(q.dtype)

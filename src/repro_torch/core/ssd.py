"""Chunked SSD (Mamba-2) in plain torch: the paper's weighted tile scan.

Per chunk of Q tokens:

  intra   Y1 = ((C B^T) o M) (dt o X)      M = exp(segsum(lambda))
  state   S  = (B o w)^T (dt o X)          w = remaining-chunk decay
  carry   H_k = exp(sum lambda) H_{k-1} + S_k
  inter   Y2 = (C o exp(Lambda)) H_{k-1}

The inter-chunk carry is a sequential loop over chunks. The hand-written
kernel is ``csrc/ssd_scan.cu``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tiles import segsum

CHUNK = 128


def ssd_chunked(
    x: torch.Tensor,    # (B, L, H, P)
    dt: torch.Tensor,   # (B, L, H)   positive
    a: torch.Tensor,    # (H,)        negative
    b: torch.Tensor,    # (B, L, G, N)
    c: torch.Tensor,    # (B, L, G, N)
    *,
    chunk: int = CHUNK,
    matmul_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,L,H,P) in x.dtype, final_state (B,H,P,N) f32).

    ``matmul_dtype`` rounds the operands of the large products to that type
    (decay masks and accumulation stay f32), as the reference does with
    ``preferred_element_type``; None keeps full f32.
    """
    bsz, seqlen, nheads, hdim = x.shape
    ngroups, nstate = b.shape[2], b.shape[3]
    rem = (-seqlen) % chunk
    if rem:
        # zero-pad: decay exp(0)=1 and input 0 leave the carried state exact
        def padt(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, rem))

        y, h_last = ssd_chunked(padt(x), padt(dt), a, padt(b), padt(c),
                                chunk=chunk, matmul_dtype=matmul_dtype)
        return y[:, :seqlen], h_last
    nchunks = seqlen // chunk
    rep = nheads // ngroups

    def mm(t):
        return t if matmul_dtype is None else t.to(matmul_dtype).float()

    xf = x.float()
    dtf = dt.float()
    lam = dtf * a.float()                                 # (B, L, H)
    xdt = (xf * dtf[..., None]).reshape(bsz, nchunks, chunk, nheads, hdim)
    lam = lam.reshape(bsz, nchunks, chunk, nheads)
    bg = b.float().reshape(bsz, nchunks, chunk, ngroups, nstate)
    cg = c.float().reshape(bsz, nchunks, chunk, ngroups, nstate)

    lam_t = lam.movedim(-1, -2)                           # (B, k, H, Q)
    m = torch.exp(segsum(lam_t))                          # (B, k, H, Q, Q)
    cum = torch.cumsum(lam_t, dim=-1)                     # (B, k, H, Q)
    total = cum[..., -1]                                  # (B, k, H)

    cb = torch.einsum("bkqgn,bksgn->bkgqs", mm(cg), mm(bg))
    cb = torch.repeat_interleave(cb, rep, dim=2)          # (B, k, H, Q, Q)
    y_intra = torch.einsum("bkhqs,bkshp->bkqhp", mm(cb * m), mm(xdt))

    w = torch.exp(total[..., None] - cum)                 # (B, k, H, Q)
    bw = torch.repeat_interleave(bg, rep, dim=3)          # (B, k, Q, H, N)
    s_chunk = torch.einsum("bkqhn,bkqhp->bkhpn",
                           mm(bw * w.movedim(-1, -2)[..., None]), mm(xdt))

    h = torch.zeros((bsz, nheads, hdim, nstate), dtype=torch.float32,
                    device=x.device)
    h_prev = []
    for k in range(nchunks):                              # states entering
        h_prev.append(h)
        h = torch.exp(total[:, k])[..., None, None] * h + s_chunk[:, k]
    h_prev = torch.stack(h_prev, dim=1)                   # (B, k, H, P, N)

    cdec = (torch.repeat_interleave(cg, rep, dim=3)
            * torch.exp(cum.movedim(-1, -2))[..., None])  # (B, k, Q, H, N)
    y_inter = torch.einsum("bkqhn,bkhpn->bkqhp", mm(cdec), mm(h_prev))
    y = (y_intra + y_inter).reshape(bsz, seqlen, nheads, hdim)
    return y.to(x.dtype), h


def ssd_decode_step(
    state: torch.Tensor,   # (B, H, P, N) f32
    x_t: torch.Tensor,     # (B, H, P)
    dt_t: torch.Tensor,    # (B, H)
    a: torch.Tensor,       # (H,)
    b_t: torch.Tensor,     # (B, G, N)
    c_t: torch.Tensor,     # (B, G, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: h <- exp(a dt) h + dt x b^T;  y = h c.

    The groups are repeated over their heads with ``expand``, never a
    ``repeat_interleave`` that may size its output on the host: the block
    step that loops over this is captured in a CUDA graph."""
    bsz, nheads = state.shape[:2]
    ngroups, nstate = b_t.shape[1:]

    def per_head(t):                                          # (B, H, N)
        return t.float()[:, :, None].expand(
            bsz, ngroups, nheads // ngroups, nstate).reshape(
            bsz, nheads, nstate)

    dec = torch.exp(dt_t.float() * a.float())
    bf, cf = per_head(b_t), per_head(c_t)
    xdt = x_t.float() * dt_t.float()[..., None]
    state = dec[..., None, None] * state + xdt[..., None] * bf[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, cf)
    return y.to(x_t.dtype), state

"""Plain PyTorch reference of the Mamba-2 LM.

The plain reference beside ``mamba2-1.3b.json``. It follows the published
equations (Mamba-2, arXiv:2405.21060: the SSD layer), in float32 with TF32
off, with no kernel, cache or batching of the program: the conv is four
shifted products, the SSD the chunked form of the Mamba-2 paper's minimal
listing. The head is the embedding where the configuration ties them. It
reads its sizes from the configuration file and imports only ``torch``.

``quant="fp8"`` computes the large products with their operands rounded to
float8 e4m3 under a per-tensor scale: the control, one precision below the
bfloat16 the configurations serve and compute in.

Parameters are a tree of stacked ``(layers, ...)`` leaves (the layout of
:func:`param_specs`); each layer's slice is cast to float32 when it is
used, so a served model's bfloat16 weights are read as they are.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

SSD_CHUNK = 64
FP8_MAX = 448.0                 # the largest float8 e4m3 value


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    init: str                   # normal | fan_in | ones | zeros | dt_bias | a_log
    f32: bool = False           # float32 whatever the model's dtype


def reference_precision() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sizes(cfg: dict) -> dict:
    di = cfg["expand"] * cfg["d_model"]
    heads = di // cfg["ssm_head_dim"]
    conv = di + 2 * cfg["ssm_groups"] * cfg["ssm_state"]
    return {"di": di, "heads": heads, "conv": conv,
            "in": 2 * di + 2 * cfg["ssm_groups"] * cfg["ssm_state"] + heads}


def param_specs(cfg: dict) -> dict:
    """The parameter tree, stacked over the layers."""
    d, v, n = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    s = _sizes(cfg)
    tree = {
        "embed": Leaf((v, d), "normal"),
        "final_norm": Leaf((d,), "ones"),
        "blocks": {
            "ln": Leaf((n, d), "ones"),
            "mamba": {
                "in_proj": Leaf((n, d, s["in"]), "fan_in"),
                "conv_w": Leaf((n, cfg["conv_kernel"], s["conv"]), "fan_in"),
                "conv_b": Leaf((n, s["conv"]), "zeros"),
                "dt_bias": Leaf((n, s["heads"]), "dt_bias", True),
                "a_log": Leaf((n, s["heads"]), "a_log", True),
                "d_skip": Leaf((n, s["heads"]), "ones", True),
                "norm_w": Leaf((n, s["di"]), "ones"),
                "out_proj": Leaf((n, s["di"], d), "fan_in"),
            },
        },
    }
    if not cfg["tie_embeddings"]:
        tree["head"] = Leaf((v, d), "normal")
    return tree


# ---------------------------------------------------------------------------
# building blocks


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes straight through the rounding."""
    d = t.detach()
    scale = d.abs().amax().clamp_min(1e-12) / FP8_MAX
    rounded = (d / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (rounded - d)


def mm(a: torch.Tensor, b: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def segsum(a: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = a[..., j+1] + ... + a[..., i]`` below the
    diagonal, ``-inf`` above it, summed term by term (no difference of two
    long cumulative sums)."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)                   # (..., T, T)
    strict = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device),
                        -1)
    x = torch.cumsum(x.masked_fill(~strict, 0.0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd(x, log_a, b, c, chunk: int = SSD_CHUNK):
    """The SSD recurrence ``h_t = exp(log_a_t) h_{t-1} + x_t b_t^T``, ``y_t
    = h_t c_t``, from a zero state, in the chunked form of the Mamba-2
    paper. x (B, L, H, P) (already times dt), log_a (B, L, H), b and c (B,
    L, H, N) -> y (B, L, H, P)."""
    bsz, length = x.shape[:2]
    pad = (-length) % chunk
    if pad:
        x, log_a, b, c = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                          for t in (x, log_a, b, c))
    nc = x.shape[1] // chunk

    def chunks(t):
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    x, b, c = chunks(x), chunks(b), chunks(c)
    a = chunks(log_a).permute(0, 3, 1, 2)                  # (B, H, C, Q)
    a_cum = torch.cumsum(a, dim=-1)
    decay = torch.exp(segsum(a))                           # (B, H, C, Q, Q)
    scores = torch.einsum("bclhn,bcshn->bhcls", c, b) * decay
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, x)
    to_end = torch.exp(a_cum[..., -1:] - a_cum)            # (B, H, C, Q)
    states = torch.einsum("bcshn,bhcs,bcshp->bchpn", b, to_end, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # (B,H,C+1,C+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", c, states,
                         torch.exp(a_cum))
    y = (y_diag + y_off).reshape(bsz, nc * chunk, *x.shape[3:])
    return y[:, :length]


def mamba(x, p, cfg: dict, quant):
    """One Mamba-2 mixer over the normed residual x (B, S, d)."""
    s = _sizes(cfg)
    di, hh, hp = s["di"], s["heads"], cfg["ssm_head_dim"]
    g, ns, k = cfg["ssm_groups"], cfg["ssm_state"], cfg["conv_kernel"]
    bsz, length = x.shape[:2]
    zxbcdt = mm(x, p["in_proj"].float(), quant)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * ns]
    dt_raw = zxbcdt[..., 2 * di + 2 * g * ns:]
    w = p["conv_w"].float()                                # (K, C)
    xp = F.pad(xbc, (0, 0, k - 1, 0))                      # (B, S+K-1, C)
    conv = sum(w[j] * xp[:, j:j + length] for j in range(k))
    xbc = F.silu(conv + p["conv_b"].float())
    xs = xbc[..., :di].reshape(bsz, length, hh, hp)

    def per_head(t):
        t = t.reshape(bsz, length, g, 1, ns).expand(bsz, length, g,
                                                    hh // g, ns)
        return t.reshape(bsz, length, hh, ns)

    bm = per_head(xbc[..., di:di + g * ns])
    cm = per_head(xbc[..., di + g * ns:])
    dt = F.softplus(dt_raw + p["dt_bias"].float())         # (B, S, H)
    a = -torch.exp(p["a_log"].float())
    y = ssd(xs * dt[..., None], dt * a, bm, cm)
    y = y + p["d_skip"].float()[:, None] * xs
    y = y.reshape(bsz, length, di) * F.silu(z)
    y = rmsnorm(y, p["norm_w"], cfg["norm_eps"])
    return mm(y, p["out_proj"].float(), quant)


def _layer(params, i: int) -> dict:
    blk = params["blocks"]
    return {"ln": blk["ln"][i], "mamba": {k: t[i] for k, t in
                                          blk["mamba"].items()}}


def hidden(params, cfg: dict, tokens, *, quant=None, remat: bool = False):
    """The final normed hidden states (B, S, d) of ``tokens`` (B, S)."""
    h = params["embed"][tokens].float()

    def layer(h, i):
        lp = _layer(params, i)
        return h + mamba(rmsnorm(h, lp["ln"], cfg["norm_eps"]), lp["mamba"],
                         cfg, quant)

    for i in range(cfg["n_layers"]):
        if remat:
            h = checkpoint.checkpoint(layer, h, i, use_reentrant=False)
        else:
            h = layer(h, i)
    return rmsnorm(h, params["final_norm"], cfg["norm_eps"])


def logits(params, cfg: dict, h, *, quant=None):
    head = params["embed"] if cfg["tie_embeddings"] else params["head"]
    return mm(h, head.float().T, quant)


@torch.no_grad()
def served_logits(params, cfg: dict, tokens: torch.Tensor, start: int, *,
                  quant=None) -> torch.Tensor:
    """The logits (S - start, vocab) at positions [start, S) of one
    sequence ``tokens`` (S,), each the prediction of the next token."""
    h = hidden(params, cfg, tokens[None], quant=quant)[0, start:]
    return logits(params, cfg, h, quant=quant)


def loss(params, cfg: dict, tokens, labels, *, quant=None):
    """Mean token cross-entropy, the layers recomputed in backward."""
    h = hidden(params, cfg, tokens, quant=quant, remat=True)
    lg = logits(params, cfg, h, quant=quant)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.reshape(-1).long())


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr_ratio * peak_lr`` at ``decay_steps``."""
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["decay_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["peak_lr"] * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"])
                             * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(params: list, grads: list, m: list, v: list, step: int,
          opt: dict) -> tuple[list, list]:
    """One AdamW step in place over lists of leaves (step counts from 1),
    the gradients clipped to a global norm of ``clip_norm`` first. Returns
    (the gradients as the update took them, the global norm)."""
    gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
    scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    taken = []
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        taken.append(g)
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).add_(g * g, alpha=1 - b2)
        upd = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
    return taken, gnorm

"""Operations and bytes of the Mamba-2 LM, counted from its sizes (the
configuration file's), the same whatever kernels compute them.

Model FLOPs count two a multiply-add: the products with the weight
matrices (``in_proj``, ``out_proj``, the depthwise conv, the head) and the
SSM's recurrent work a token (the state update ``x b^T`` and its read ``h
c``: 4 H P N a layer). The embedding is a gather and the norms are not
counted.
"""
from __future__ import annotations

from perfbench.lib import frozen


def _di(cfg: dict) -> int:
    return cfg["expand"] * cfg["d_model"]


def _heads(cfg: dict) -> int:
    return _di(cfg) // cfg["ssm_head_dim"]


def _conv(cfg: dict) -> int:
    return _di(cfg) + 2 * cfg["ssm_groups"] * cfg["ssm_state"]


def mamba_flops_token(cfg: dict) -> int:
    """One token through every Mamba layer."""
    d, di = cfg["d_model"], _di(cfg)
    width_in = 2 * di + 2 * cfg["ssm_groups"] * cfg["ssm_state"] + _heads(cfg)
    mm = d * width_in + di * d + cfg["conv_kernel"] * _conv(cfg)
    ssm = 2 * _heads(cfg) * cfg["ssm_head_dim"] * cfg["ssm_state"]
    return cfg["n_layers"] * (2 * mm + 2 * ssm)


def head_flops(cfg: dict) -> int:
    """The head over one row."""
    return 2 * cfg["vocab"] * cfg["d_model"]


def train_flops(cfg: dict, batch: int, seq: int) -> int:
    """Forward and backward of one step (three times the forward), the
    head over every row."""
    return 3 * batch * seq * (mamba_flops_token(cfg) + head_flops(cfg))


def rmsnorm_calls(cfg: dict, slots: int, t_len: int) -> list:
    """(rows, width) of each RMSNorm of a block step of ``slots`` x
    ``t_len`` tokens: each Mamba layer's outer norm and gated inner norm,
    and the final norm of each slot's last row."""
    d, rows = cfg["d_model"], slots * t_len
    return [(rows, d), (rows, _di(cfg))] * cfg["n_layers"] + [(slots, d)]


def rmsnorm_bytes(rows: int, width: int, itemsize: int) -> int:
    """Input read once, the weight read once, output written once."""
    return (2 * rows * width + width) * itemsize


def ssd_call(cfg: dict, batch: int, seq: int, itemsize: int) -> tuple:
    """(FLOPs, bytes) of one SSD kernel call over a layer's (batch, seq):
    x, b, c in the model's dtype, dt and the decay (dt a) in float32 read
    once; y in the model's dtype and the final state in float32 written
    once."""
    h, p, n, g = (_heads(cfg), cfg["ssm_head_dim"], cfg["ssm_state"],
                  cfg["ssm_groups"])
    rows = batch * seq
    nbytes = (rows * h * p * itemsize * 2 + rows * 2 * g * n * itemsize
              + rows * h * 4 * 2 + batch * h * p * n * 4)
    return frozen.ssd_flops(batch, seq, h, p, n), nbytes

"""Shared shape-cell definitions and the stand-ins of a cell's inputs.

Counterpart of ``repro.configs.common``. Each arch module exposes:
  FULL   : the published config
  SMOKE  : a reduced same-family config for CPU tests
  SHAPES : the applicable shape cells (SKIPS: the rest, with reasons)

``make_cell(cfg, shape)`` returns ``meta`` tensors (shape and dtype, no
storage) for every model input of that cell, where the reference has
``ShapeDtypeStruct``s, plus the logical axis names the dry run shards them
by.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.layers import ModelConfig

# (seq_len, global_batch, kind)
SHAPE_TABLE = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# smoke-test shape (CPU, reduced configs)
SMOKE_SEQ = 128
SMOKE_BATCH = 2


@dataclasses.dataclass(frozen=True)
class Cell:
    shape: str
    seq: int
    batch: int
    kind: str
    batch_specs: dict[str, Any]        # name -> meta tensor
    batch_logical: dict[str, tuple]    # name -> logical axes
    cache_batch: int = 0               # decode cells: cache batch size
    cache_len: int = 0


def sds(shape, dtype=torch.int32) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype``: a ``meta`` tensor."""
    return torch.empty(shape, dtype=dtype, device="meta")


def lm_cell(cfg: ModelConfig, shape: str) -> Cell:
    seq, batch, kind = SHAPE_TABLE[shape]
    stub = cfg.stub_tokens
    if kind in ("train", "prefill"):
        s_text = seq - stub
        specs = {"tokens": sds((batch, s_text))}
        logical = {"tokens": ("batch", None)}
        if kind == "train":
            specs["labels"] = sds((batch, s_text))
            logical["labels"] = ("batch", None)
        if stub:
            specs["stub"] = sds((batch, stub, cfg.stub_dim), torch.bfloat16)
            logical["stub"] = ("batch", None, None)
        return Cell(shape, seq, batch, kind, specs, logical)
    # decode: one new token against a cache of length seq
    specs = {"tokens": sds((batch, 1))}
    logical = {"tokens": ("batch", None)}
    return Cell(shape, seq, batch, kind, specs, logical,
                cache_batch=batch, cache_len=seq)


def encdec_cell(cfg: ModelConfig, shape: str) -> Cell:
    seq, batch, kind = SHAPE_TABLE[shape]
    half = seq // 2
    if kind in ("train", "prefill"):
        specs = {
            "frames": sds((batch, half, cfg.d_model), torch.bfloat16),
            "tokens": sds((batch, half)),
        }
        logical = {"frames": ("batch", None, None), "tokens": ("batch", None)}
        if kind == "train":
            specs["labels"] = sds((batch, half))
            logical["labels"] = ("batch", None)
        return Cell(shape, seq, batch, kind, specs, logical)
    specs = {"tokens": sds((batch, 1))}
    logical = {"tokens": ("batch", None)}
    return Cell(shape, seq, batch, kind, specs, logical,
                cache_batch=batch, cache_len=seq)


def make_cell(cfg: ModelConfig, shape: str) -> Cell:
    if cfg.family == "encdec":
        return encdec_cell(cfg, shape)
    return lm_cell(cfg, shape)


def smoke_batch(cfg: ModelConfig, kind: str = "train",
                gen: torch.Generator | None = None) -> dict:
    """Concrete small inputs for the reduced config (CPU tests), drawn from
    ``gen`` (a CPU generator seeded 0 when None): the reference's keys,
    shapes, dtypes and ranges (tokens in ``[0, vocab)``, normal stub or
    frames in the model's dtype); its values are torch's, not jax's."""
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    dev = gen.device
    b, s = SMOKE_BATCH, SMOKE_SEQ
    stub = cfg.stub_tokens

    def ids(n):
        return torch.randint(0, cfg.vocab, (b, n), generator=gen,
                             device=dev, dtype=torch.int32)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float32).to(cfg.dtype)

    if cfg.family == "encdec":
        return {"frames": normal(b, s, cfg.d_model), "tokens": ids(s),
                "labels": ids(s)}
    out = {"tokens": ids(s - stub), "labels": ids(s - stub)}
    if stub:
        out["stub"] = normal(b, stub, cfg.stub_dim)
    return out

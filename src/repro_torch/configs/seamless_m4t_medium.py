"""seamless-m4t-medium [audio] — enc-dec transformer backbone, 12L encoder +
12L decoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206. The speech
frontend is a stub: the batch carries precomputed frame embeddings
(B, S_enc, d_model). [arXiv:2308.11596; hf]

The same numbers as ``repro.configs.seamless_m4t_medium``: 977.8 M
parameters, 1.96 GB in bf16, so the whole model is served and trained on
one card.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, vocab=256206,
    n_heads=16, n_kv_heads=16, d_ff=4096, head_dim=64,
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=4, d_ff=128, head_dim=16,
    dtype=torch.float32, remat_policy="off",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIPS = {"long_500k": "full-attention enc-dec; 500k audio decode requires "
                      "sub-quadratic attention — skipped per the brief"}
OPT_STATE_DTYPE = "float32"

"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) head_dim=120
d_ff=10240 vocab=32000, llama+mistral mix with sliding-window attention
(window 4096). [arXiv:2401.16818; unverified]

The same numbers as ``repro.configs.h2o_danube_3_4b``: 3.96 B parameters,
7.9 GB in bf16. Its prefill runs flash attention at head dim 120 with the
window; a prompt past the window leaves a ring of 4096 rows for decode.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, vocab=32000,
    n_heads=32, n_kv_heads=8, d_ff=10240, head_dim=120,
    swa_window=4096, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="danube3-smoke", family="dense",
    n_layers=2, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
    swa_window=32, dtype=torch.float32, remat_policy="off",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIPS: dict = {}
OPT_STATE_DTYPE = "float32"

"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch. [arXiv:2401.02954; hf]

The same numbers as ``repro.configs.deepseek_67b``. Its 67.4 B parameters
(134.9 GB in bf16) do not fit one card: ``chip_smoke.py`` serves it with
its depth cut.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, vocab=102400,
    n_heads=64, n_kv_heads=8, d_ff=22016, head_dim=128,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="dense",
    n_layers=2, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
    dtype=torch.float32, remat_policy="off",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIPS = {"long_500k": "pure full attention (GQA); skipped per the brief"}
OPT_STATE_DTYPE = "bfloat16"

"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. [arXiv:2403.17297; hf]

The same numbers as ``repro.configs.internlm2_20b``: 19.86 B parameters,
39.7 GB in bf16, the largest model one card holds whole.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, vocab=92544,
    n_heads=48, n_kv_heads=8, d_ff=16384, head_dim=128,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internlm2-smoke", family="dense",
    n_layers=2, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
    dtype=torch.float32, remat_policy="off",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIPS = {"long_500k": "pure full attention (GQA); skipped per the brief"}
OPT_STATE_DTYPE = "float32"

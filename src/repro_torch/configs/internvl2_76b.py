"""internvl2-76b [vlm] — the InternViT frontend as a stub (precomputed
patch embeddings, 256 tokens x 3200 wide, projected to d_model) before an
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 LLaMA-style
backbone. [arXiv:2404.16821; unverified]

The same numbers as ``repro.configs.internvl2_76b``. Its 70.6 B parameters
do not fit one card: ``chip_smoke.py`` runs it with its depth cut.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, vocab=128256,
    n_heads=64, n_kv_heads=8, d_ff=28672, head_dim=128,
    stub_tokens=256, stub_dim=3200,
    rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
    stub_tokens=8, stub_dim=32,
    dtype=torch.float32, remat_policy="off",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIPS = {"long_500k": "pure full attention (GQA); skipped per the brief"}
OPT_STATE_DTYPE = "bfloat16"

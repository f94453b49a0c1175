"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]

The same numbers as ``repro.configs.mamba2_1_3b``: this architecture is the
paper's technique at model scale, the SSD layer being the decay-weighted
generalisation of the matmul-form scan.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_groups=1, expand=2, conv_kernel=4,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=3, d_model=64, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_groups=1, expand=2, conv_kernel=4,
    dtype=torch.float32,
)

"""zamba2-2.7b [hybrid] — a Mamba-2 backbone with one shared attention block
applied every 6 layers over concat(h, embeddings). 54L d_model=2560 32H
(kv=32) shared-MLP d_ff=10240 vocab=32000 ssm_state=64.
[arXiv:2411.15242; hf]

The same numbers as ``repro.configs.zamba2_2_7b``: 2.44 B parameters, 4.9 GB
in bf16, so the whole model fits one card.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, vocab=32000,
    n_heads=32, n_kv_heads=32, d_ff=10240,
    ssm_state=64, ssm_head_dim=64, ssm_groups=1, expand=2, conv_kernel=4,
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=4, d_ff=128,
    ssm_state=16, ssm_head_dim=16, ssm_groups=1, expand=2, conv_kernel=4,
    shared_attn_every=2, dtype=torch.float32, remat_policy="off",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SKIPS: dict = {}
OPT_STATE_DTYPE = "float32"

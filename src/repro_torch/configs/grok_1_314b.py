"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) head_dim=128,
8 experts top-2 with expert d_ff=32768, vocab=131072, untied.
[hf:xai-org/grok-1; unverified]

The same numbers as ``repro.configs.grok_1_314b``: few wide experts, where
qwen3-moe has many narrow ones.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, vocab=131072,
    n_heads=48, n_kv_heads=8, head_dim=128,
    n_experts=8, experts_per_tok=2, moe_d_ff=32768,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="grok-1-smoke", family="moe",
    n_layers=2, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=2, head_dim=16,
    n_experts=4, experts_per_tok=2, moe_d_ff=128,
    dtype=torch.float32, remat_policy="off",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIPS = {"long_500k": "pure full attention (GQA); skipped per the brief"}
OPT_STATE_DTYPE = "bfloat16"
# the reference trains it with Adafactor: a factored second moment
# and bf16 momentum in place of AdamW's two full moments
OPTIMIZER = "adafactor"

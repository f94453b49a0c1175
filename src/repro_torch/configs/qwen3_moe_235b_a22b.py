"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) head_dim=128,
128 experts top-8 with expert d_ff=1536, vocab=151936, untied.
[hf:Qwen/Qwen3-30B-A3B; hf]

The same numbers as ``repro.configs.qwen3_moe_235b_a22b``: the routing's
per-expert counts and capacity offsets are the paper's ragged reduce and
exclusive scan, once per layer.
"""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, vocab=151936,
    n_heads=64, n_kv_heads=4, head_dim=128,
    n_experts=128, experts_per_tok=8, moe_d_ff=1536,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, vocab=256,
    n_heads=4, n_kv_heads=2, head_dim=16,
    n_experts=8, experts_per_tok=2, moe_d_ff=96,
    dtype=torch.float32, remat_policy="off",
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SKIPS = {"long_500k": "pure full attention (GQA); 500k decode requires "
                      "sub-quadratic attention per the brief — skipped"}
OPT_STATE_DTYPE = "bfloat16"
